"""Profile the port's fine-tuning micro-step on one GPU.

    python -m align3r_tpu_torch.tools.profile_train [--out build/train_profile.json]

The step of ``chip_smoke.py``'s train phase, without the data loader: ViT-L
(``Align3RConfig(img_size=(288, 512))``) from seeded random weights (final
head convs scaled by 0.01), frozen encoder stored in bf16, 2 pairs of random
288x512 inputs per micro-step, remat "full", fp32 heads, accum_iter 4. After
4 warm micro-steps it times 4 more (one applied update) and reports:
- ms per micro-step (host clock around synchronised work), and its split by
  CUDA events into forward (network + loss), backward, and the optimizer
  call (accumulation, and AdamW on every 4th);
- the device's busy share and its kernel time by kernel name and by kind,
  from torch.profiler over the same 4 micro-steps.
It prints the card's name and power limit, one summary line, and writes the
full table as JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

# first match wins: cuDNN's FFT convolutions run complex ("cf32") GEMMs
KINDS = (("K6 small_attention", ("small_attention",)),
         ("convolution", ("conv", "implicit", "winograd", "fft", "cf32", "cudnn",
                          "dgrad", "wgrad")),
         ("matmul", ("gemm", "cutlass", "xmma", "sm90", "sm80", "cublas")),
         ("softmax/reduce", ("softmax", "reduce", "norm")),
         ("copy/cat", ("copy", "cat", "transpose", "fill")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(s in low for s in keys):
            return k
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/train_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.training import step as S

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    H, W, B = 288, 512, 2
    with torch.device(dev):
        model = init_align3r_(Align3R(Align3RConfig(img_size=(H, W))), seed=0)
    with torch.no_grad():
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    S.cast_frozen_kernels(model)
    opt = S.make_optimizer(model, S.make_lr_schedule(5e-5, 1e-6, 0, 10, 100),
                           accum_iter=4)
    r = np.random.default_rng(0)

    def view():
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        pose = np.broadcast_to(np.eye(4), (B, 4, 4)).copy()
        return {"img": t(r.uniform(-1, 1, (B, H, W, 3))),
                "pred_depth": t(r.uniform(0, 1, (B, H, W, 3))),
                "pts3d": t(r.standard_normal((B, H, W, 3)) + [0, 0, 3]),
                "camera_pose": t(pose),
                "valid_mask": torch.from_numpy(r.uniform(0, 1, (B, H, W)) > 0.05).to(dev)}
    batch = {"view1": view(), "view2": view()}
    ev = lambda: torch.cuda.Event(enable_timing=True)
    split = defaultdict(float)

    def micro_step(record: bool):
        e = [ev() for _ in range(4)]
        e[0].record()
        loss, _ = S.loss_fn(model, batch, remat="full")
        e[1].record()
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(opt.params, grads)]
        torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                              for g in grads]))
        e[2].record()
        opt.update(grads)
        e[3].record()
        if record:
            torch.cuda.synchronize()
            for name, a, b in (("forward", 0, 1), ("backward", 1, 2), ("optimizer", 2, 3)):
                split[name] += e[a].elapsed_time(e[b])

    for _ in range(4):
        micro_step(False)
    torch.cuda.synchronize()
    n = 4
    t0 = time.perf_counter()
    for _ in range(n):
        micro_step(True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n

    sa.small_attention.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(n):
            micro_step(False)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e3
    k6 = sa.small_attention.launches / n
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] += e.device_time / 1e3
            count[e.name] += 1
    by_kind = defaultdict(float)
    for name, t in by_name.items():
        by_kind[kind(name)] += t / n
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    res = {"card": card, "pairs": B, "ms_per_micro_step": ms,
           "split_ms": {k: v / n for k, v in split.items()},
           "device_busy_share": busy / window, "kernels_per_micro_step":
               sum(count.values()) / n, "k6_launches_per_micro_step": k6,
           "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"name": k[:120], "ms_per_micro_step": v / n,
                            "count": count[k] / n} for k, v in top],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "top_kernels"}), flush=True)
    for t in res["top_kernels"][:12]:
        print(f"  {t['ms_per_micro_step']:8.3f} ms  x{t['count']:7.1f}  {t['name']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
