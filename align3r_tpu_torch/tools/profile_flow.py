"""Profile the port's flow path on one GPU: a SEA-RAFT chunk and the flow
term of the solve.

    python -m align3r_tpu_torch.tools.profile_flow [--out build/flow_profile.json]

- RAFT: spring-M at full width from seeded random weights (init_raft_), one
  chunk of compute_raft_flows at 288x512 (12 edges in both directions, a
  batch of 24 pairs), 20 refinement steps, fp32 without TF32. After one warm
  call it times 3 by CUDA events, then profiles one.
- Flow term: flow_term (the ego-flow smooth-L1 of alignment/flow.py) forward
  and backward at the chip_smoke flow phase's shapes (12 frames, 70 edges,
  288x512), on random parameters, flows and masks. Timed over 5 calls after
  a warm one, then profiled over one.
For each it reports ms per call, the device's busy share inside the
profiled window, kernel time by kind and the top kernels. It prints the
card's name and power limit, one summary line per part, and writes the full
tables as JSON to --out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from align3r_tpu_torch.tools.profile_train import kind

H, W, FRAMES = 288, 512, 12


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile(fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] += e.device_time / 1e3
            count[e.name] += 1
    by_kind = defaultdict(float)
    for name, t in by_name.items():
        by_kind[kind(name)] += t
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {"window_ms": window, "device_ms": busy, "device_busy_share": busy / window,
            "kernels": sum(count.values()),
            "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": k[:120], "ms": v, "count": count[k]} for k, v in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/flow_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    from align3r_tpu_torch.alignment import scene as sc
    from align3r_tpu_torch.alignment.flow import flow_term
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.models.raft import RAFT2, SPRING_M, init_raft_
    from align3r_tpu_torch.pipeline import compute_raft_flows

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    r = np.random.default_rng(0)
    res = {"card": card}

    raft = init_raft_(RAFT2(SPRING_M), seed=0).to(dev)
    imgs = r.uniform(0, 1, (FRAMES, H, W, 3)).astype(np.float32)
    edges = [(i, (i + 1) % FRAMES) for i in range(12)]
    run = lambda: compute_raft_flows(raft, imgs, edges, chunk=12, iters=20)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    ms = cuda_ms(run, 3)
    res["raft"] = {"batch_pairs": 2 * len(edges), "iters": 20, "first_call_ms": first,
                   "ms_per_chunk": ms, "ms_per_directed_pair": ms / (2 * len(edges)),
                   **profile(run)}

    pairs = make_pairs(FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    E = len(pairs)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    out = {"view1": {"idx": np.array([p[0] for p in pairs])},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": t(r.normal(0, 1, (E, H, W, 3)) + [0, 0, 4]),
                     "conf": t(1 + r.uniform(size=(E, H, W)))},
           "pred2": {"pts3d_in_other_view": t(r.normal(0, 1, (E, H, W, 3)) + [0, 0, 4]),
                     "conf": t(1 + r.uniform(size=(E, H, W)))}}
    cfg, data, params = sc.build_scene(out, dict(shared_focal=True, flow_loss_weight=0.01))
    data = dataclasses.replace(
        data, flow_ij=t(r.normal(0, 2, (E, H, W, 2))), flow_ji=t(r.normal(0, 2, (E, H, W, 2))),
        dynamic_masks=t(r.uniform(size=(FRAMES, H, W)) > 0.7))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}

    def term():
        torch.autograd.grad(flow_term(leaves, data, cfg), list(leaves.values()),
                            allow_unused=True)

    ms = cuda_ms(term, 5)
    res["flow_term"] = {"edges": E, "frames": FRAMES, "ms_fwd_bwd": ms, **profile(term),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    for part in ("raft", "flow_term"):
        print(part + ": " + json.dumps({k: v for k, v in res[part].items()
                                         if k != "top_kernels"}), flush=True)
        for k in res[part]["top_kernels"][:10]:
            print(f"  {k['ms']:9.3f} ms  x{k['count']:6d}  {k['name']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
