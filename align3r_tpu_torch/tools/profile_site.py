"""Profile K1's and K2's sites on one GPU, by launch, and the serving engine.

    python -m align3r_tpu_torch.tools.profile_site [--out build/site_profile.json]
        [--engine] [--ln]

Runs K1 (``ops.fused_site.attention_site``) at the serving path's three
shapes, from seeded random bf16 inputs and weights at 512x288 (576 tokens):
the encoder's self site (1 stream x 16 images, C = 1024, 16 heads) and the
decoder's self and cross sites (2 streams x 32 pairs, C = 768, 12 heads),
each with LayerNorm and the residual, as ``chip_smoke.py``'s kernels phase
does; and K2 (``mlp_site``) at the encoder's (C = 1024, F = 4096) and the
decoder's (2 streams, C = 768, F = 3072) shapes. Per site it reports:
- the site's device time from a CUDA graph of 10 calls (CUDA events);
- its split by launch from torch.profiler over 10 eager calls, in device ms
  per site: for K1 LayerNorm, the q/k GEMMs (bias + RoPE epilogue), the v
  GEMM (bias), attention, the out-projection GEMM (bias + residual); for K2
  LayerNorm, fc1 (bias + GELU) and fc2 (bias + residual); and anything else
  (dtype conversions of the biases). The GEMMs are told apart by their
  epilogue in the kernel's name, in the WMMA core's (``gemm_kernel<EPI>``,
  before the Hopper GEMM core) and the Hopper core's (``gemm_sm90<EPI>``)
  naming, so a copy of this file profiles an older tree as well.
With ``--ln`` it times only K1/K2's LayerNorm launch alone at the two MLP
sites' rows (encoder 9,216 x 1024, decoder 2 x 18,432 x 768), each call on
the next of 4 inputs so that it reads HBM, beside F.layer_norm.
With ``--engine`` it also builds VIT_L_512 from seeded weights and times the
serving engine (``inference.engine.inference``) on ``chip_smoke.py``'s 24
synthetic frames (190 pairs, batch 32): two warm runs, pairs/s of each.
It prints the card's name and power limit and one JSON line, and writes the
same JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import torch


def _gemm(epi: int) -> str:
    """A GEMM launch with epilogue `epi`, by either core's kernel name."""
    return rf"gemm_kernel<{epi}>|gemm_sm90<{epi}>"


# (part, regular expression on the kernel's name); first match wins
PARTS = (("layernorm", "layernorm"),
         ("q/k GEMMs (bias + RoPE)", _gemm(1)),
         ("v GEMM (bias)", _gemm(0)),
         ("out-projection GEMM (bias + residual)", _gemm(3)),
         ("attention", "attention"))
MLP_PARTS = (("layernorm", "layernorm"),
             ("fc1 GEMM (bias + GELU)", _gemm(2)),
             ("fc2 GEMM (bias + residual)", _gemm(3)))
SITES = (("encoder self", 1, 16, 1024, 16, False),
         ("decoder self", 2, 32, 768, 12, False),
         ("decoder cross", 2, 32, 768, 12, True))
MLP_SITES = (("encoder mlp", 1, 16, 1024), ("decoder mlp", 2, 32, 768))


def part(name: str, parts=PARTS) -> str:
    for label, pattern in parts:
        if re.search(pattern, name):
            return label
    return "other"


def graph_ms(fn, reps: int = 10) -> float:
    """Mean device ms of fn() replayed from one CUDA graph of `reps` calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_site(dev, gen, name, G, B, C, H, cross, reps: int = 10) -> dict:
    from align3r_tpu_torch.models.rope import make_grid_positions
    from align3r_tpu_torch.ops import fused_site as fs
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0, dt=bf: (torch.randn(*s, generator=gen, device=dev) * sc).to(dt)
    pos = make_grid_positions(288 // 16, 512 // 16, device=dev)
    N = pos.shape[0]
    x = rnd(G, B, N, C)
    kv = rnd(G, B, N, C) if cross else x
    w = [rnd(G, C, C, sc=C ** -0.5) for _ in range(4)]
    b = [rnd(G, C, sc=0.1, dt=torch.float32) for _ in range(4)]
    ln = lambda: (1 + rnd(G, C, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32))
    lnq, lnkv = ln(), (ln() if cross else "same")
    site = lambda: fs.attention_site(x, kv, *w, *b, pos, H, 100.0, ln_q=lnq, ln_kv=lnkv,
                                     residual=True)
    return split_site(f"{name} G={G} B={B} N={N} C={C} H={H}", site, PARTS, reps)


def profile_mlp(dev, gen, name, G, B, C, reps: int = 10) -> dict:
    from align3r_tpu_torch.ops import fused_site as fs
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0, dt=bf: (torch.randn(*s, generator=gen, device=dev) * sc).to(dt)
    N, F = (288 // 16) * (512 // 16), 4 * C
    x = rnd(G, B, N, C)
    w1, w2 = rnd(G, C, F, sc=C ** -0.5), rnd(G, F, C, sc=F ** -0.5)
    b1, b2 = rnd(G, F, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32)
    ln = (1 + rnd(G, C, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32))
    site = lambda: fs.mlp_site(x, w1, b1, w2, b2, ln=ln, residual=True)
    return split_site(f"{name} G={G} B={B} N={N} C={C} F={F}", site, MLP_PARTS, reps)


def profile_layernorm(dev, gen, name, G, B, C, reps: int = 20, rotate: int = 4) -> dict:
    """K1/K2's LayerNorm launch alone (fused_site._ln_cuda) and F.layer_norm
    (one call per stream, bf16 weights) on the same (G, B, 576, C) bf16 rows,
    each from a CUDA graph of `reps` calls, each call on the next of `rotate`
    inputs with the last 2 x `rotate` outputs kept, so that it reads HBM and
    not the L2."""
    import collections
    import itertools
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import _lib
    from align3r_tpu_torch.ops import fused_site as fs
    xs = [torch.randn(G, B, 576, C, generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(rotate)]
    p = (1 + 0.1 * torch.randn(G, C, generator=gen, device=dev),
         0.1 * torch.randn(G, C, generator=gen, device=dev))
    wb = [t.to(torch.bfloat16) for t in p]
    lib = _lib.library()
    keep = collections.deque(maxlen=2 * rotate)

    def rotated(f):
        turn = itertools.count()
        return lambda: keep.append(f(xs[next(turn) % rotate]))

    res = {"site": f"layernorm {name}", "rows": G * B * 576, "C": C,
           "ms": graph_ms(rotated(lambda x: fs._ln_cuda(lib, x, p, _lib.stream())), reps),
           "library_ms": graph_ms(rotated(lambda x: [
               F.layer_norm(x[g], (C,), wb[0][g], wb[1][g], 1e-6) for g in range(G)]), reps)}
    keep.clear()
    return res


def split_site(label, site, parts, reps, graph: bool = True) -> dict:
    """The site's device time from a CUDA graph (None with graph=False, for
    a call that cannot be captured), and its kernels' device time by part
    under torch.profiler."""
    for _ in range(3):
        site()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            site()
        torch.cuda.synchronize()
    split, names = defaultdict(float), defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            split[part(e.name, parts)] += e.device_time / 1e3 / reps
            names[e.name[:100]] += e.device_time / 1e3 / reps
    total = sum(split.values())
    return {"site": label, "graph_ms": graph_ms(site) if graph else None, "kernel_sum_ms": total,
            "split_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "split_share": {k: v / total for k, v in split.items()},
            "kernels_ms": dict(sorted(names.items(), key=lambda kv: -kv[1]))}


def serving_setup(dev):
    """VIT_L_512 from seeded weights (prepared in bf16) and chip_smoke.py's
    24 synthetic 512x288 frames with their priors and pairs (190, the
    swinstride-5 graph). Returns (pm, imgs, priors, pairs)."""
    import numpy as np
    from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import VIT_L_512
    n, H, W = 24, 288, 512
    with torch.device(dev):
        model = Align3R(VIT_L_512)
    init_align3r_(model, seed=0)
    with torch.no_grad():
        gz = torch.Generator(device=dev).manual_seed(1)
        for z in model.zero_convs:
            z[0].weight.copy_(torch.randn(z[0].weight.shape, generator=gz, device=dev) * 0.02)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    pm = model.prepare(torch.bfloat16, torch.bfloat16)
    del model
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = torch.from_numpy((2.0 + 0.5 * np.sin(xx / 60) + 0.3 * np.cos(yy / 45))
                             .astype(np.float32))
    priors = np.stack([pixel_to_pointcloud(depth, 500.0).numpy()] * n)
    return pm, imgs, priors, make_pairs(n, "swinstride-5-noncyclic", symmetrize=True)


def engine_rates(dev) -> dict:
    """Two warm runs of the serving engine at VIT_L_512 on 24 synthetic
    512x288 frames (190 pairs, batch 32)."""
    from align3r_tpu_torch.inference.engine import inference
    pm, imgs, priors, pairs = serving_setup(dev)
    inference(pairs, pm, imgs, priors, batch_size=32)   # cold: cuDNN picks its algorithms
    torch.cuda.synchronize()
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        inference(pairs, pm, imgs, priors, batch_size=32)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"pairs": len(pairs), "engine_s": secs, "pairs_per_s": [len(pairs) / s for s in secs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/site_profile.json")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--ln", action="store_true",
                    help="time only the LayerNorm launch alone, beside F.layer_norm")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_site needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.ln:
        res = {"card": card, "sites": [profile_layernorm(dev, gen, *s) for s in MLP_SITES]}
    else:
        res = {"card": card, "sites": [profile_site(dev, gen, *s) for s in SITES]
               + [profile_mlp(dev, gen, *s) for s in MLP_SITES]}
    if args.engine:
        res["engine"] = engine_rates(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
