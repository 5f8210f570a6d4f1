"""Profile the solve's fused edge loss, K3 (forward) and K4 (backward), on one
GPU, by launch, and the solve itself.

    python -m align3r_tpu_torch.tools.profile_edge [--out build/edge_profile.json]
        [--solve]

Runs K3 and K4 at the main path's shape (n = 24 images, e2 = 380 terms,
A = 147,456 pixels: 24 frames at 512x288) on seeded random inputs, the
terms sorted by image as the solve's pack lays them out, with bf16 and with
fp32 observations (the solve's first 240 and last 60 iterations). It calls
only what every tree of the port has: K3 through ``EdgeLoss.apply`` under
``torch.no_grad()``, K4 through ``edge_loss_bwd(g, proj, pw34, pred, w, idx,
order, offsets)``, so a copy of this file profiles an older tree as well.
Per kernel and dtype it reports:
- the device time from a CUDA graph of 20 calls (CUDA events), and over 20
  calls launched one by one (CUDA events);
- its bound (the bytes it must move at 3.35 TB/s: proj, pred, w, the 3x4
  matrices and the term lists read once, K4's dproj and dM written once)
  and the share of it;
- its split by launch under torch.profiler over 10 calls, in device ms per
  call: the walk (kernels named ``edge_fwd`` / ``edge_bwd``) and the second
  pass (the partial sums).
With ``--solve`` it also times the 300-iteration solve of the main path
(``global_alignment_loop``, mixed precision, the flow variant's loss without
flows) on 24 synthetic 512x288 frames and the swinstride-5 graph's 190
pairs, from random pose and depth parameters: one cold solve, then two,
each ending in a device synchronise (``solve_s``, it/s).
It prints the card's name and power limit and one JSON line, and writes the
same JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from align3r_tpu_torch.tools.profile_site import graph_ms, split_site

HBM_BYTES_S = 3.35e12
N, E2, HH, WW = 24, 380, 288, 512
# (part, regular expression on the kernel's name): the walk, then the second
# pass (``edge_loss_sum`` / ``edge_dm_sum``; ``sum_kernel`` /
# ``dm_reduce_kernel`` before the walk was one for both kernels)
PARTS = (("walk", "edge_fwd|edge_bwd"), ("second pass", "sum|reduce"))


def eager_ms(fn, reps: int = 20) -> float:
    """Mean ms of fn() launched one by one, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_kernels(dev) -> list:
    from align3r_tpu_torch.ops import edge_loss as el
    gen = torch.Generator(device=dev).manual_seed(0)
    A = HH * WW
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        proj = torch.randn(N, 3, A, generator=gen, device=dev)
        pred = torch.randn(E2, 3, A, generator=gen, device=dev).to(dt)
        w = (torch.rand(E2, A, generator=gen, device=dev) / (E2 * A)).to(dt)
        idx = torch.sort(torch.randint(0, N, (E2,), generator=gen, device=dev,
                                       dtype=torch.int32)).values
        pw34 = (torch.eye(3, 4, device=dev)[None]
                + 0.1 * torch.randn(E2, 3, 4, generator=gen, device=dev)).contiguous()
        order, offsets = (t.to(dev) for t in el.term_csr(idx, N))
        g = torch.tensor(1.5, device=dev)

        def fwd():
            with torch.no_grad():
                return el.EdgeLoss.apply(proj, pw34, pred, w, idx, order, offsets)

        bwd = lambda: el.edge_loss_bwd(g, proj, pw34, pred, w, idx, order, offsets)
        isz = pred.element_size()
        reads = N * 3 * A * 4 + E2 * 48 + E2 * 4 * A * isz + E2 * 4 + (N + 1) * 4
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        for name, fn, nbytes in (("K3", fwd, reads + 4),
                                 ("K4", bwd, reads + 4 + N * 3 * A * 4 + E2 * 48)):
            ms = graph_ms(fn, 20)
            bound_ms = nbytes / HBM_BYTES_S * 1e3
            sp = split_site(f"{name} {tag}", fn, PARTS, 10, graph=False)
            rows.append({"kernel": name, "dtype": tag, "shape": f"n={N} e2={E2} A={A}",
                         "ms": ms, "ms_eager": eager_ms(fn), "bound_ms": bound_ms,
                         "bound_share": bound_ms / ms, "split_ms": sp["split_ms"],
                         "kernels_ms": sp["kernels_ms"]})
        del proj, pred, w
    return rows


def solve_times(dev, runs: int = 2) -> dict:
    """The main path's 300-iteration solve on synthetic observations."""
    import numpy as np
    from align3r_tpu_torch.alignment.flow import flow_forward
    from align3r_tpu_torch.alignment.scene import (build_scene, default_masks,
                                                   global_alignment_loop)
    from align3r_tpu_torch.inference.pairs import make_pairs
    pairs = make_pairs(N, "swinstride-5-noncyclic", symmetrize=True)
    E = len(pairs)
    rng = np.random.default_rng(0)
    as_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    output = {"view1": {"idx": np.array([p[0] for p in pairs])},
              "view2": {"idx": np.array([p[1] for p in pairs])},
              "pred1": {"pts3d": as_dev(rng.standard_normal((E, HH, WW, 3))),
                        "conf": as_dev(1 + rng.uniform(size=(E, HH, WW)) * 3)},
              "pred2": {"pts3d_in_other_view": as_dev(rng.standard_normal((E, HH, WW, 3))),
                        "conf": as_dev(1 + rng.uniform(size=(E, HH, WW)) * 3)}}
    scene_kw = dict(shared_focal=True, temporal_smoothing_weight=0.01, translation_weight=1.0,
                    flow_loss_weight=0.0, flow_loss_start_epoch=0.1, flow_loss_thre=25,
                    min_conf_thr=1.1, num_total_iter=300)
    cfg, data, params0 = build_scene(output, cfg_kw=scene_kw)
    masks = default_masks(cfg, params0)
    secs, finite = [], True
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = global_alignment_loop(dict(params0), masks, data, cfg, lr=0.01, niter=300,
                                          schedule="linear", loss_fn=flow_forward)
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(losses).all())
    return {"pairs": E, "solve_s": secs, "it_per_s": [300 / s for s in secs],
            "losses_finite": finite}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/edge_profile.json")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_edge needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    res = {"card": card, "tree": os.getcwd(), "kernels": profile_kernels(dev)}
    for r in res["kernels"]:
        print(json.dumps(r), flush=True)
    if args.solve:
        res["solve"] = solve_times(dev)
        print(json.dumps(res["solve"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
