"""Profile the batched RANSAC-PnP (alignment/pnp.py) on one GPU at the
serving paths' problem counts.

    python -m align3r_tpu_torch.tools.profile_pnp [--out build/pnp_profile.json]

Two cases, each one `ransac_pnp` call over noisy 288x512 pointmaps (a smooth
surface about 2 away, focal 400, point noise 0.01, 5% outliers, 80% of the
pixels masked):
- init: 12 problems at niter 10, about the frames mst_init leaves without a
  pose on the main path's 24 frames;
- masks: 190 problems at niter 100, the motion masks' two PnPs of each of
  the 95 symmetric pairs of the flow path at 24 frames.
For each: seconds per call (host clock around the call, which ends in a
read of the result), after one warm call, over 3 calls; the device's busy
share and kernel time by name over one profiled call; and the largest
cam2world difference from the same call on the CPU for 2 of its problems.
Prints the card's name and power limit, one summary line per case, and
writes the full tables as JSON to --out.
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

from align3r_tpu_torch.alignment.pnp import ransac_pnp
from align3r_tpu_torch.geometry.core import xy_grid

H, W, FOCAL = 288, 512, 400.0
CASES = {"init": (12, 10), "masks": (190, 100)}


def problems(n: int, seed: int = 0):
    """n noisy pointmaps (n, H*W, 3), masks (n, H*W), on the host."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    X = np.empty((n, H * W, 3), np.float32)
    for b in range(n):
        d = 2 + 0.5 * np.sin(u / 51.2 + b)
        cam = np.stack([(u - W / 2) / FOCAL * d, (v - H / 2) / FOCAL * d, d], -1).reshape(-1, 3)
        th = rng.normal(size=3) * 0.2
        k = np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
        a = np.linalg.norm(th)
        R = np.eye(3) + np.sin(a) / a * k + (1 - np.cos(a)) / a ** 2 * k @ k
        x = (cam - rng.normal(size=3) * 0.3) @ R + 0.01 * rng.standard_normal(cam.shape)
        bad = rng.random(len(x)) < 0.05
        x[bad] += rng.normal(size=(bad.sum(), 3))
        X[b] = x
    return torch.from_numpy(X), torch.from_numpy(rng.random((n, H * W)) < 0.8)


def run_case(dev, n: int, niter: int) -> dict:
    X, masks = problems(n)
    pix = xy_grid(W, H).reshape(-1, 2)
    focals = [[FOCAL]] * n
    args = (X.to(dev), pix.to(dev), masks.to(dev), focals, (W / 2, H / 2), niter)
    res = ransac_pnp(*args)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ransac_pnp(*args)
        secs.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ransac_pnp(*args)
        window = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time / 1e3
    busy = sum(by_name.values())
    pick = [0, n - 1]
    cpu = ransac_pnp(X[pick], pix, masks[pick], [focals[b] for b in pick], (W / 2, H / 2), niter)
    diff = max((res[b][1].cpu() - c[1]).abs().max().item()
               for b, c in zip(pick, cpu) if c is not None and res[b] is not None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"problems": n, "niter": niter, "points": H * W,
            "posed": sum(r is not None for r in res), "s_per_call": secs,
            "profiled_window_ms": window, "device_busy_ms": busy,
            "device_busy_share": busy / window, "cpu_max_abs_c2w_diff": diff,
            "top_kernels_ms": dict(top)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/pnp_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pnp needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    print(f"card: {card}", flush=True)
    out = {"card": card}
    for name, (n, niter) in CASES.items():
        out[name] = r = run_case(dev, n, niter)
        print(f"{name}: " + json.dumps({k: v for k, v in r.items() if k != "top_kernels_ms"}),
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
