"""How close the port's PnP (align3r_tpu_torch/alignment/pnp.py) comes to
the JAX package's cv2.solvePnPRansac(SQPNP), over more draws than the tests
take. Not a test: it prints the statistics the tests' tolerances and
PERF.md rest on.

    JAX_PLATFORMS=cpu python tests/pnp_parity_stats.py

1. cv2 against itself: the same noisy 512x288 view with its points in 5
   other orders (other RANSAC draws): cam2world's largest difference.
2. `fast_pnp` against the JAX package's on two surfaces, point noise 0.01,
   0 / 5 / 10% outliers: how many draws agree within 1e-4, and each draw's
   difference. Surface A is tests/pnp_views.py's `surface_view` (8 draws), B a
   smoother one (24 draws).
3. `sqpnp` against cv2.solvePnP(SQPNP), 200 problems of 6 to 59 points at
   1 px per kind (general, planar, narrow): the largest difference of rvec
   and t, its 99th percentile, and how many exceed 1e-6.
"""
import os
import sys

import cv2
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from align3r_tpu.alignment import init_poses as jinit          # noqa: E402
from align3r_tpu_torch.alignment import init_poses as tinit    # noqa: E402
from align3r_tpu_torch.alignment import pnp                    # noqa: E402
from pnp_views import surface_view                              # noqa: E402
from test_torch_sqpnp import CX, CY, F, K64, _problem           # noqa: E402

H, W = 288, 512


def _c2w(rv, tv):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = cv2.Rodrigues(rv)[0], tv.ravel()
    return np.linalg.inv(T)


def cv2_spread():
    pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2).astype(np.float64)
    K = np.float32([(F, 0, W / 2), (0, F, H / 2), (0, 0, 1)])
    diffs = []
    for seed in range(3):
        X = surface_view(seed).reshape(-1, 3).astype(np.float64)
        call = lambda x, p: _c2w(*cv2.solvePnPRansac(x, p, K, None, iterationsCount=100,
                                                     reprojectionError=5,
                                                     flags=cv2.SOLVEPNP_SQPNP)[1:3])
        base = call(X, pix)
        for k in range(5):
            order = np.random.default_rng(100 + k).permutation(len(X))
            diffs.append(np.abs(call(X[order], pix[order]) - base).max())
    print(f"1. cv2 against itself over other draws: {min(diffs):.3g} to {max(diffs):.3g}")


def fast_pnp_draws():
    msk = np.ones((H, W), bool)
    for name, period, n in (("A", None, 8), ("B", 50, 24)):
        diffs = []
        for seed in range(n):
            pts = surface_view(seed, outliers=0.05 * (seed % 3), period=period)
            ref = jinit.fast_pnp(pts, F, msk, niter_PnP=100)
            got = tinit.fast_pnp(pts, F, msk, niter_PnP=100)
            diffs.append(np.abs(got[1] - ref[1]).max())
        diffs = np.array(diffs)
        print(f"2. surface {name}: {(diffs <= 1e-4).sum()} of {n} draws within 1e-4; "
              f"median {np.median(diffs):.3g}, largest {diffs.max():.3g}; "
              + " ".join(f"{d:.2g}" for d in diffs))


def sqpnp_problems():
    for kind in ("general", "planar", "narrow"):
        rng = np.random.default_rng(10)
        ds = []
        for _ in range(200):
            n = int(rng.integers(6, 60))
            X, pix = _problem(rng, kind, n, 1.0)
            _, rv, tv = cv2.solvePnP(X, pix, K64, None, flags=cv2.SOLVEPNP_SQPNP)
            R, t, _ = pnp.sqpnp(torch.tensor(X[None]), torch.tensor((pix - [CX, CY]) / F)[None],
                                torch.ones(1, n, dtype=torch.float64))
            ds.append(max(np.abs(cv2.Rodrigues(R[0].numpy())[0].ravel() - rv.ravel()).max(),
                          np.abs(t[0].numpy() - tv.ravel()).max()))
        ds = np.array(ds)
        print(f"3. sqpnp {kind}: largest {ds.max():.3g}, 99th percentile "
              f"{np.quantile(ds, 0.99):.3g}, {(ds > 1e-6).sum()} of 200 beyond 1e-6")


if __name__ == "__main__":
    torch.set_num_threads(4)
    cv2_spread()
    fast_pnp_draws()
    sqpnp_problems()
