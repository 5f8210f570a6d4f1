"""The port's batched PnP (align3r_tpu_torch/alignment/pnp.py) against
OpenCV, which the JAX package calls: cv2.solvePnPRansac(..., SOLVEPNP_SQPNP)
in align3r_tpu/alignment/init_poses.py:64-91.

- `sqpnp` against cv2.solvePnP(SOLVEPNP_SQPNP) on noisy general, planar and
  narrow-view sets, batched with padding: rvec and t to 1e-6 (fp64; planar
  2e-6, see the test), and on the inliers cv2.solvePnPRansac returns, its
  pose to 1e-6.
- `epnp` against cv2.solvePnP(SOLVEPNP_EPNP), RANSAC's kernel: to 1e-9 from
  6 noisy points on; from 5 noise-free points to 1e-6.
- `ransac_subsets` against a plain transcription of cv::RNG(-1) and
  RANSACPointSetRegistrator::getSubset.
- `fast_pnp` against the JAX package's on a 512x288 view (focal 400, depth
  about 2, every pixel masked, 100 iterations) with point noise 0.01 and 0,
  5 or 10% outliers. Where the port's best hypothesis is cv2's, the two
  agree to float32 rounding; the port's EPnP on exactly 5 points cannot
  reproduce the basis of the 2-dimensional null space that OpenCV's Jacobi
  sweeps set from rounding, so now and then another hypothesis wins, which
  moves the pose as far as another RANSAC draw of cv2's own does (3.6e-3 to
  1.8e-2 on this view: tests/pnp_parity_stats.py). Held, over 8 draws:
  where the port's inliers are cv2's, cam2world within 1e-5; cam2world
  within 1e-4 and the inlier count within 0.5% on at least half the draws
  (5 of 8 here, 21 of 24 on a smoother surface); the median within 1e-4 and
  every draw within 1e-2.
- `ransac_pnp` on a batch of problems (masks of 3, 4, 5 and many points, two
  focals each; or 1 to 4 focals each) against one problem at a time: equal
  to 1e-12. A focal of at most 5 px gives no pose.
- A narrow view of a distant object (the camera 30 times the points'
  extent away): `fast_pnp` against the JAX package's, cam2world to 1e-4.
"""
import cv2
import numpy as np
import pytest
import torch

from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import pnp

from pnp_views import surface_view

torch.set_num_threads(2)
F, CX, CY = 400.0, 256.0, 144.0
K64 = np.array([[F, 0, CX], [0, F, CY], [0, 0, 1]])


def _problem(rng, kind, n, noise):
    """n world points and their pixels (noise in pixels) seen by a random
    camera: a general cloud, a tilted plane, or a 1.3-degree narrow view."""
    if kind == "general":
        cam = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(1.5, 3, (n, 1))], 1)
    elif kind == "planar":
        uv = rng.uniform(-1, 1, (n, 2))
        cam = np.concatenate([uv, 2 + 0.3 * uv[:, :1]], 1)
    else:
        cam = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)), rng.uniform(4, 5, (n, 1))], 1)
    R, t = cv2.Rodrigues(rng.normal(size=3) * 0.5)[0], rng.normal(size=3)
    pix = F * cam[:, :2] / cam[:, 2:] + [CX, CY] + noise * rng.standard_normal((n, 2))
    return (cam - t) @ R, pix


@pytest.mark.parametrize("kind,tol", [("general", 1e-6), ("planar", 2e-6), ("narrow", 1e-6)])
def test_sqpnp_matches_cv2(kind, tol):
    """20 problems of 6 to 59 points, 1 px of noise, in one padded batch.
    Any planar object leaves Omega a 3-dimensional null space (the rotation
    of the plane's normal is unobservable once t is eliminated), whose basis
    each solver sets from rounding; SQP then starts elsewhere and stops at
    OpenCV's step tolerance (a squared step of 1e-10) up to 1.2e-6 from
    cv2's (1 planar problem in 200 beyond 1e-6)."""
    rng = np.random.default_rng({"general": 0, "planar": 1, "narrow": 2}[kind])
    A, Xs, xns, ws, ref = 60, [], [], [], []
    for _ in range(20):
        n = int(rng.integers(6, A))
        X, pix = _problem(rng, kind, n, 1.0)
        _, rv, tv = cv2.solvePnP(X, pix, K64, None, flags=cv2.SOLVEPNP_SQPNP)
        Xs.append(np.pad(X, ((0, A - n), (0, 0))))
        xns.append(np.pad((pix - [CX, CY]) / F, ((0, A - n), (0, 0))))
        ws.append(np.arange(A) < n)
        ref.append((rv.ravel(), tv.ravel()))
    R, t, ok = pnp.sqpnp(torch.tensor(np.stack(Xs)), torch.tensor(np.stack(xns)),
                         torch.tensor(np.stack(ws), dtype=torch.float64))
    assert ok.all()
    for k, (rv, tv) in enumerate(ref):
        np.testing.assert_allclose(cv2.Rodrigues(R[k].numpy())[0].ravel(), rv, atol=tol)
        np.testing.assert_allclose(t[k].numpy(), tv, atol=tol)


def test_sqpnp_on_cv2_inliers_gives_cv2_ransac_pose():
    """The pose cv2.solvePnPRansac returns is SQPnP on its best hypothesis's
    inliers, from the float32 points."""
    h, w, f = 64, 96, 80.0
    pts = surface_view(3, h, w, noise=0.05, outliers=0.1, f=f)
    pix = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2).astype(np.float64)
    K = np.float32([(f, 0, w / 2), (0, f, h / 2), (0, 0, 1)])
    _, rv, tv, inl = cv2.solvePnPRansac(pts.reshape(-1, 3).astype(np.float64), pix, K, None,
                                        iterationsCount=100, reprojectionError=5,
                                        flags=cv2.SOLVEPNP_SQPNP)
    assert 0 < len(inl) < h * w
    sel = inl[:, 0]
    R, t, ok = pnp.sqpnp(torch.tensor(pts.reshape(-1, 3)[sel], dtype=torch.float64)[None],
                         torch.tensor((pix[sel] - [w / 2, h / 2]) / np.float64(K[0, 0]))[None],
                         torch.ones(1, len(sel), dtype=torch.float64))
    assert ok.all()
    np.testing.assert_allclose(cv2.Rodrigues(R[0].numpy())[0].ravel(), rv.ravel(), atol=1e-6)
    np.testing.assert_allclose(t[0].numpy(), tv.ravel(), atol=1e-6)


@pytest.mark.parametrize("n,noise,tol", [(5, 0.0, 1e-6), (6, 2.0, 1e-9), (20, 2.0, 1e-9)])
def test_epnp_matches_cv2(n, noise, tol):
    """RANSAC's kernel, as cv2 feeds it: float32 points, and pixels that
    undistortPoints rounds to float32 normalised coordinates."""
    rng = np.random.default_rng(n)
    K32 = np.float32(K64)
    pw, us, ref = [], [], []
    for _ in range(50):
        cam = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(1.5, 3, (n, 1))], 1)
        pix = (F * cam[:, :2] / cam[:, 2:] + [CX, CY]
               + noise * rng.standard_normal((n, 2))).astype(np.float32)
        X = cam.astype(np.float32)
        _, rv, tv = cv2.solvePnP(X, pix, K32, None, flags=cv2.SOLVEPNP_EPNP)
        xn = ((pix.astype(np.float64) - [CX, CY]) * (1 / F)).astype(np.float32)
        pw.append(X.astype(np.float64))
        us.append(xn.astype(np.float64) * F + [CX, CY])
        ref.append((cv2.Rodrigues(rv)[0], tv.ravel()))
    P = len(pw)
    R, t = pnp.epnp(torch.tensor(np.stack(pw)), torch.tensor(np.stack(us)),
                    torch.full((P,), F, dtype=torch.float64),
                    torch.tensor([[CX, CY]] * P, dtype=torch.float64))
    for k, (Rr, tr) in enumerate(ref):
        np.testing.assert_allclose(R[k].numpy(), Rr, atol=tol)
        np.testing.assert_allclose(t[k].numpy(), tr, atol=tol)


def _cv_subsets(count, niter):
    """cv::RNG((uint64)-1) and getSubset, one draw at a time."""
    state, out = 0xFFFFFFFFFFFFFFFF, []
    for _ in range(niter):
        idx = []
        while len(idx) < 5:
            state = (state & 0xFFFFFFFF) * 4164903690 + (state >> 32)
            k = (state & 0xFFFFFFFF) % count
            if k not in idx:
                idx.append(k)
        out.append(idx)
    return np.array(out)


def test_ransac_subsets_follow_cv_rng():
    counts = [6, 7, 9, 1000, 147456]
    got = pnp.ransac_subsets(counts, 100)
    for b, c in enumerate(counts):
        np.testing.assert_array_equal(got[b], _cv_subsets(c, 100))


def test_fast_pnp_matches_jax_on_a_noisy_view(monkeypatch):
    w_seen = []
    sq = pnp.sqpnp
    monkeypatch.setattr(pnp, "sqpnp", lambda X, xn, w: w_seen.append(w[0] > 0) or sq(X, xn, w))
    h, w = 288, 512
    pix = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2).astype(np.float64)
    K = np.float32([(F, 0, w / 2), (0, F, h / 2), (0, 0, 1)])
    msk = np.ones((h, w), bool)
    diffs, counts, same = [], [], []
    for seed in range(8):
        pts = surface_view(seed, outliers=0.05 * (seed % 3))
        ref = jinit.fast_pnp(pts, F, msk, niter_PnP=100)
        got = tinit.fast_pnp(pts, F, msk, niter_PnP=100)
        assert got is not None and got[0] == ref[0] == F
        diffs.append(np.abs(got[1] - ref[1]).max())
        inl = cv2.solvePnPRansac(pts.reshape(-1, 3).astype(np.float64), pix, K, None,
                                 iterationsCount=100, reprojectionError=5,
                                 flags=cv2.SOLVEPNP_SQPNP)[3][:, 0]
        mine = w_seen[-1].numpy()
        counts.append(abs(int(mine.sum()) - len(inl)) / len(inl))
        same.append(mine.sum() == len(inl) and mine[inl].all())
    diffs, counts, same = np.array(diffs), np.array(counts), np.array(same)
    # the same best hypothesis: SQPnP on the same inliers, float32 rounding
    assert same.any() and (diffs[same] <= 1e-5).all(), (diffs, same)
    assert ((diffs <= 1e-4) & (counts <= 5e-3)).sum() >= 4, (diffs, counts)
    assert np.median(diffs) <= 1e-4 and diffs.max() <= 1e-2, diffs


def test_ransac_pnp_batched_equals_single():
    """Problems of 3, 4, 5 and 1,600 masked points (noisy, with outliers),
    two focals each: the batch gives what each problem gives alone."""
    h, w = 40, 60
    pts = np.stack([surface_view(s, h, w, noise=0.02, outliers=0.1, f=60.0) for s in range(4)])
    rng = np.random.default_rng(0)
    masks = np.zeros((4, h * w), bool)
    for b, n in enumerate((3, 4, 5)):
        masks[b, rng.choice(h * w, n, replace=False)] = True
    masks[3, rng.choice(h * w, 1600, replace=False)] = True
    X = torch.from_numpy(pts.reshape(4, -1, 3))
    pix = torch.from_numpy(np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2))
    focals = [[55.0, 60.0]] * 4
    batch = pnp.ransac_pnp(X, pix, torch.from_numpy(masks), focals, (w / 2, h / 2), 50)
    assert batch[0] is None and batch[3] is not None
    for b in range(4):
        one = pnp.ransac_pnp(X[b:b + 1], pix, torch.from_numpy(masks[b:b + 1]), focals[b:b + 1],
                             (w / 2, h / 2), 50)[0]
        if one is None:
            assert batch[b] is None
            continue
        assert one[0] == batch[b][0]
        np.testing.assert_allclose(batch[b][1].numpy(), one[1].numpy(), rtol=0, atol=1e-12)


def test_ransac_pnp_takes_ragged_focals():
    """Problems may try different numbers of focals (mst_init sweeps 21 for
    a frame without one and tries one for the others): the batch gives what
    each problem gives alone, to 1e-12. A focal of at most 5 px (THRESHOLD)
    is no candidate: it changes no result, and a problem with no other focal
    gives None."""
    h, w = 40, 60
    pts = np.stack([surface_view(s, h, w, noise=0.02, outliers=0.1, f=60.0) for s in range(4)])
    X = torch.from_numpy(pts.reshape(4, -1, 3))
    pix = torch.from_numpy(np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2))
    masks = torch.ones(4, h * w, dtype=torch.bool)
    focals = [[60.0], [40.0, 50.0, 60.0, 70.0], [1e-4, 60.0], [1e-4, 5.0]]
    batch = pnp.ransac_pnp(X, pix, masks, focals, (w / 2, h / 2), 50)
    assert batch[3] is None and all(r is not None for r in batch[:3])
    for b, fs in ((0, [60.0]), (1, focals[1]), (2, [60.0])):
        one = pnp.ransac_pnp(X[b:b + 1], pix, masks[b:b + 1], [fs], (w / 2, h / 2), 50)[0]
        assert one[0] == batch[b][0]
        np.testing.assert_allclose(batch[b][1].numpy(), one[1].numpy(), rtol=0, atol=1e-12)


def test_fast_pnp_poses_a_distant_camera():
    """A narrow view (3.7 degrees) of an object about 1.3 across, 40 away:
    the camera's translation is 30 times the points' extent, and the port
    poses it as the JAX package's cv2 does, cam2world to 1e-4, at the true
    pose to 1e-3."""
    h, w, f, dist = 72, 128, 2000.0, 40.0
    rng = np.random.default_rng(7)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    d = dist + 0.3 * np.sin(u / 12.8) + 0.2 * np.cos(v / 9)
    cam = np.stack([(u - w / 2) / f * d, (v - h / 2) / f * d, d], -1).reshape(-1, 3)
    R, c = cv2.Rodrigues(rng.normal(size=3) * 0.5)[0], np.array([0.0, 0.0, dist])
    pts = ((cam - c) @ R).reshape(h, w, 3).astype(np.float32)   # world = R^T (cam - c)
    truth = np.eye(4)
    truth[:3, :3], truth[:3, 3] = R.T, -R.T @ c
    assert dist > 10 * np.abs(pts).max()
    msk = np.ones((h, w), bool)
    ref = jinit.fast_pnp(pts, f, msk, niter_PnP=100)
    got = tinit.fast_pnp(pts, f, msk, niter_PnP=100)
    assert ref is not None and got is not None and got[0] == ref[0] == f
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], truth, rtol=0, atol=1e-3)
