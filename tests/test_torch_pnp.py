"""The port's fast_pnp from 4 points, as the JAX package's cv2
solvePnPRansac (SQPNP) gives a pose from 4: masks of 4 and 5 valid pixels
on noise-free points. With the focal given, both recover the true pose, so
the port's is held to JAX's within 1e-5 (entries of cam2world); with the
focal swept, both pick the same focal (the first of the sweep at which
every point is an inlier) and the port's pose puts every point within the
5 px inlier threshold. Below 4 points neither gives a pose."""
import numpy as np
import pytest

from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import pnp as tpnp

H, W, F = 24, 32, 30.0


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _scene(n, seed):
    """A pointmap whose n masked pixels hold world points seen by a camera
    at focal F: (pts3d, mask, true cam2world)."""
    rng = np.random.default_rng(seed)
    R, t = _rodrigues(rng.normal(size=3) * 0.3), rng.normal(size=3) * 0.5
    msk = np.zeros((H, W), bool)
    msk.flat[rng.choice(H * W, n, replace=False)] = True
    v, u = np.nonzero(msk)
    z = rng.uniform(2, 5, n)
    cam = np.stack([(u - W / 2) / F * z, (v - H / 2) / F * z, z], 1)
    pts = np.zeros((H, W, 3), np.float32)
    pts[v, u] = (cam - t) @ R
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R, t
    return pts, msk, np.linalg.inv(w2c)


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_pnp_from_4_and_5_points_matches_jax(n, seed):
    pts, msk, c2w = _scene(n, seed)
    ref = jinit.fast_pnp(pts, F, msk)
    got = tinit.fast_pnp(pts, F, msk)
    assert ref is not None and got is not None
    assert got[0] == ref[0] == F
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    np.testing.assert_allclose(got[1], c2w, atol=1e-5)


@pytest.mark.parametrize("n", [4, 5])
def test_fast_pnp_focal_sweep_from_4_and_5_points(n):
    pts, msk, _ = _scene(n, 3)
    ref, got = jinit.fast_pnp(pts, None, msk), tinit.fast_pnp(pts, None, msk)
    assert ref is not None and got is not None and got[0] == ref[0]
    v, u = np.nonzero(msk)
    cam = pts[v, u] @ np.linalg.inv(got[1])[:3, :3].T + np.linalg.inv(got[1])[:3, 3]
    proj = got[0] * cam[:, :2] / cam[:, 2:] + [W / 2, H / 2]
    assert np.linalg.norm(proj - np.stack([u, v], 1), axis=1).max() < 5.0


def test_fast_pnp_below_4_points_gives_no_pose():
    pts, msk, _ = _scene(3, 4)
    assert jinit.fast_pnp(pts, F, msk) is None and tinit.fast_pnp(pts, F, msk) is None
    assert tinit.MIN_PNP_POINTS == 4


def test_p3p_recovers_every_pose_it_is_given():
    """The minimal solver alone: three points, the true pose among its
    solutions to 1e-9."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        R, t = _rodrigues(rng.normal(size=3)), rng.normal(size=3)
        cam = np.concatenate([rng.uniform(-1, 1, (3, 2)), rng.uniform(2, 6, (3, 1))], 1)
        X = (cam - t) @ R
        sols = tpnp._p3p(X, cam[:, :2] / cam[:, 2:])
        assert min(np.abs(Rs - R).max() + np.abs(ts - t).max() for Rs, ts in sols) < 1e-9
