"""Synthetic inputs of the PnP tests, in numpy alone (no cv2, no jax), so
that the card's tests can use them too.

- `surface_view`: one pointmap of a smooth surface about 2 away, seen by a
  randomly posed camera at focal f, with point noise and outliers.
- `graph_output`: a consistent scene's engine output over any graph of
  frame pairs: smooth depths, small camera motion, noisy pointmaps.
"""
import numpy as np


def rodrigues(rv):
    """The rotation matrix of an axis-angle vector (3,)."""
    a = np.linalg.norm(rv)
    k = np.array([[0, -rv[2], rv[1]], [rv[2], 0, -rv[0]], [-rv[1], rv[0], 0]])
    return np.eye(3) + np.sin(a) / a * k + (1 - np.cos(a)) / a ** 2 * k @ k


def surface_view(seed, h=288, w=512, f=400.0, noise=0.01, outliers=0.0, period=None):
    """A pointmap (h, w, 3) float32: depth 2 + 0.5 sin(u / period + seed)
    (period w / 10 by default) seen at focal f by a camera turned by
    N(0, 0.2) per axis and moved by N(0, 0.3), Gaussian point noise, and a
    share of outliers moved by N(0, 1)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    d = 2 + 0.5 * np.sin(u / (w / 10 if period is None else period) + seed)
    cam = np.stack([(u - w / 2) / f * d, (v - h / 2) / f * d, d], -1).reshape(-1, 3)
    R, t = rodrigues(rng.normal(size=3) * 0.2), rng.normal(size=3) * 0.3
    X = (cam - t) @ R + noise * rng.standard_normal(cam.shape)
    bad = rng.random(len(X)) < outliers
    X[bad] += rng.normal(size=(bad.sum(), 3))
    return X.reshape(h, w, 3).astype(np.float32)


def graph_output(edges, n, h=16, w=24, f=40.0, noise=0.01, seed=0):
    """The engine's output (numpy) for frame pairs `edges` over n frames:
    depths 2 + 0.3 sin(u / 5 + k) + 0.2 cos(v / 4), frame k turned by 0.03 k
    about y and moved by (0.1, 0.02, 0.05) k, point noise `noise`,
    confidence 8. Returns the output and the cam2world poses (n, 4, 4)."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    poses = []
    for k in range(n):
        th = 0.03 * k
        T = np.eye(4)
        T[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        T[:3, 3] = [0.1 * k, 0.02 * k, 0.05 * k]
        poses.append(T)
    cams = []
    for k in range(n):
        d = 2.0 + 0.3 * np.sin(u / 5 + k) + 0.2 * np.cos(v / 4)
        cams.append(np.stack([d * (u - w / 2) / f, d * (v - h / 2) / f, d], -1))
    rel = [np.linalg.inv(poses[i]) @ poses[j] for i, j in edges]
    r = np.random.default_rng(seed)
    noisy = lambda p: (p + noise * r.standard_normal(p.shape)).astype(np.float32)
    conf = np.full((len(edges), h, w), 8.0, np.float32)
    return {"view1": {"idx": np.array([e[0] for e in edges])},
            "view2": {"idx": np.array([e[1] for e in edges])},
            "pred1": {"pts3d": noisy(np.stack([cams[i] for i, _ in edges])), "conf": conf},
            "pred2": {"pts3d_in_other_view": noisy(np.stack(
                [cams[j] @ T[:3, :3].T + T[:3, 3] for (i, j), T in zip(edges, rel)])),
                "conf": conf.copy()}}, np.stack(poses)
