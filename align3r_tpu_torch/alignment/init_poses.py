"""Host-side MST initialisation for the global aligner (port of
align3r_tpu/alignment/init_poses.py).

The graph walk (scipy minimum spanning tree + greedy propagation) runs on the
host in numpy; the per-edge rigid registrations and focal estimates are torch
on CPU tensors. ``fast_pnp`` is a numpy RANSAC-PnP (no OpenCV): a seeded
sampler, a DLT pose refined by Gauss-Newton from each minimal sample (plus
one hypothesis from all points), a 5 px inlier threshold, the same focal
sweep and iteration count as the reference's cv2 call, and a final
refinement on the inliers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401  (registers sp.csgraph)
import torch

from align3r_tpu_torch.alignment.scene import (SceneConfig, SceneData,
                                               set_depthmap, set_focal)
from align3r_tpu_torch.geometry.core import geotrf, xy_grid
from align3r_tpu_torch.geometry.poses import (matrix_to_pose_vec,
                                              rigid_points_registration)


def estimate_focal_weiszfeld(pts3d, pp=None, min_focal: float = 0.0,
                             max_focal: float = np.inf, n_iter: int = 10):
    """Weiszfeld focal from a camera-frame pointmap (H, W, 3)."""
    pts3d = torch.as_tensor(np.asarray(pts3d), dtype=torch.float32)
    if pts3d.ndim != 3:
        raise ValueError("need (H, W, 3) to build the pixel grid")
    H, W = pts3d.shape[:2]
    pts = pts3d.reshape(-1, 3)
    if pp is None:
        pp = torch.tensor([W / 2, H / 2], dtype=torch.float32)
    pixels = xy_grid(W, H).reshape(-1, 2) - pp[None]
    z = pts[:, 2:3]
    xy_over_z = pts[:, :2] / torch.clamp(torch.abs(z), min=1e-8) * torch.sign(z)
    xy_over_z = torch.nan_to_num(xy_over_z, posinf=0.0, neginf=0.0)
    dot_xy_px = (xy_over_z * pixels).sum(-1)
    dot_xy_xy = (xy_over_z ** 2).sum(-1)
    focal = dot_xy_px.mean() / torch.clamp(dot_xy_xy.mean(), min=1e-12)
    for _ in range(n_iter):
        dis = torch.linalg.vector_norm(pixels - focal * xy_over_z, dim=-1)
        w = 1.0 / torch.clamp(dis, min=1e-8)
        focal = (w * dot_xy_px).mean() / torch.clamp((w * dot_xy_xy).mean(), min=1e-12)
    base = max(H, W) / (2 * np.tan(np.deg2rad(60) / 2))
    lo = max(min_focal * base, 1e-4)
    return float(torch.clamp(focal, lo, max_focal * base))


def _srt_to_4x4(s, R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(R) * s
    T[:3, 3] = np.asarray(t).ravel()
    return T


def _dlt_pose(X, xn):
    """World->camera [R | t] from >= 6 points X (m, 3) and normalised image
    coordinates xn (m, 2) by the direct linear transform, with R projected
    onto SO(3) and the scale and sign fixed (points in front). Both point
    sets are Hartley-normalised (centred, mean distance sqrt(3) / sqrt(2))
    before the SVD, which keeps the system well conditioned."""
    m = X.shape[0]
    mx = X.mean(0)
    sx = np.sqrt(3) / max(np.linalg.norm(X - mx, axis=1).mean(), 1e-12)
    mu = xn.mean(0)
    su = np.sqrt(2) / max(np.linalg.norm(xn - mu, axis=1).mean(), 1e-12)
    T3 = np.diag([sx, sx, sx, 1.0])
    T3[:3, 3] = -sx * mx
    T2 = np.diag([su, su, 1.0])
    T2[:2, 2] = -su * mu
    Xh = np.concatenate([(X - mx) * sx, np.ones((m, 1))], axis=1)
    un = (xn - mu) * su
    A = np.zeros((2 * m, 12))
    A[0::2, 0:4] = Xh
    A[0::2, 8:12] = -un[:, 0:1] * Xh
    A[1::2, 4:8] = Xh
    A[1::2, 8:12] = -un[:, 1:2] * Xh
    # null vector of A: the eigenvector of A^T A with the smallest eigenvalue
    P = np.linalg.eigh(A.T @ A)[1][:, 0].reshape(3, 4)
    P = np.linalg.inv(T2) @ P @ T3
    if np.median(Xh[:, :3] / sx @ P[2, :3] + P[2] @ np.r_[mx, 1.0]) < 0:
        P = -P                                    # points in front
    U, S, Vt = np.linalg.svd(P[:, :3])
    if S.mean() <= 0:
        return None
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return R, P[:, 3] / S.mean()


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _refine_pose(R, t, X, pixels, f, pp, iters: int = 10):
    """Gauss-Newton on the reprojection error (rotation by left-multiplied
    Rodrigues updates), as the reference's PnP ends with an LM refinement."""
    pp = np.asarray(pp, np.float64)
    for _ in range(iters):
        RX = X @ R.T
        cam = RX + t
        z = cam[:, 2:3]
        if (z <= 1e-9).any():
            break
        r = (f * cam[:, :2] / z + pp - pixels).reshape(-1)
        dp = np.zeros((len(X), 2, 3))
        dp[:, 0, 0] = f / z[:, 0]
        dp[:, 1, 1] = f / z[:, 0]
        dp[:, :, 2] = -f * cam[:, :2] / z ** 2
        dcam_dw = np.zeros((len(X), 3, 3))                   # -skew(RX)
        dcam_dw[:, 0, 1], dcam_dw[:, 0, 2] = RX[:, 2], -RX[:, 1]
        dcam_dw[:, 1, 0], dcam_dw[:, 1, 2] = -RX[:, 2], RX[:, 0]
        dcam_dw[:, 2, 0], dcam_dw[:, 2, 1] = RX[:, 1], -RX[:, 0]
        J = np.concatenate([dp @ dcam_dw, dp], axis=2).reshape(-1, 6)
        delta = np.linalg.lstsq(J, -r, rcond=None)[0]
        w = delta[:3]
        th = np.linalg.norm(w)
        K = _skew(w / th) if th > 0 else np.zeros((3, 3))
        dR = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        R, t = dR @ R, dR @ t + delta[3:]
        if np.abs(delta).max() < 1e-12:
            break
    return R, t


def fast_pnp(pts3d: np.ndarray, focal: Optional[float], msk: np.ndarray,
             pp=None, niter_PnP: int = 10, seed: int = 0):
    """RANSAC-PnP pose recovery (reference init_im_poses.py:442-482).
    Returns (focal, cam2world 4x4) or None."""
    if msk.sum() < 6:
        return None
    H, W, _ = pts3d.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    pixels = np.stack([u, v], axis=-1).astype(np.float64)[msk]
    X = pts3d[msk].astype(np.float64)
    if pp is None:
        pp = (W / 2, H / 2)
    focals = ([focal] if focal is not None
              else np.geomspace(max(W, H) / 2, max(W, H) * 3, 21))
    rng = np.random.default_rng(seed)
    best = (0,)
    for f in focals:
        xn = (pixels - np.asarray(pp, np.float64)) / f
        f_best = (0,)
        # niter_PnP minimal samples, plus one hypothesis fitted to every
        # masked point (a 6-point DLT is ill-conditioned on narrow views)
        samples = [rng.choice(len(X), size=6, replace=False)
                   for _ in range(niter_PnP)] + [np.arange(len(X))]
        for sample in samples:
            pose = _dlt_pose(X[sample], xn[sample])
            if pose is None:
                continue
            R, t = _refine_pose(*pose, X[sample], pixels[sample], f, pp)
            cam = X @ R.T + t
            z = cam[:, 2]
            ok = z > 1e-9
            proj = f * cam[:, :2] / np.where(ok, z, 1.0)[:, None] + np.asarray(pp)
            err = np.linalg.norm(proj - pixels, axis=1)
            inl = ok & (err < 5.0)
            if inl.sum() > f_best[0]:
                f_best = (int(inl.sum()), inl, R, t)
        if f_best[0] >= 6 and f_best[0] > best[0]:
            inl = f_best[1]
            pose = _dlt_pose(X[inl], xn[inl])
            if pose is not None:
                # at a focal near zero every point projects to the principal
                # point whatever the pose, and a DLT can put the camera ~1e27
                # away (an inf loss downstream; cv2's SQPNP stays bounded):
                # take the inliers' refit, else the RANSAC hypothesis, if its
                # translation is bounded; else this focal gives no pose
                refit = _refine_pose(*pose, X[inl], pixels[inl], f, pp)
                for R, t in (refit, f_best[2:]):
                    if np.abs(t).max() <= 1e6 * np.abs(X).max():
                        best = (f_best[0], R, t, f)
                        break
    if not best[0]:
        return None
    _, R, t, f = best
    w2c = _srt_to_4x4(1.0, R, t)
    return float(f), np.linalg.inv(w2c)


def _register(a, b, w):
    R, t, s = rigid_points_registration(torch.from_numpy(a.reshape(-1, 3)),
                                        torch.from_numpy(b.reshape(-1, 3)),
                                        weights=torch.from_numpy(w))
    return R.numpy(), t.numpy(), float(s)


def _apply(T, pts):
    return geotrf(torch.from_numpy(np.asarray(T, np.float32)),
                  torch.from_numpy(np.asarray(pts, np.float32))).numpy()


def edge_score_matrix(data: SceneData, cfg: SceneConfig, conf_i, conf_j):
    """(n, n) matrix of edge scores mean(conf_i) mean(conf_j), NaN off the
    graph (JAX init_poses.py:89-102)."""
    host = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    ei, ej = host(data.ei), host(data.ej)
    E = ei.shape[0]
    scores = host(conf_i).reshape(E, -1).mean(1) * host(conf_j).reshape(E, -1).mean(1)
    m = np.full((cfg.n_imgs, cfg.n_imgs), np.nan)
    for k, (i, j) in enumerate(zip(ei, ej)):
        m[int(i), int(j)] = float(scores[k])
    return m


def save_edge_score_heatmap(path: str, data: SceneData, cfg: SceneConfig,
                            conf_i, conf_j):
    """The edge-score matrix as <path>.npy, and as a heatmap at `path` where
    matplotlib is installed (JAX init_poses.py:105-134)."""
    m = edge_score_matrix(data, cfg, conf_i, conf_j)
    np.save(str(path) + ".npy", m)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return m
    n = cfg.n_imgs
    size = max(4.0, 5.5 * np.log(max(n, 2)) - 2)
    fig, ax = plt.subplots(figsize=(size, size * 0.75))
    im = ax.imshow(m, cmap="viridis")
    fig.colorbar(im, ax=ax)
    if n <= 30:
        for i in range(n):
            for j in range(n):
                if np.isfinite(m[i, j]):
                    ax.text(j, i, f"{m[i, j]:.1f}", ha="center", va="center",
                            fontsize=7, color="w")
    ax.set_title("Heatmap of Edge Scores")
    ax.set_xlabel("Node")
    ax.set_ylabel("Node")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return m


def mst_init(params: Dict, data: SceneData, cfg: SceneConfig,
             conf_i, conf_j, init_priors=None, niter_PnP: int = 10) -> Dict:
    """Initialise pw_poses / im_poses / focals / depthmaps from an MST walk
    over the pairwise graph. conf_i/conf_j: (E, A) raw confidences.
    init_priors: optional (keypose 4x4, keydepth (H, W), [keyfocal])
    anchoring frame 0. Returns updated params (on the params' device)."""
    H, W = cfg.imshape
    A = H * W
    host = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x))
    ei, ej = host(data.ei), host(data.ej)
    edges = [(int(i), int(j)) for i, j in zip(ei, ej)]
    E = len(edges)
    n = cfg.n_imgs
    pred_i = host(data.pred_i).astype(np.float32).reshape(E, H, W, 3)
    pred_j = host(data.pred_j).astype(np.float32).reshape(E, H, W, 3)
    conf_i = host(conf_i).astype(np.float32).reshape(E, A)
    conf_j = host(conf_j).astype(np.float32).reshape(E, A)
    edge_idx = {e: k for k, e in enumerate(edges)}

    scores = conf_i.mean(1) * conf_j.mean(1)
    g = sp.dok_array((n, n))
    for k, (i, j) in enumerate(edges):
        g[i, j] = -float(scores[k])
    msp = sp.csgraph.minimum_spanning_tree(g.tocsr()).tocoo()
    todo = sorted(zip(-msp.data, msp.row, msp.col))

    pts3d: List[Optional[np.ndarray]] = [None] * n
    im_poses: List[Optional[np.ndarray]] = [None] * n
    im_focals: List[Optional[float]] = [None] * n

    if init_priors is None:
        score, i, j = todo.pop()
    else:
        root_idx = next((idx for idx in range(len(todo) - 1, -1, -1)
                         if todo[idx][1] == 0 or todo[idx][2] == 0),
                        len(todo) - 1)
        score, i, j = todo.pop(root_idx)
    k = edge_idx[(i, j)]
    pts3d[i] = pred_i[k].copy()
    pts3d[j] = pred_j[k].copy()
    done = {i, j}
    if init_priors is None:
        im_poses[i] = np.eye(4, dtype=np.float32)
        im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
    else:
        keypose = np.asarray(init_priors[0], np.float32)
        keyfocal = float(np.asarray(init_priors[2]).ravel()[0])
        im_poses[0] = keypose
        im_focals[0] = keyfocal
        if i == 0:
            pts3d[i] = _apply(keypose, pts3d[i])
            pts3d[j] = _apply(keypose, pts3d[j])
        else:
            ji = edge_idx.get((j, i))
            if ji is not None:
                pts3d[i] = _apply(keypose, pred_j[ji])
                pts3d[j] = _apply(keypose, pred_i[ji])
            else:
                pts3d[j] = _apply(keypose, pts3d[j])

    # greedy propagation; `stall` re-seeds an unreachable component
    stall = 0
    while todo:
        score, i, j = todo.pop()
        k = edge_idx[(i, j)]
        if i not in done and j not in done:
            todo.insert(0, (score, i, j))
            stall += 1
            if stall > len(todo):
                score, i, j = todo.pop()
                k = edge_idx[(i, j)]
                pts3d[i] = pred_i[k].copy()
                pts3d[j] = pred_j[k].copy()
                im_poses[i] = np.eye(4, dtype=np.float32)
                if im_focals[i] is None:
                    im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
                done.update((i, j))
                stall = 0
            continue
        stall = 0
        if im_focals[i] is None:
            im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
        if i in done:
            R, t, s = _register(pred_i[k], pts3d[i], conf_i[k])
            pts3d[j] = _apply(_srt_to_4x4(s, R, t), pred_j[k])
            done.add(j)
            if im_poses[i] is None:
                im_poses[i] = _srt_to_4x4(1.0, R, t)
        elif j in done:
            R, t, s = _register(pred_j[k], pts3d[j], conf_j[k])
            pts3d[i] = _apply(_srt_to_4x4(s, R, t), pred_i[k])
            done.add(i)
            if im_poses[i] is None:
                im_poses[i] = _srt_to_4x4(1.0, R, t)

    # leftover focals from the best incident edge; leftover poses via PnP
    order = np.argsort([-s for s in scores])
    for k in order:
        i, _ = edges[k]
        if im_focals[i] is None:
            im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
    im_conf = (host(data.im_conf).reshape(n, A) if data.im_conf is not None
               else np.ones((n, A)))
    for i in range(n):
        if im_poses[i] is None and pts3d[i] is not None:
            msk = (im_conf[i] > cfg.min_conf_thr).reshape(H, W)
            res = fast_pnp(pts3d[i], im_focals[i], msk, niter_PnP=niter_PnP)
            if res:
                im_focals[i], im_poses[i] = res
        if im_poses[i] is None:
            im_poses[i] = np.eye(4, dtype=np.float32)
        if pts3d[i] is None:
            pts3d[i] = np.zeros((H, W, 3), np.float32)
        if im_focals[i] is None:
            im_focals[i] = float(max(H, W))

    return _init_from_pts3d(params, cfg, edges, pred_i, conf_i,
                            np.stack(pts3d), np.stack(im_poses).astype(np.float32),
                            np.array(im_focals))


def _init_from_pts3d(params, cfg, edges, pred_i, conf_i, pts3d, im_poses,
                     im_focals):
    """Set pw_poses / im_poses / focals / depths from the propagated cloud."""
    dev = params["pw_poses"].device
    pw_vecs, log_scales = [], []
    for k, (i, j) in enumerate(edges):
        R, t, s = _register(pred_i[k], pts3d[i], conf_i[k])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        pw_vecs.append(matrix_to_pose_vec(torch.from_numpy(T), scale=s).numpy())
        log_scales.append(np.log(s))
    s_factor = (float(np.exp(np.log(cfg.base_scale) - np.mean(log_scales)))
                if cfg.norm_pw_scale else 1.0)
    im_poses = im_poses.copy()
    im_poses[:, :3, 3] *= s_factor
    pts3d = pts3d * s_factor

    new = dict(params)
    new["pw_poses"] = torch.from_numpy(np.stack(pw_vecs)).float().to(dev)
    new["im_poses"] = matrix_to_pose_vec(torch.from_numpy(im_poses)).float().to(dev)
    new = set_focal(new, cfg, np.arange(cfg.n_imgs), im_focals)
    if not cfg.if_use_mono:
        cams = np.stack([np.linalg.inv(p) for p in im_poses]).astype(np.float32)
        depth = _apply(cams, pts3d.astype(np.float32))[..., 2]
        new = set_depthmap(new, np.arange(cfg.n_imgs), depth.reshape(cfg.n_imgs, -1))
    return new
