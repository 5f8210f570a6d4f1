"""MST initialisation for the global aligner (port of
align3r_tpu/alignment/init_poses.py).

The graph walk (scipy minimum spanning tree + greedy propagation) runs on the
host in numpy; the per-edge rigid registrations, the Weiszfeld focals and the
point transforms are torch on the scene's device, as the JAX package's are
jnp. The frames the walk leaves without a pose go into one batched
RANSAC-PnP on that device (`alignment.pnp.ransac_pnp`), the computation of
the JAX package's cv2.solvePnPRansac(SQPNP); `fast_pnp` is its one-problem
call.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401  (registers sp.csgraph)
import torch

from align3r_tpu_torch.alignment.pnp import MIN_PNP_POINTS, ransac_pnp
from align3r_tpu_torch.alignment.scene import (SceneConfig, SceneData,
                                               set_depthmap, set_focal)
from align3r_tpu_torch.geometry.core import geotrf, xy_grid
from align3r_tpu_torch.geometry.poses import (matrix_to_pose_vec,
                                              rigid_points_registration)


def estimate_focals_weiszfeld(pts3d, pp=None, min_focal: float = 0.0,
                              max_focal: float = np.inf, n_iter: int = 10):
    """Weiszfeld focals of camera-frame pointmaps (..., H, W, 3), batched on
    their device: a float32 tensor of the leading shape."""
    pts3d = torch.as_tensor(pts3d).float()
    if pts3d.ndim < 3:
        raise ValueError("need (H, W, 3) to build the pixel grid")
    H, W = pts3d.shape[-3:-1]
    pts = pts3d.reshape(*pts3d.shape[:-3], H * W, 3)
    if pp is None:
        pp = torch.tensor([W / 2, H / 2], dtype=torch.float32)
    pixels = (xy_grid(W, H, device=pts.device).reshape(-1, 2)
              - torch.as_tensor(pp, dtype=torch.float32, device=pts.device))
    z = pts[..., 2:3]
    xy_over_z = pts[..., :2] / torch.clamp(torch.abs(z), min=1e-8) * torch.sign(z)
    xy_over_z = torch.nan_to_num(xy_over_z, posinf=0.0, neginf=0.0)
    dot_xy_px = (xy_over_z * pixels).sum(-1)
    dot_xy_xy = (xy_over_z ** 2).sum(-1)
    focal = dot_xy_px.mean(-1) / torch.clamp(dot_xy_xy.mean(-1), min=1e-12)
    for _ in range(n_iter):
        dis = torch.linalg.vector_norm(pixels - focal[..., None, None] * xy_over_z, dim=-1)
        w = 1.0 / torch.clamp(dis, min=1e-8)
        focal = (w * dot_xy_px).mean(-1) / torch.clamp((w * dot_xy_xy).mean(-1), min=1e-12)
    base = max(H, W) / (2 * np.tan(np.deg2rad(60) / 2))
    lo = max(min_focal * base, 1e-4)
    return torch.clamp(focal, lo, max_focal * base)


def estimate_focal_weiszfeld(pts3d, pp=None, min_focal: float = 0.0,
                             max_focal: float = np.inf, n_iter: int = 10):
    """Weiszfeld focal from a camera-frame pointmap (H, W, 3)."""
    if torch.as_tensor(pts3d).ndim != 3:
        raise ValueError("need (H, W, 3) to build the pixel grid")
    return float(estimate_focals_weiszfeld(pts3d, pp, min_focal, max_focal, n_iter))


def _srt_to_4x4(s, R, t):
    T = torch.eye(4, dtype=torch.float32, device=R.device)
    T[:3, :3] = R * s
    T[:3, 3] = t.reshape(-1)
    return T


def _focal_sweep(W: int, H: int) -> np.ndarray:
    """The focals the JAX package tries for a view without one."""
    return np.geomspace(max(W, H) / 2, max(W, H) * 3, 21)


def fast_pnp(pts3d, focal: Optional[float], msk, pp=None, niter_PnP: int = 10):
    """RANSAC-PnP pose recovery (reference init_im_poses.py:442-482) on the
    device of pts3d (H, W, 3): the one-problem call of `ransac_pnp`. Without a
    focal it sweeps `_focal_sweep`, as the JAX package does. Returns (focal,
    cam2world 4x4 float32 numpy) or None."""
    pts3d = torch.as_tensor(pts3d)
    H, W, _ = pts3d.shape
    msk = torch.as_tensor(np.asarray(msk), device=pts3d.device).reshape(1, -1)
    if int(msk.sum()) < MIN_PNP_POINTS:
        return None
    focals = [focal] if focal is not None else _focal_sweep(W, H)
    res = ransac_pnp(pts3d.reshape(1, -1, 3), xy_grid(W, H, device=pts3d.device).reshape(-1, 2),
                     msk, [focals], (W / 2, H / 2) if pp is None else pp, niter_PnP)[0]
    if res is None:
        return None
    # the JAX package's float32 world-to-camera matrix, inverted
    w2c = np.linalg.inv(res[1].cpu().numpy()).astype(np.float32)
    w2c[3] = (0, 0, 0, 1)
    return res[0], np.linalg.inv(w2c)


def _register(a, b, w):
    return rigid_points_registration(a.reshape(-1, 3), b.reshape(-1, 3), weights=w)


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
    anchoring frame 0. The registrations and focals run on data's device;
    the frames left without a pose take one batched RANSAC-PnP there.
    Returns updated params (on the params' device)."""
    H, W = cfg.imshape
    A = H * W
    dev = data.pred_i.device if torch.is_tensor(data.pred_i) else torch.device("cpu")
    on = lambda x: torch.as_tensor(x, device=dev).float()
    host = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x))
    ei, ej = host(data.ei), host(data.ej)
    edges = [(int(i), int(j)) for i, j in zip(ei, ej)]
    E = len(edges)
    n = cfg.n_imgs
    pred_i = on(data.pred_i).reshape(E, H, W, 3)
    pred_j = on(data.pred_j).reshape(E, H, W, 3)
    conf_i = on(conf_i).reshape(E, A)
    conf_j = on(conf_j).reshape(E, A)
    edge_idx = {e: k for k, e in enumerate(edges)}

    scores = (conf_i.mean(1) * conf_j.mean(1)).cpu().numpy()
    g = sp.dok_array((n, n))
    for k, (i, j) in enumerate(edges):
        g[i, j] = -float(scores[k])
    msp = sp.csgraph.minimum_spanning_tree(g.tocsr()).tocoo()
    todo = sorted(zip(-msp.data, msp.row, msp.col))

    pts3d: List[Optional[torch.Tensor]] = [None] * n
    im_poses: List[Optional[torch.Tensor]] = [None] * n
    im_focals: List[Optional[float]] = [None] * n
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    if init_priors is None:
        score, i, j = todo.pop()
    else:
        root_idx = next((idx for idx in range(len(todo) - 1, -1, -1)
                         if todo[idx][1] == 0 or todo[idx][2] == 0),
                        len(todo) - 1)
        score, i, j = todo.pop(root_idx)
    k = edge_idx[(i, j)]
    pts3d[i] = pred_i[k].clone()
    pts3d[j] = pred_j[k].clone()
    done = {i, j}
    if init_priors is None:
        im_poses[i] = eye
        im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
    else:
        keypose = on(init_priors[0])
        keyfocal = float(np.asarray(host(init_priors[2])).ravel()[0])
        im_poses[0] = keypose
        im_focals[0] = keyfocal
        if i == 0:
            pts3d[i] = geotrf(keypose, pts3d[i])
            pts3d[j] = geotrf(keypose, pts3d[j])
        else:
            ji = edge_idx.get((j, i))
            if ji is not None:
                pts3d[i] = geotrf(keypose, pred_j[ji])
                pts3d[j] = geotrf(keypose, pred_i[ji])
            else:
                pts3d[j] = geotrf(keypose, pts3d[j])

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
                pts3d[i] = pred_i[k].clone()
                pts3d[j] = pred_j[k].clone()
                im_poses[i] = eye
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
            pts3d[j] = geotrf(_srt_to_4x4(s, R, t), pred_j[k])
            done.add(j)
            if im_poses[i] is None:
                im_poses[i] = _srt_to_4x4(1.0, R, t)
        elif j in done:
            R, t, s = _register(pred_j[k], pts3d[j], conf_j[k])
            pts3d[i] = geotrf(_srt_to_4x4(s, R, t), pred_i[k])
            done.add(i)
            if im_poses[i] is None:
                im_poses[i] = _srt_to_4x4(1.0, R, t)

    # leftover focals from the best incident edge; leftover poses by one
    # batched PnP over every frame without a pose, sweeping the focal of a
    # frame that is no edge's first view (a graph that is not symmetrised)
    order = np.argsort([-s for s in scores])
    for k in order:
        i, _ = edges[k]
        if im_focals[i] is None:
            im_focals[i] = estimate_focal_weiszfeld(pred_i[k])
    im_conf = (on(data.im_conf).reshape(n, A) if data.im_conf is not None
               else torch.ones((n, A), device=dev))
    need = [i for i in range(n) if im_poses[i] is None and pts3d[i] is not None]
    if need:
        res = ransac_pnp(torch.stack([pts3d[i] for i in need]).reshape(len(need), A, 3),
                         xy_grid(W, H, device=dev).reshape(-1, 2),
                         im_conf[need] > cfg.min_conf_thr,
                         [_focal_sweep(W, H) if im_focals[i] is None else [im_focals[i]]
                          for i in need], (W / 2, H / 2), niter_PnP)
        for i, r in zip(need, res):
            if r:
                im_focals[i], im_poses[i] = r[0], r[1].float()
    for i in range(n):
        if im_poses[i] is None:
            im_poses[i] = eye
        if pts3d[i] is None:
            pts3d[i] = torch.zeros((H, W, 3), device=dev)
        if im_focals[i] is None:
            im_focals[i] = float(max(H, W))

    return _init_from_pts3d(params, cfg, edges, pred_i, conf_i,
                            torch.stack(pts3d), torch.stack(im_poses), np.array(im_focals))


def _init_from_pts3d(params, cfg, edges, pred_i, conf_i, pts3d, im_poses,
                     im_focals):
    """Set pw_poses / im_poses / focals / depths from the propagated cloud;
    pred_i, conf_i, pts3d and im_poses are tensors on the scene's device."""
    dev = params["pw_poses"].device
    pw_vecs, scales = [], []
    for k, (i, j) in enumerate(edges):
        R, t, s = _register(pred_i[k], pts3d[i], conf_i[k])
        T = torch.eye(4, dtype=torch.float32, device=R.device)
        T[:3, :3] = R
        T[:3, 3] = t
        pw_vecs.append(matrix_to_pose_vec(T, scale=s))
        scales.append(s)
    # the scale factor and the n 4x4 inverses in float64 / numpy on the host,
    # as the JAX package forms them: the log-depths of points near a camera
    # amplify their rounding
    log_scales = np.log(torch.stack(scales).cpu().numpy().astype(np.float64))
    s_factor = (float(np.exp(np.log(cfg.base_scale) - np.mean(log_scales)))
                if cfg.norm_pw_scale else 1.0)
    im_poses = im_poses.clone()
    im_poses[:, :3, 3] *= s_factor
    pts3d = pts3d * s_factor

    new = dict(params)
    new["pw_poses"] = torch.stack(pw_vecs).float().to(dev)
    new["im_poses"] = matrix_to_pose_vec(im_poses).float().to(dev)
    new = set_focal(new, cfg, np.arange(cfg.n_imgs), im_focals)
    if not cfg.if_use_mono:
        cams = torch.from_numpy(np.linalg.inv(im_poses.cpu().numpy())).to(pts3d.device)
        depth = geotrf(cams, pts3d)[..., 2]
        new = set_depthmap(new, np.arange(cfg.n_imgs), depth.reshape(cfg.n_imgs, -1))
    return new
