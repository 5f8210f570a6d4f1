"""PairViewer (closed-form two-frame solve) and self-supervised motion masks
(port of align3r_tpu/alignment/pair_viewer.py).

PairViewer: for a symmetric pair, each camera's focal by Weiszfeld on its
own pointmap, the relative pose by RANSAC-PnP of the cross-view pointmap,
and the parameterisation of the more confident direction. Motion masks: per
symmetric pair, the RAFT flow against the ego-motion flow of the PairViewer
depths and poses; each pair's error map is min-max normalised, averaged per
frame and thresholded.

Everything runs batched on the flows' device: the Weiszfeld focals of every
pair in one call, the two PnPs of every pair in one `ransac_pnp` call, the
depths, ego-motion flows and error maps.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from align3r_tpu_torch.alignment.init_poses import estimate_focals_weiszfeld
from align3r_tpu_torch.alignment.pnp import ransac_pnp
from align3r_tpu_torch.geometry.core import geotrf, xy_grid
from align3r_tpu_torch.geometry.warping import warp_by_disp


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _solve_pairs(p1f, p1r, p2f, p2r, c1f, c1r, c2f, c2r, min_conf_thr, niter_PnP):
    """PairViewer on P symmetric pairs at once, on the pointmaps' device.
    For pair k: p1f / p1r are pred_i[(0, 1)] / pred_i[(1, 0)], p2f / p2r
    pred_j[(0, 1)] / pred_j[(1, 0)] (P, H, W, 3), c.. the confidences alike
    (P, H, W). Returns poses (P, 2, 4, 4) cam2world, focals (P, 2), pp (2,)
    and depths (P, 2, H, W)."""
    P, H, W, _ = p1f.shape
    dev = p1f.device
    pp = torch.tensor([W / 2, H / 2], dtype=torch.float32, device=dev)
    masks = torch.cat([torch.maximum(c1f, c2r), torch.maximum(c1r, c2f)]) > min_conf_thr
    confs = (c1f.mean((1, 2)) * c2f.mean((1, 2)), c1r.mean((1, 2)) * c2r.mean((1, 2)))
    focals = estimate_focals_weiszfeld(torch.cat([p1f, p1r]))                # (2P,)
    # pose of camera i from its points expressed in camera (1 - i)
    res = ransac_pnp(torch.cat([p2r, p2f]).reshape(2 * P, H * W, 3),
                     xy_grid(W, H, device=dev).reshape(-1, 2), masks.reshape(2 * P, -1),
                     focals[:, None], (W / 2, H / 2), niter_PnP)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    rel = torch.stack([torch.as_tensor(r[1], dtype=torch.float32, device=dev) if r else eye
                       for r in res]).reshape(2, P, 4, 4)
    first = (confs[0] > confs[1])[:, None, None]
    poses = torch.stack([torch.where(first, eye, rel[0]), torch.where(first, rel[1], eye)], 1)
    depth_in = lambda pose, pts: geotrf(torch.linalg.inv(pose), pts)[..., 2]
    d0 = torch.where(first, p1f[..., 2], depth_in(rel[0], p2r))
    d1 = torch.where(first, depth_in(rel[1], p2f), p1r[..., 2])
    return poses, focals.reshape(2, P).T, pp, torch.stack([d0, d1], 1)


def pair_viewer(pred_i: Dict[Tuple[int, int], np.ndarray],
                pred_j: Dict[Tuple[int, int], np.ndarray],
                conf_i: Dict[Tuple[int, int], np.ndarray],
                conf_j: Dict[Tuple[int, int], np.ndarray],
                min_conf_thr: float = 3.0, niter_PnP: int = 100):
    """Closed-form solve of the symmetric pair {(0, 1), (1, 0)}; dicts keyed
    by edge. Returns 'poses' (2, 4, 4) cam2world, 'focals' (2,), 'pp'
    (2, 2), 'depths' (2, H, W)."""
    t = lambda d, e: torch.as_tensor(d[e]).float()[None]
    poses, focals, pp, depths = _solve_pairs(
        t(pred_i, (0, 1)), t(pred_i, (1, 0)), t(pred_j, (0, 1)), t(pred_j, (1, 0)),
        t(conf_i, (0, 1)), t(conf_i, (1, 0)), t(conf_j, (0, 1)), t(conf_j, (1, 0)),
        min_conf_thr, niter_PnP)
    return {"poses": _host(poses[0]), "focals": _host(focals[0]),
            "pp": _host(torch.stack([pp, pp])), "depths": _host(depths[0])}


def motion_masks_from_pairs(output: Dict, flow_ij, flow_ji,
                            motion_mask_thre: float = 0.35,
                            min_conf_thr: float = 3.0) -> np.ndarray:
    """Self-supervised dynamic masks. output: the symmetrised engine dict
    (edges [forward..., reversed...]); flow_ij / flow_ji (E, H, W, 2).
    Returns (n_imgs, H, W) bool, True = dynamic."""
    flow_ij, flow_ji = torch.as_tensor(flow_ij), torch.as_tensor(flow_ji)
    dev = flow_ij.device
    idx_i = _host(output["view1"]["idx"]).astype(np.int64)
    idx_j = _host(output["view2"]["idx"]).astype(np.int64)
    on = lambda x: torch.as_tensor(x).to(dev).float()
    pred1, pred2 = on(output["pred1"]["pts3d"]), on(output["pred2"]["pts3d_in_other_view"])
    conf1, conf2 = on(output["pred1"]["conf"]), on(output["pred2"]["conf"])
    E, H, W, _ = pred1.shape
    if E % 2:
        raise ValueError("motion masks need a symmetrised graph")
    half = E // 2
    n_imgs = int(max(idx_i.max(), idx_j.max())) + 1
    if ((idx_i[half:] != idx_j[:half]) | (idx_j[half:] != idx_i[:half])).any():
        raise ValueError("edge ordering must be [forward..., reversed...]")

    f, r = slice(0, half), slice(half, E)
    poses, focals, pp, depths = _solve_pairs(pred1[f], pred1[r], pred2[f], pred2[r],
                                             conf1[f], conf1[r], conf2[f], conf2[r],
                                             min_conf_thr, 100)
    K = torch.zeros((2, half, 3, 3), dtype=torch.float32, device=dev)
    K[..., 0, 0] = K[..., 1, 1] = focals.T
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = pp[0], pp[1], 1.0
    R, T = poses[:, :, :3, :3].transpose(0, 1), poses[:, :, :3, 3:].transpose(0, 1)
    D = depths.transpose(0, 1)

    ego_12 = warp_by_disp(R[0], T[0], R[1], T[1], K[1], torch.linalg.inv(K[0]),
                          1.0 / (D[0] + 1e-6))
    ego_21 = warp_by_disp(R[1], T[1], R[0], T[0], K[0], torch.linalg.inv(K[1]),
                          1.0 / (D[1] + 1e-6))
    err_i = torch.linalg.vector_norm(ego_12[..., :2] - flow_ij[:half], dim=-1)
    err_j = torch.linalg.vector_norm(ego_21[..., :2] - flow_ji[:half], dim=-1)

    def norm01(err):
        mn = err.amin(dim=(1, 2), keepdim=True)
        mx = err.amax(dim=(1, 2), keepdim=True)
        return (err - mn) / torch.clamp(mx - mn, min=1e-12)

    ids_i = torch.from_numpy(idx_i[:half]).to(dev)
    ids_j = torch.from_numpy(idx_j[:half]).to(dev)
    total = torch.zeros((n_imgs, H, W), device=dev)
    total.index_add_(0, ids_i, norm01(err_i)).index_add_(0, ids_j, norm01(err_j))
    count = torch.bincount(torch.cat([ids_i, ids_j]), minlength=n_imgs)
    mean = total / torch.clamp(count, min=1)[:, None, None]
    return _host((mean > motion_mask_thre) & (count > 0)[:, None, None])
