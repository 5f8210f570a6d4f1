"""PairViewer (closed-form two-frame solve) and self-supervised motion masks
(port of align3r_tpu/alignment/pair_viewer.py).

PairViewer: for a symmetric pair, each camera's focal by Weiszfeld on its
own pointmap, the relative pose by RANSAC-PnP of the cross-view pointmap
(the port's numpy fast_pnp), and the parameterisation of the more confident
direction. Motion masks: per symmetric pair, the RAFT flow against the
ego-motion flow of the PairViewer depths and poses; each pair's error map is
min-max normalised, averaged per frame and thresholded.

The per-pair solves run on the host (numpy PnP); the ego-motion flows and
error maps of all pairs run batched on the flows' device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from align3r_tpu_torch.alignment.init_poses import estimate_focal_weiszfeld, fast_pnp
from align3r_tpu_torch.geometry.core import geotrf
from align3r_tpu_torch.geometry.warping import warp_by_disp


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _depth_in(pose, pts):
    """z of pts (H, W, 3) seen from the camera whose cam2world is `pose`."""
    return geotrf(torch.from_numpy(np.linalg.inv(pose)),
                  torch.from_numpy(np.asarray(pts, np.float32)))[..., 2].numpy()


def pair_viewer(pred_i: Dict[Tuple[int, int], np.ndarray],
                pred_j: Dict[Tuple[int, int], np.ndarray],
                conf_i: Dict[Tuple[int, int], np.ndarray],
                conf_j: Dict[Tuple[int, int], np.ndarray],
                min_conf_thr: float = 3.0, niter_PnP: int = 100):
    """Closed-form solve of the symmetric pair {(0, 1), (1, 0)}; dicts keyed
    by edge. Returns 'poses' (2, 4, 4) cam2world, 'focals' (2,), 'pp'
    (2, 2), 'depths' (2, H, W)."""
    H, W = pred_i[(0, 1)].shape[:2]
    pp = np.array([W / 2, H / 2], np.float32)
    im_conf = [np.maximum(conf_i[(0, 1)], conf_j[(1, 0)]),
               np.maximum(conf_i[(1, 0)], conf_j[(0, 1)])]
    focals, rel_poses, confs = [], [], []
    for i in range(2):
        e = (i, 1 - i)
        confs.append(float(conf_i[e].mean() * conf_j[e].mean()))
        focal = estimate_focal_weiszfeld(pred_i[e])
        focals.append(focal)
        # pose of camera i from its points expressed in camera (1 - i)
        res = fast_pnp(np.asarray(pred_j[(1 - i, i)], np.float32), focal,
                       im_conf[i] > min_conf_thr, pp=pp, niter_PnP=niter_PnP)
        rel_poses.append(res[1].astype(np.float32) if res else np.eye(4, dtype=np.float32))
    eye = np.eye(4, dtype=np.float32)
    if confs[0] > confs[1]:
        poses = np.stack([eye, rel_poses[1]])
        d0 = np.asarray(pred_i[(0, 1)])[..., 2]
        d1 = _depth_in(rel_poses[1], pred_j[(0, 1)])
    else:
        poses = np.stack([rel_poses[0], eye])
        d0 = _depth_in(rel_poses[0], pred_j[(1, 0)])
        d1 = np.asarray(pred_i[(1, 0)])[..., 2]
    return {"poses": poses, "focals": np.array(focals, np.float32),
            "pp": np.stack([pp, pp]), "depths": np.stack([d0, d1])}


def motion_masks_from_pairs(output: Dict, flow_ij, flow_ji,
                            motion_mask_thre: float = 0.35,
                            min_conf_thr: float = 3.0) -> np.ndarray:
    """Self-supervised dynamic masks. output: the symmetrised engine dict
    (edges [forward..., reversed...]); flow_ij / flow_ji (E, H, W, 2).
    Returns (n_imgs, H, W) bool, True = dynamic."""
    idx_i = _host(output["view1"]["idx"]).astype(np.int64)
    idx_j = _host(output["view2"]["idx"]).astype(np.int64)
    pred1 = _host(output["pred1"]["pts3d"]).astype(np.float32)
    pred2 = _host(output["pred2"]["pts3d_in_other_view"]).astype(np.float32)
    conf1 = _host(output["pred1"]["conf"]).astype(np.float32)
    conf2 = _host(output["pred2"]["conf"]).astype(np.float32)
    E, H, W, _ = pred1.shape
    if E % 2:
        raise ValueError("motion masks need a symmetrised graph")
    half = E // 2
    n_imgs = int(max(idx_i.max(), idx_j.max())) + 1

    K, R, T, D = ([[], []] for _ in range(4))
    for e in range(half):
        er = e + half
        if idx_i[er] != idx_j[e] or idx_j[er] != idx_i[e]:
            raise ValueError("edge ordering must be [forward..., reversed...]")
        pv = pair_viewer({(0, 1): pred1[e], (1, 0): pred1[er]},
                         {(0, 1): pred2[e], (1, 0): pred2[er]},
                         {(0, 1): conf1[e], (1, 0): conf1[er]},
                         {(0, 1): conf2[e], (1, 0): conf2[er]}, min_conf_thr)
        for k in range(2):
            f, pp = pv["focals"][k], pv["pp"][k]
            K[k].append(np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1]], np.float32))
            R[k].append(pv["poses"][k, :3, :3])
            T[k].append(pv["poses"][k, :3, 3:])
            D[k].append(pv["depths"][k])

    flow_ij, flow_ji = torch.as_tensor(flow_ij), torch.as_tensor(flow_ji)
    dev = flow_ij.device
    K, R, T, D = ([torch.from_numpy(np.stack(a).astype(np.float32)).to(dev) for a in x]
                  for x in (K, R, T, D))
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
