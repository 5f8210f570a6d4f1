"""Cross-view point-cloud cleaning (port of align3r_tpu/alignment/clean.py).

For every ordered view pair (i, j), view i's 3D points are projected into
camera j; points that land in front of view j's depth map (by tolerance)
while being LESS confident than view j's pixel get their confidence clamped
to `bad_conf` (reference dust3r/cloud_opt/base_opt.py clean_pointcloud:
467-503). Torch on the inputs' device, in the JAX loop's order: views i in
turn, each against every other view j, both sides reading the evolving
confidences.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.geometry.core import closed_form_pose_inverse, geotrf


@torch.no_grad()
def clean_pointcloud(im_confs, K, cams_world2cam, depthmaps, all_pts3d,
                     tol: float = 0.001, bad_conf: float = 0.0):
    """im_confs: (n, H, W); K: (n, 3, 3); cams_world2cam: (n, 4, 4);
    depthmaps: (n, H, W); all_pts3d: (n, H, W, 3) world frame.
    Returns cleaned confidences (n, H, W)."""
    n, H, W = im_confs.shape
    res = im_confs.clone()
    for i in range(n):
        conf_i = res[i]
        for j in range(n):
            if j == i:
                continue
            proj = geotrf(cams_world2cam[j], all_pts3d[i])       # (H, W, 3) in cam j
            z = proj[..., 2]
            uvw = torch.einsum("ab,hwb->hwa", K[j], proj)
            den = torch.clamp(uvw[..., 2], min=1e-9)
            ui = torch.round(uvw[..., 0] / den).to(torch.int64)
            vi = torch.round(uvw[..., 1] / den).to(torch.int64)
            msk = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            uc, vc = ui.clamp(0, W - 1), vi.clamp(0, H - 1)
            depth_j = depthmaps[j][vc, uc]
            conf_j = res[j][vc, uc]
            bad = msk & (z < (1 - tol) * depth_j) & (conf_i < conf_j)
            conf_i = torch.where(bad, torch.clamp(conf_i, max=bad_conf), conf_i)
        res[i] = conf_i
    return res


def scene_clean_pointcloud(scene, tol: float = 0.001, bad_conf: float = 0.0):
    """Apply to the port's SceneResult on its device; returns the cleaned
    (n, H, W) confidences as numpy."""
    dev = scene.data.im_conf.device
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    cams = closed_form_pose_inverse(t(scene.get_im_poses()))
    out = clean_pointcloud(t(scene.get_conf()), t(scene.get_intrinsics()), cams,
                           t(scene.get_depthmaps()), t(scene.get_pts3d()),
                           tol=tol, bad_conf=bad_conf)
    return out.cpu().numpy()
