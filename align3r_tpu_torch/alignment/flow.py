"""Flow-variant alignment loss (port of align3r_tpu/alignment/flow.py).

loss = pairwise pts3d L1
     + temporal_smoothing_weight * sum relative-pose-error(consecutive frames)
     + flow_loss_weight * smooth-L1(ego-motion flow vs RAFT flow, static
       pixels), from step flow_loss_start_epoch * num_total_iter on, and
       zero on any step where it exceeds flow_loss_thre
     + depth_regularize_weight * scale-invariant log-depth term to the init
       depth, with the dynamic masks as pixel weights (dynamic pixels 2,
       static 1).

The start-epoch gate compares host integers, so the flow term is skipped
before it opens (JAX computes it and multiplies by zero: the same loss and
gradients). The per-step threshold gate is a torch.where on the value, as in
JAX, so the solve never waits on the device for it.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.alignment.scene import (SceneConfig, SceneData,
                                               get_depthmaps_raw, get_im_poses,
                                               get_intrinsics, pairwise_pts_loss)
from align3r_tpu_torch.geometry.poses import relative_pose_error
from align3r_tpu_torch.geometry.warping import (depth_regularization_si_weighted,
                                                smooth_l1_flow_loss, warp_by_disp)


def inv_intrinsics(K):
    """Closed-form inverse of pinhole K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([1 / fx, z, -cx / fx], -1),
                        torch.stack([z, 1 / fy, -cy / fy], -1),
                        torch.stack([z, z, o], -1)], -2)


def flow_term(params, data: SceneData, cfg: SceneConfig):
    """The smooth-L1 ego-flow term before its gates and weight."""
    H, W = cfg.imshape
    poses = get_im_poses(params)
    R_all, T_all = poses[:, :3, :3], poses[:, :3, 3:]
    K_all = get_intrinsics(params, data, cfg)
    inv_K_all = inv_intrinsics(K_all)
    ei, ej = data.ei, data.ej
    depth = get_depthmaps_raw(params, data, cfg).reshape(cfg.n_imgs, H, W)
    disp = 1.0 / (depth + 1e-6)
    ego_12 = warp_by_disp(R_all[ei], T_all[ei], R_all[ej], T_all[ej],
                          K_all[ej], inv_K_all[ei], disp[ei])
    ego_21 = warp_by_disp(R_all[ej], T_all[ej], R_all[ei], T_all[ei],
                          K_all[ei], inv_K_all[ej], disp[ej])
    if data.dynamic_masks is not None:
        static_i = 1.0 - data.dynamic_masks[ei]
        static_j = 1.0 - data.dynamic_masks[ej]
    else:
        static_i = static_j = torch.ones((ei.shape[0], H, W), device=depth.device)
    return (smooth_l1_flow_loss(ego_12[..., :2], data.flow_ij, static_i,
                                per_pixel_thre=cfg.pxl_thre)
            + smooth_l1_flow_loss(ego_21[..., :2], data.flow_ji, static_j,
                                  per_pixel_thre=cfg.pxl_thre))


def flow_forward(params, data: SceneData, cfg: SceneConfig, step=0):
    loss = pairwise_pts_loss(params, data, cfg, step)
    H, W = cfg.imshape
    if cfg.temporal_smoothing_weight > 0:
        poses = get_im_poses(params)
        smooth = relative_pose_error(poses[:-1], poses[1:],
                                     cfg.translation_weight).sum()
        loss = loss + cfg.temporal_smoothing_weight * smooth

    if (cfg.flow_loss_weight > 0 and data.flow_ij is not None
            and step >= cfg.flow_loss_start_epoch * cfg.num_total_iter):
        fl = flow_term(params, data, cfg)
        if cfg.flow_loss_thre > 0:
            fl = torch.where(fl <= cfg.flow_loss_thre, fl, torch.zeros_like(fl))
        loss = loss + cfg.flow_loss_weight * fl

    if cfg.depth_regularize_weight > 0 and data.init_depth is not None:
        depth = get_depthmaps_raw(params, data, cfg).reshape(cfg.n_imgs, H, W)
        init = data.init_depth.reshape(cfg.n_imgs, H, W)
        loss = loss + cfg.depth_regularize_weight * depth_regularization_si_weighted(
            depth, init, pixel_wise_weight=data.dynamic_masks)
    return loss
