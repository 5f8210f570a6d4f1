"""Depth-based warping, flow-consistency masks and image warping (port of
align3r_tpu/geometry/warping.py).

Plain functions on tensors with the JAX package's layouts: images and flows
are (B, H, W, C) with flow channels (dx, dy), rotations (B, 3, 3),
translations (B, 3, 1). Sampling is torch grid_sample's align_corners=True
with zero padding, written out as four gathers as the JAX function does.
"""
from __future__ import annotations

import torch


def bilinear_sample(img, x, y):
    """Sample img (B, H, W, C) at float pixel coords x, y (B, H', W'):
    out-of-bounds taps contribute zero."""
    B, H, W, C = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(B, H * W, C)
    out = 0.0
    for yy in (y0, y0 + 1):
        for xx in (x0, x0 + 1):
            wgt = (1 - torch.abs(x - xx)) * (1 - torch.abs(y - yy))
            inb = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
            xi = torch.clamp(xx, 0, W - 1).long()
            yi = torch.clamp(yy, 0, H - 1).long()
            lin = (yi * W + xi).reshape(B, -1, 1).expand(B, -1, C)
            gathered = torch.gather(flat, 1, lin).reshape(x.shape + (C,))
            out = out + gathered * (wgt * inb)[..., None]
    return out


def base_grid(H: int, W: int, batch=None, dtype=torch.float32, device=None):
    """(H, W, 2) pixel grid (x, y), optionally broadcast to (batch, H, W, 2)."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    g = torch.stack([xx, yy], dim=-1)
    return g if batch is None else g[None].expand(batch, H, W, 2)


def warp_image(img, flow_2_1):
    """Backward warp: out[p] = img[p + flow_2_1[p]]. img (B, H, W, C);
    flow_2_1 (B, H, W, 2)."""
    B, H, W, _ = flow_2_1.shape
    g = base_grid(H, W, B, device=flow_2_1.device) + flow_2_1
    return bilinear_sample(img, g[..., 0], g[..., 1])


def occ_mask(flow_1_2, flow_2_1, th: float = 3.0):
    """Forward-backward consistency: (B, H, W) bool, True = not occluded."""
    B, H, W, _ = flow_1_2.shape
    target = base_grid(H, W, B, device=flow_1_2.device) + flow_1_2
    oob = ((target[..., 0] < 0) | (target[..., 0] > W - 1)
           | (target[..., 1] < 0) | (target[..., 1] > H - 1))
    sampled = bilinear_sample(flow_2_1, target[..., 0], target[..., 1])
    inconsistency = torch.abs((sampled + flow_1_2).sum(-1))
    return (inconsistency < th) & ~oob


def _homogeneous_coords(H: int, W: int, device):
    """(3, H*W) rows x, y, 1."""
    g = base_grid(H, W, device=device).reshape(-1, 2)
    return torch.cat([g, torch.ones_like(g[:, :1])], dim=-1).T


def get_relative_transform(src_R, src_t, tgt_R, tgt_t):
    tR = tgt_R.transpose(1, 2)
    return tR @ src_R, tR @ (src_t - tgt_t)


def warp_by_disp(src_R, src_t, tgt_R, tgt_t, K, inv_K, src_disp):
    """Ego-motion flow from disparity and relative pose (use_depth=False).
    src_R/tgt_R (B, 3, 3); src_t/tgt_t (B, 3, 1); K/inv_K (B, 3, 3);
    src_disp (B, H, W). Returns (B, H, W, 3): (dx, dy, dnorm)."""
    B, H, W = src_disp.shape
    coord = _homogeneous_coords(H, W, src_disp.device)
    rel_R, rel_t = get_relative_transform(src_R, src_t, tgt_R, tgt_t)
    H_mat = K @ rel_R @ inv_K
    tgt = H_mat @ coord[None] + src_disp.reshape(B, 1, H * W) * (K @ rel_t)
    tgt = tgt / (tgt[:, -1:, :] + 1e-6)
    return (tgt - coord[None]).reshape(B, 3, H, W).permute(0, 2, 3, 1)


def unproject_depth_RT(depth, inv_K, R, t):
    """(B, H, W) depth -> world xyz (B, H, W, 3): R K^-1 u d + t."""
    B, H, W = depth.shape
    coord = _homogeneous_coords(H, W, depth.device)
    xyz = depth.reshape(B, 1, H * W) * (R @ inv_K @ coord[None]) + t
    return xyz.reshape(B, 3, H, W).permute(0, 2, 3, 1)


def smooth_l1_flow_loss(estimate, gt, mask, beta: float = 1.0,
                        per_pixel_thre: float = 50.0):
    """Masked smooth-L1 with per-pixel outlier gating. estimate/gt
    (..., 2); mask (...) broadcast over the channel dim."""
    m = mask.to(estimate.dtype)[..., None]
    diff = estimate * m - gt * m
    a = torch.abs(diff)
    raw = torch.where(a < beta, 0.5 * diff * diff / beta, a - 0.5 * beta)
    pm = (raw < per_pixel_thre) * m if per_pixel_thre > 0 else m
    return (raw * pm).sum() / torch.clamp(pm.sum(), min=1.0)


def depth_regularization_si_weighted(depth_pred, depth_init,
                                     pixel_wise_weight=None,
                                     pixel_wise_weight_scale: float = 1.0,
                                     pixel_wise_weight_bias: float = 1.0,
                                     eps: float = 1e-6,
                                     pixel_weight_normalize: bool = False):
    """Scale-invariant log-depth regularisation, depth_* (B, H, W). The flow
    solve passes the dynamic masks as pixel_wise_weight: dynamic pixels get
    weight scale + bias (2), static ones bias (1). Returns a scalar."""
    lp = torch.log(torch.clamp(depth_pred, min=eps))
    li = torch.log(torch.clamp(depth_init, min=eps))
    B, H, W = lp.shape
    scale = (li - lp).sum(dim=(1, 2), keepdim=True) / (H * W)
    if pixel_wise_weight is not None:
        w = pixel_wise_weight.to(lp.dtype)
        if pixel_weight_normalize:
            norm = w.detach().reshape(B, -1).amax(dim=1)
            w = w / (norm[:, None, None] + eps)
        w = w * pixel_wise_weight_scale + pixel_wise_weight_bias
    else:
        w = 1.0
    si = (w * (lp - li + scale) ** 2).sum(dim=(1, 2)) / (H * W)
    return si.mean()
