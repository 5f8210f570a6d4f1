"""Training criteria (port of align3r_tpu/training/losses.py:26-128):
ConfLoss(Regr3D(L21)) for training and the scale-shift-invariant Regr3D for
evaluation.

As in the JAX package, boolean indexing becomes masked reductions with
static shapes, and medians over valid pixels are NaN-masked medians.
``nanmedian`` matches ``jnp.nanmedian``: for an even count it averages the
two middle values (``torch.nanmedian`` returns the lower one).

gt view dicts: {'pts3d' (B, H, W, 3) world points, 'camera_pose' (B, 4, 4)
cam2world, 'valid_mask' (B, H, W) bool}; pred1 {'pts3d', 'conf'}; pred2
{'pts3d_in_other_view', 'conf'}.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from align3r_tpu_torch.geometry.core import (closed_form_pose_inverse, geotrf,
                                             normalize_pointcloud, safe_norm)


def _masked_mean(x, mask, dim=None, reduce=None):
    """Mean of x over mask. reduce (data parallelism) maps this process's
    count to the global batch's, so that the ranks' values sum to the global
    mean."""
    m = mask.to(x.dtype)
    num = (x * m).sum() if dim is None else (x * m).sum(dim=dim)
    den = m.sum() if dim is None else m.sum(dim=dim)
    if reduce is not None:
        den = reduce(den)
    return num / torch.clamp(den, min=1.0)


def l21(a, b):
    """Euclidean distance over the last axis (reference losses.py:91-96)."""
    return safe_norm(a - b, dim=-1)


def nanmedian(x, dim: int, keepdim: bool = False):
    """jnp.nanmedian: NaNs ignored; the mean of the two middle values for an
    even count (the linear quantile at 0.5); NaN where a slice is all NaN.
    Differentiable through the selected values."""
    s = torch.sort(x, dim=dim).values                  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), max=x.shape[dim] - 1)
    hi = torch.where(n == 0, lo, hi)
    out = 0.5 * (torch.take_along_dim(s, lo, dim=dim)
                 + torch.take_along_dim(s, hi, dim=dim))
    return out if keepdim else out.squeeze(dim)


def regr3d_pts(gt1: Dict, gt2: Dict, pred1: Dict, pred2: Dict,
               norm_mode: str = "avg_dis", gt_scale: bool = False,
               dist_clip: float | None = None):
    """Everything in camera 1, normalised: (gt_pts1, gt_pts2, pr_pts1,
    pr_pts2, valid1, valid2) (reference losses.py:194-220)."""
    in_cam1 = closed_form_pose_inverse(gt1["camera_pose"].float())
    gt_pts1 = geotrf(in_cam1, gt1["pts3d"].float())
    gt_pts2 = geotrf(in_cam1, gt2["pts3d"].float())
    valid1, valid2 = gt1["valid_mask"], gt2["valid_mask"]
    if dist_clip is not None:
        valid1 = valid1 & (torch.linalg.norm(gt_pts1, dim=-1) <= dist_clip)
        valid2 = valid2 & (torch.linalg.norm(gt_pts2, dim=-1) <= dist_clip)
    pr_pts1 = pred1["pts3d"].float()
    pr_pts2 = pred2["pts3d_in_other_view"].float()
    if norm_mode:
        pr_pts1, pr_pts2 = normalize_pointcloud(pr_pts1, pr_pts2, norm_mode,
                                                valid1, valid2)
        if not gt_scale:
            gt_pts1, gt_pts2 = normalize_pointcloud(gt_pts1, gt_pts2, norm_mode,
                                                    valid1, valid2)
    return gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2


def conf_regr3d_loss(gt1, gt2, pred1, pred2, alpha: float = 0.2,
                     norm_mode: str = "avg_dis", reduce=None) -> Tuple[torch.Tensor, Dict]:
    """ConfLoss(Regr3D(L21)), the training criterion (train.sh:6,
    reference losses.py:242-286). Returns (scalar loss, details). With
    `reduce` (a rank's share of a data-parallel batch), each mean divides by
    the global batch's valid-pixel count: the ranks' losses and gradients sum
    to the global batch's."""
    gt_pts1, gt_pts2, pr1, pr2, m1, m2 = regr3d_pts(gt1, gt2, pred1, pred2,
                                                    norm_mode)
    d1, d2 = l21(pr1, gt_pts1), l21(pr2, gt_pts2)
    conf1, conf2 = pred1["conf"].float(), pred2["conf"].float()
    loss1 = _masked_mean(d1 * conf1 - alpha * torch.log(conf1), m1, reduce=reduce)
    loss2 = _masked_mean(d2 * conf2 - alpha * torch.log(conf2), m2, reduce=reduce)
    details = {"Regr3D_pts3d_1": _masked_mean(d1, m1, reduce=reduce),
               "Regr3D_pts3d_2": _masked_mean(d2, m2, reduce=reduce),
               "conf_loss_1": loss1, "conf_loss_2": loss2}
    return loss1 + loss2, details


def _nan_where(x, mask):
    return torch.where(mask, x, torch.full_like(x, float("nan")))


def regr3d_scale_shift_inv_loss(gt1, gt2, pred1, pred2, gt_scale: bool = True):
    """The evaluation criterion Regr3D_ScaleShiftInv(L21, gt_scale=True)
    (reference losses.py:289-347): depths shifted by their joint median, and
    the prediction rescaled to the ground truth's joint median centred norm
    (a constant of the gradient)."""
    gt_pts1, gt_pts2, pr1, pr2, m1, m2 = regr3d_pts(
        gt1, gt2, pred1, pred2, norm_mode="avg_dis", gt_scale=gt_scale)
    B = gt_pts1.shape[0]

    def joint_median_z(z1, z2):
        z = torch.cat([_nan_where(z1, m1).reshape(B, -1),
                       _nan_where(z2, m2).reshape(B, -1)], dim=1)
        return nanmedian(z, dim=1)[:, None, None, None]

    def shift_z(p, s):
        return torch.cat([p[..., :2], p[..., 2:] - s], dim=-1)

    gt_shift = joint_median_z(gt_pts1[..., 2], gt_pts2[..., 2])
    pr_shift = joint_median_z(pr1[..., 2], pr2[..., 2])
    gt_pts1, gt_pts2 = shift_z(gt_pts1, gt_shift), shift_z(gt_pts2, gt_shift)
    pr1, pr2 = shift_z(pr1, pr_shift), shift_z(pr2, pr_shift)

    @torch.no_grad()
    def center_scale(p1, p2):
        pts = torch.cat([_nan_where(p1, m1[..., None]).reshape(B, -1, 3),
                         _nan_where(p2, m2[..., None]).reshape(B, -1, 3)], dim=1)
        center = nanmedian(pts, dim=1, keepdim=True)
        return nanmedian(torch.linalg.norm(pts - center, dim=-1), dim=1)

    gt_s = center_scale(gt_pts1, gt_pts2)[:, None, None, None]
    pr_s = torch.clamp(center_scale(pr1, pr2), 1e-3, 1e3)[:, None, None, None]
    if gt_scale:
        pr1, pr2 = pr1 * (gt_s / pr_s), pr2 * (gt_s / pr_s)
    else:
        gt_pts1, gt_pts2 = gt_pts1 / gt_s, gt_pts2 / gt_s
        pr1, pr2 = pr1 / pr_s, pr2 / pr_s
    return _masked_mean(l21(pr1, gt_pts1), m1) + _masked_mean(l21(pr2, gt_pts2), m2)
