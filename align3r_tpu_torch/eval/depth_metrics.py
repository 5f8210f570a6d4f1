"""Video-depth evaluation: scale / shift alignment and the standard metrics
(port of align3r_tpu/eval/depth_metrics.py).

Behavioural reference: the reference tool/depth_test.py (alignment modes
700-763: lstsq / LAD scipy / LAD2 Adam / Weiszfeld scale / median; metrics
796-823: AbsRel, SqRel, RMSE, LogRMSE, delta < 1.25^k; pixel-weighted
dataset average 827-835) and tool/metric.py. numpy / scipy, as in JAX;
`align_lad2`, which JAX runs as a jitted optax Adam, is a torch Adam here
(optax's defaults: b1 0.9, b2 0.999, eps 1e-8; fp32, as JAX computes it)
on `device`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


# ------------------------------------------------------------- alignment

def align_lstsq(pred: np.ndarray, gt: np.ndarray):
    """L2-optimal scale+shift (depth_test.py:707-724)."""
    A = np.stack([pred, np.ones_like(pred)], axis=1)
    sol = np.linalg.lstsq(A, gt, rcond=None)[0]
    return float(sol[0]), float(sol[1])


def align_lad(pred: np.ndarray, gt: np.ndarray, s_init=None, t_init=0.0):
    """Least-absolute-deviation scale+shift via Nelder-Mead-style scipy
    minimize (depth_test.py:476-493, 725-727)."""
    from scipy.optimize import minimize
    if s_init is None:
        s_init = float(np.median(gt) / max(np.median(pred), 1e-12))

    def f(params):
        s, t = params
        return np.abs(s * pred + t - gt).sum()

    res = minimize(f, [s_init, t_init])
    return float(res.x[0]), float(res.x[1])


def align_lad2(pred: np.ndarray, gt: np.ndarray, s_init=None, lr=1e-4,
               max_iters=1000, tol=1e-6, device="cpu"):
    """LAD via Adam on (s, t) (depth_test.py:495-528): the loss sum |s pred +
    t - gt| at the current (s, t), then one Adam step, stopping when the
    loss moves by less than `tol`."""
    if s_init is None:
        s_init = float(np.median(gt) / max(np.median(pred), 1e-12))
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    g = torch.as_tensor(np.asarray(gt, np.float32), device=device)
    s = torch.tensor([s_init], dtype=torch.float32, device=device, requires_grad=True)
    t = torch.tensor([0.0], dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([s, t], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    prev = None
    for _ in range(max_iters):
        opt.zero_grad()
        loss = (s * p + t - g).abs().sum()
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        if prev is not None and abs(prev - loss) < tol:
            break
        prev = loss
    return float(s.detach()[0]), float(t.detach()[0])


def align_scale_weiszfeld(pred: np.ndarray, gt: np.ndarray, n_iter=10):
    """Scale-only robust fit (depth_test.py:731-758)."""
    s = gt.mean() / max(pred.mean(), 1e-12)
    for _ in range(n_iter):
        w = 1.0 / (np.abs(s * pred - gt) + 1e-8)
        s = (w * pred * gt).sum() / max((w * pred * pred).sum(), 1e-12)
    return float(max(s, 1e-3)), 0.0


def align_median(pred: np.ndarray, gt: np.ndarray):
    return float(np.median(gt) / max(np.median(pred), 1e-12)), 0.0


ALIGN_FNS = {
    "lstsq": align_lstsq,
    "lad": align_lad,
    "lad2": align_lad2,
    "scale": align_scale_weiszfeld,
    "median": align_median,
}


# --------------------------------------------------------------- metrics

def depth_metrics(aligned_pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Per-sequence metrics over valid pixels (depth_test.py:796-823).
    Inputs are flat arrays of valid pixels, already aligned & clipped."""
    abs_rel = float(np.mean(np.abs(aligned_pred - gt) / gt))
    sq_rel = float(np.mean((aligned_pred - gt) ** 2 / gt))
    rmse = float(np.sqrt(np.mean((aligned_pred - gt) ** 2)))
    log_rmse = float(np.sqrt(np.mean((np.log(aligned_pred) - np.log(gt)) ** 2)))
    ratio = np.maximum(aligned_pred / gt, gt / aligned_pred)
    return {
        "Abs Rel": abs_rel,
        "Sq Rel": sq_rel,
        "RMSE": rmse,
        "Log RMSE": log_rmse,
        "δ < 1.25": float(np.mean(ratio < 1.25)),
        "δ < 1.25^2": float(np.mean(ratio < 1.25 ** 2)),
        "δ < 1.25^3": float(np.mean(ratio < 1.25 ** 3)),
        "valid_pixels": int(gt.size),
    }


def evaluate_sequence_depth(pred_depths: np.ndarray, gt_depths: np.ndarray,
                            valid_masks: np.ndarray | None = None,
                            align: str = "lad", depth_max: float = 70.0,
                            depth_eps: float = 1e-5, device="cpu") -> Dict[str, float]:
    """Align a whole sequence jointly (one s, t per sequence, the reference
    protocol) then compute metrics. pred / gt: (T, H, W). `device` is where
    align_lad2 runs."""
    if valid_masks is None:
        valid_masks = (gt_depths > 0) & (gt_depths < depth_max)
    pred = np.asarray(pred_depths, np.float64)[valid_masks]
    gt = np.asarray(gt_depths, np.float64)[valid_masks]
    kw = {"device": device} if align == "lad2" else {}
    s, t = ALIGN_FNS[align](pred, gt, **kw)
    aligned = np.clip(s * pred + t, depth_eps, depth_max)
    return depth_metrics(aligned, gt)


def average_metrics(per_seq: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Pixel-count-weighted average over sequences (depth_test.py:827-835)."""
    weights = [m["valid_pixels"] for m in per_seq]
    return {k: float(np.average([m[k] for m in per_seq], weights=weights))
            for k in per_seq[0] if k != "valid_pixels"}


# --------------------------- standalone metrics (reference tool/metric.py)

def i_rmse(pred, gt, valid_mask=None):
    """Inverse-depth RMSE, per-image mean (metric.py:100-111)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    diff = 1.0 / pred - 1.0 / gt
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum(axis=(-1, -2))
    else:
        n = pred.shape[-1] * pred.shape[-2]
    mse = (diff ** 2).sum(axis=(-1, -2)) / n
    return float(np.sqrt(mse).mean())


def silog_rmse(pred, gt, valid_mask=None):
    """Scale-invariant log RMSE x100 (metric.py:115-128)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    diff = np.log(pred) - np.log(gt)
    if valid_mask is not None:
        diff = np.where(valid_mask, diff, 0.0)
        n = valid_mask.sum(axis=(-1, -2))
    else:
        n = gt.shape[-2] * gt.shape[-1]
    first = (diff ** 2).sum(axis=(-1, -2)) / n
    second = diff.sum(axis=(-1, -2)) ** 2 / (n ** 2)
    return float(np.sqrt(np.mean(first - second)) * 100)
