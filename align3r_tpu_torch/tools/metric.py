"""Standalone per-batch depth metrics with the reference function names
(the port of tool/metric.py).

    python -m align3r_tpu_torch.tools.metric pred.npy gt.npy \
        [--min_depth 1e-3] [--max_depth 80]

Behavioural reference: the reference tool/metric.py:4-128: batched
(B, H, W) metrics, each a masked sum over a per-image valid count, averaged
over the batch, in numpy. The sequence-level evaluation is in
eval/depth_metrics.py.
"""
from __future__ import annotations

import numpy as np

from align3r_tpu_torch.eval.depth_metrics import silog_rmse as _silog


def _masked_mean_per_image(err: np.ndarray, valid_mask) -> float:
    if valid_mask is not None:
        err = np.where(np.asarray(valid_mask, bool), err, 0.0)
        n = np.asarray(valid_mask, bool).sum((-1, -2))
    else:
        n = err.shape[-1] * err.shape[-2]
    return float((err.sum((-1, -2)) / n).mean())


def abs_relative_difference(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    return _masked_mean_per_image(np.abs(output - target) / target, valid_mask)


def squared_relative_difference(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    return _masked_mean_per_image((output - target) ** 2 / target, valid_mask)


def rmse_linear(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    mse = _rmse_core((output - target) ** 2, valid_mask)
    return mse


def rmse_log(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    return _rmse_core((np.log(output) - np.log(target)) ** 2, valid_mask)


def _rmse_core(sq_err, valid_mask) -> float:
    if valid_mask is not None:
        sq_err = np.where(np.asarray(valid_mask, bool), sq_err, 0.0)
        n = np.asarray(valid_mask, bool).sum((-1, -2))
    else:
        n = sq_err.shape[-1] * sq_err.shape[-2]
    return float(np.sqrt(sq_err.sum((-1, -2)) / n).mean())


def log10(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    diff = np.abs(np.log10(output) - np.log10(target))
    if valid_mask is not None:
        return float(diff[np.asarray(valid_mask, bool)].mean())
    return float(diff.mean())


def threshold_percentage(output, target, threshold_val, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    ratio = np.maximum(output / target, target / output)
    hit = (ratio < threshold_val).astype(np.float64)
    return _masked_mean_per_image(hit, valid_mask)


def delta1_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25, valid_mask)


def delta2_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 2, valid_mask)


def delta3_acc(pred, gt, valid_mask=None):
    return threshold_percentage(pred, gt, 1.25 ** 3, valid_mask)


def i_rmse(output, target, valid_mask=None):
    output, target = np.asarray(output), np.asarray(target)
    return _rmse_core((1.0 / output - 1.0 / target) ** 2, valid_mask)


def silog_rmse(depth_pred, depth_gt, valid_mask=None):
    """Scale-invariant log RMSE x100 (reference metric.py:115-128):
    eval.depth_metrics.silog_rmse, sqrt(mean(per-image SI error)), not the
    mean of per-image roots."""
    return float(_silog(np.asarray(depth_pred), np.asarray(depth_gt),
                        None if valid_mask is None
                        else np.asarray(valid_mask, bool)))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="depth metrics between two .npy/.npz stacks")
    p.add_argument("pred")
    p.add_argument("gt")
    p.add_argument("--min_depth", type=float, default=1e-3)
    p.add_argument("--max_depth", type=float, default=80.0)
    args = p.parse_args(argv)

    def load(path):
        a = np.load(path)
        return a[a.files[0]] if hasattr(a, "files") else a

    pred, gt = load(args.pred), load(args.gt)
    if pred.ndim == 2:
        pred, gt = pred[None], gt[None]
    valid = (gt > args.min_depth) & (gt < args.max_depth) & (pred > 0)
    print(f"AbsRel {abs_relative_difference(pred, gt, valid):.4f}  "
          f"SqRel {squared_relative_difference(pred, gt, valid):.4f}  "
          f"RMSE {rmse_linear(pred, gt, valid):.4f}  "
          f"LogRMSE {rmse_log(pred, gt, valid):.4f}  "
          f"d1 {delta1_acc(pred, gt, valid):.4f}  "
          f"d2 {delta2_acc(pred, gt, valid):.4f}  "
          f"d3 {delta3_acc(pred, gt, valid):.4f}  "
          f"silog {silog_rmse(pred, gt, valid):.4f}")


if __name__ == "__main__":
    main()
