"""Camera geometry core (port of align3r_tpu/geometry/core.py).

Plain functions on tensors; shapes and conventions are the JAX package's.
The data pipeline's host-side helpers (`depthmap_to_camera_coords`, the
intrinsics conversions) work on numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def safe_norm(x, dim=-1, keepdim: bool = False, eps: float = 1e-12):
    """||x|| with a zero gradient at x = 0 (geometry/core.py:17-25): the
    clamp cuts the gradient below eps and sign(0) = 0 zeroes the value, so
    masked points (exact zeros) never produce NaN gradients."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps)) * torch.sign(sq)


def xy_grid(W: int, H: int, origin=(0, 0), homogeneous: bool = False,
            dtype=torch.float32, device=None):
    """(H, W, 2) grid with out[j, i] = (i + ox, j + oy); optionally (H, W, 3)."""
    xs = torch.arange(origin[0], origin[0] + W, dtype=dtype, device=device)
    ys = torch.arange(origin[1], origin[1] + H, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if homogeneous:
        return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.stack([gx, gy], dim=-1)


def geotrf(Trf, pts, ncol: int | None = None, norm: float = 0.0):
    """Apply an affine/projective transform (..., d(+1), d(+1)) to points
    (..., d); Trf's batch dims align with the leading dims of pts."""
    d = pts.shape[-1]
    batch = Trf.shape[:-2]
    if batch:
        n_extra = pts.ndim - 1 - len(batch)
        T = Trf.reshape(tuple(batch) + (1,) * n_extra + tuple(Trf.shape[-2:]))
    else:
        T = Trf
    if Trf.shape[-1] == d + 1:
        out = (T[..., :d, :d] @ pts.unsqueeze(-1)).squeeze(-1) + T[..., :d, d]
    elif Trf.shape[-1] == d:
        out = (T @ pts.unsqueeze(-1)).squeeze(-1)
    else:
        raise ValueError(f"incompatible shapes Trf={tuple(Trf.shape)} "
                         f"pts={tuple(pts.shape)}")
    if norm:
        out = out / out[..., -1:]
        if norm != 1:
            out = out * norm
    if ncol is not None:
        out = out[..., :ncol]
    return out


def inv(mat):
    """General inverse of a (stack of) 4x4 matrices."""
    return torch.linalg.inv(mat)


def closed_form_pose_inverse(pose):
    """[R t]^-1 = [R^T  -R^T t] for rigid cam2world poses (..., 4, 4)."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t.unsqueeze(-1))], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(*pose.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def depthmap_to_pts3d(depth, pseudo_focal, pp=None):
    """depth (B, H, W), pseudo_focal (B,) | (B, H, W) | (B, 1|2, H, W),
    pp (B, 2) or None (centre (W-1)/2, (H-1)/2) -> (B, H, W, 3)."""
    B, H, W = depth.shape
    if pseudo_focal.ndim == 1:
        fx = fy = pseudo_focal[:, None, None]
    elif pseudo_focal.ndim == 3:
        fx = fy = pseudo_focal
    else:
        fx = pseudo_focal[:, 0]
        fy = pseudo_focal[:, 1] if pseudo_focal.shape[1] == 2 else fx
    grid = xy_grid(W, H, dtype=depth.dtype, device=depth.device)
    gx, gy = grid[..., 0][None], grid[..., 1][None]
    if pp is None:
        gx = gx - (W - 1) / 2
        gy = gy - (H - 1) / 2
    else:
        gx = gx - pp[:, 0, None, None]
        gy = gy - pp[:, 1, None, None]
    return torch.stack([depth * gx / fx, depth * gy / fy, depth], dim=-1)


def pixel_to_pointcloud(depth_map, focal_length_px):
    """Monocular prior depth (H, W) -> min-max-normalised (H, W, 3) cloud
    (geometry/core.py:165-179: pp = (W/2, H/2), unproject, per-channel
    min-max normalise to [0, 1])."""
    depth_map = torch.as_tensor(depth_map, dtype=torch.float32)
    H, W = depth_map.shape
    grid = xy_grid(W, H, device=depth_map.device)
    X = (grid[..., 0] - W / 2) * depth_map / focal_length_px
    Y = (grid[..., 1] - H / 2) * depth_map / focal_length_px
    pc = torch.stack([X, Y, depth_map], dim=-1)
    mn = pc.amin(dim=(0, 1))
    mx = pc.amax(dim=(0, 1))
    return (pc - mn) / (mx - mn)


def depthmap_to_camera_coords(depthmap, camera_intrinsics, max_depth: float = 400.0):
    """Unproject a depth map (H, W) with a full 3x3 K (no skew), numpy on the
    host (geometry/core.py:109-131). Returns (pts (H, W, 3) float32, valid
    (H, W, 2)): valid[..., 0] = 0 < depth < max_depth, valid[..., 1] =
    depth > 0; where no pixel is valid, the nearest nonzero depth is."""
    depthmap = np.asarray(depthmap)
    K = np.float32(camera_intrinsics)
    H, W = depthmap.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = (u - K[0, 2]) * depthmap / K[0, 0]
    y = (v - K[1, 2]) * depthmap / K[1, 1]
    pts = np.stack([x, y, depthmap], axis=-1).astype(np.float32)
    valid = (depthmap > 0.0) & (depthmap < max_depth)
    if valid.sum() == 0:
        d = depthmap.copy()
        d[d == 0] = 1e4
        valid[d == d.min()] = True
    return pts, np.stack([valid, depthmap > 0.0], axis=-1)


def colmap_to_opencv_intrinsics(K):
    """Pixel centres at integers (OpenCV) from centres at +0.5 (COLMAP)."""
    K = np.array(K, copy=True)
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K):
    K = np.array(K, copy=True)
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def normalize_pointcloud(pts1, pts2=None, norm_mode: str = "avg_dis",
                         valid1=None, valid2=None, ret_factor: bool = False):
    """Joint scale-normalisation of one or two pointmaps (mode 'avg_dis', the
    training criterion's; geometry/core.py:132-162). pts* (B, H, W, 3);
    valid* (B, H, W) bool: invalid points contribute zero distance and are
    counted out of the divisor."""
    if norm_mode != "avg_dis":
        raise ValueError(f"norm_mode {norm_mode!r}: only 'avg_dis' is supported")

    def flat(p, v):
        B = p.shape[0]
        p = p.reshape(B, -1, 3)
        if v is None:
            return p, torch.full((B,), p.shape[1], dtype=p.dtype, device=p.device)
        v = v.reshape(B, -1, 1).to(p.dtype)
        return p * v, v[..., 0].sum(dim=1)

    p1, n1 = flat(pts1, valid1)
    if pts2 is not None:
        p2, n2 = flat(pts2, valid2)
        all_pts, nnz = torch.cat([p1, p2], dim=1), n1 + n2
    else:
        all_pts, nnz = p1, n1
    norm_factor = safe_norm(all_pts, dim=-1).sum(dim=1) / (nnz + 1e-8)
    norm_factor = torch.clamp(norm_factor, min=1e-8)[:, None, None, None]
    res1 = pts1 / norm_factor
    if pts2 is None:
        return (res1, norm_factor) if ret_factor else res1
    res2 = pts2 / norm_factor
    return (res1, res2, norm_factor) if ret_factor else (res1, res2)
