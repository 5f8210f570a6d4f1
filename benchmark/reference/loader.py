"""Plain reference of the frame loader of the depth tools: the long side
resized to the network size with PIL's LANCZOS (bit for bit on uint8), a
centre crop to multiples of 16, [-1, 1] normalisation; the prior depth
unprojected with its focal (principal point (W/2, H/2)) and min-max
normalised per channel, resized with OpenCV's INTER_CUBIC and cropped alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PRECISION_BITS = 22


def _sinc(x):
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x):
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coeffs(n_in, n_out):
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 3.0 * fs
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        w = [_lanczos((x + xmin - center + 0.5) / fs) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _pass(img, n_out, axis):
    n_in = img.shape[axis]
    xmins, kk = _coeffs(n_in, n_out)
    shape = [1] * img.ndim
    shape[axis] = n_out
    acc = np.full(img.shape[:axis] + (n_out,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        idx = np.minimum(xmins + j, n_in - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int64) * kk[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos(img, w, h):
    """PIL Image.resize((w, h), LANCZOS) of uint8 (H, W, C): horizontal pass
    into uint8, then vertical."""
    H, W = img.shape[:2]
    if w != W:
        img = _pass(img, w, 1)
    if h != H:
        img = _pass(img, h, 0)
    return img


def cubic(arr, w, h):
    """cv2.resize(arr, (w, h), INTER_CUBIC) of float32 (H, W, C), in float64,
    rounded once to float32."""
    def one(a, n_out, axis):
        n_in = a.shape[axis]
        fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        sx = np.floor(fx).astype(np.int64)
        x = fx - sx
        A = -0.75
        c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
        c1 = ((A + 2) * x - (A + 3)) * x * x + 1
        c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
        c = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], 1).astype(np.float32).astype(np.float64)
        idx = np.clip(sx[:, None] + np.arange(-1, 3), 0, n_in - 1)
        shape = [1] * a.ndim
        shape[axis] = n_out
        return sum(np.take(a, idx[:, j], axis=axis) * c[:, j].reshape(shape) for j in range(4))
    H, W = arr.shape[:2]
    if (w, h) == (W, H):
        return np.array(arr, np.float32)
    return one(one(np.asarray(arr, np.float64), w, 1), h, 0).astype(np.float32)


def network_view(frame, cloud, size):
    """One frame (H, W, 3) uint8 and its prior cloud (H, W, 3) -> the
    network's image in [-1, 1] and cloud, long side `size`, centre-cropped to
    multiples of 16 (landscape frames)."""
    H1, W1 = frame.shape[:2]
    S = max(W1, H1)
    w, h = round(W1 * size / S), round(H1 * size / S)
    img = lanczos(frame, w, h)
    cloud = cubic(cloud, w, h)
    cx, cy = w // 2, h // 2
    hw_, hh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    img = img[cy - hh: cy + hh, cx - hw_: cx + hw_]
    ch, cw = cloud.shape[0] // 2, cloud.shape[1] // 2
    cloud = cloud[max(ch - hh, 0): ch + hh, max(cw - hw_, 0): cw + hw_]
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5, cloud


def depth_to_cloud(depth, focal):
    """Prior depth (H, W) and focal in pixels -> the min-max normalised
    (H, W, 3) point cloud."""
    depth = depth.float()
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    pc = torch.stack([(xs - W / 2) * depth / focal, (ys - H / 2) * depth / focal, depth], -1)
    mn, mx = pc.amin(dim=(0, 1)), pc.amax(dim=(0, 1))
    return (pc - mn) / (mx - mn)
