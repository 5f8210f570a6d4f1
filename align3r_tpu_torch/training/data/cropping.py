"""Joint image / depth / prior crop-resize with the intrinsics bookkeeping
(port of align3r_tpu/training/data/cropping.py:17-81).

Behavioural reference: the reference dust3r/datasets/utils/cropping.py
(rescale_image_depthmap:56-90, camera_matrix_of_crop:93-106,
crop_image_depthmap:109-123, bbox_from_intrinsics_in_out:126-130,
center_crop_image_depthmap:132-190).

Images are uint8 (H, W, 3) arrays, resampled by the port's bit-exact copy of
PIL's LANCZOS (shrinking) and BICUBIC (enlarging) and cropped as PIL's
`crop` does (zero outside the image); the depth and prior maps are resized
with OpenCV's INTER_NEAREST rule (`resize_nearest`) and cropped by slicing,
as in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np

from align3r_tpu_torch.geometry.core import (colmap_to_opencv_intrinsics,
                                             opencv_to_colmap_intrinsics)
from align3r_tpu_torch.inference.images import resize_pil


@functools.lru_cache(maxsize=64)
def _nearest_src(in_size: int, out_size: int) -> np.ndarray:
    """OpenCV's resizeNN: src = min(floor(dst * (1 / (out / in))), in - 1),
    the scale inverted in doubles as OpenCV inverts it."""
    inv = 1.0 / (out_size / in_size)
    return np.minimum(np.floor(np.arange(out_size) * inv).astype(np.int64), in_size - 1)


def resize_nearest(arr: np.ndarray, size_wh) -> np.ndarray:
    """cv2.resize(arr, (w, h), interpolation=cv2.INTER_NEAREST) on an (H, W)
    or (H, W, C) array."""
    w, h = (int(x) for x in size_wh)
    H, W = arr.shape[:2]
    return np.ascontiguousarray(arr[_nearest_src(H, h)][:, _nearest_src(W, w)])


def crop_image(image: np.ndarray, l: int, t: int, r: int, b: int) -> np.ndarray:
    """PIL's Image.crop((l, t, r, b)) of a uint8 (H, W[, C]) array: pixels
    outside the image are zero."""
    H, W = image.shape[:2]
    out = np.zeros((b - t, r - l) + image.shape[2:], image.dtype)
    y0, y1, x0, x1 = max(t, 0), min(b, H), max(l, 0), min(r, W)
    if y0 < y1 and x0 < x1:
        out[y0 - t:y1 - t, x0 - l:x1 - l] = image[y0:y1, x0:x1]
    return out


def image_size(image: np.ndarray):
    """(W, H), as PIL's Image.size."""
    return image.shape[1], image.shape[0]


def rescale_image_depthmap(image, depthmap, pred_depth, K, output_resolution,
                           force=True):
    """Rescale so the image covers output_resolution (W, H)."""
    in_res = np.array(image_size(image), np.float64)
    out_res = np.array(output_resolution, np.float64)
    scale = float(max(out_res / in_res)) + 1e-8
    if scale >= 1 and not force:
        return image, depthmap, pred_depth, K
    new_res = np.floor(in_res * scale).astype(int)
    image = resize_pil(image, int(new_res[0]), int(new_res[1]),
                       "lanczos" if scale < 1 else "bicubic")
    if depthmap is not None:
        depthmap = resize_nearest(depthmap, new_res)
    if pred_depth is not None:
        pred_depth = resize_nearest(pred_depth, new_res)
    K = camera_matrix_of_crop(K, in_res, new_res, scaling=scale)
    return image, depthmap, pred_depth, K


def camera_matrix_of_crop(K_in, in_res, out_res, scaling=1.0,
                          offset_factor=0.5, offset=None):
    margins = np.asarray(in_res, np.float64) * scaling - np.asarray(out_res)
    assert np.all(margins >= -1e-6), margins
    if offset is None:
        offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(np.asarray(K_in, np.float64))
    K[:2, :] *= scaling
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K).astype(np.float32)


def crop_image_depthmap(image, depthmap, pred_depth, K, crop_bbox):
    l, t, r, b = (int(x) for x in crop_bbox)
    image = crop_image(image, l, t, r, b)
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    if pred_depth is not None:
        pred_depth = pred_depth[t:b, l:r]
    K = np.array(K, copy=True)
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, pred_depth, K


def bbox_from_intrinsics_in_out(K_in, K_out, out_res):
    out_w, out_h = out_res
    l, t = np.int32(np.round(K_in[:2, 2] - K_out[:2, 2]))
    return (l, t, l + int(out_w), t + int(out_h))


def center_crop_image_depthmap(image, depthmap, pred_depth, K, crop_scale):
    assert 0 < crop_scale <= 1
    in_res = np.array(image_size(image))
    out_res = np.floor(in_res * crop_scale).astype(int)
    l, t = ((in_res - out_res) / 2).astype(int)
    return crop_image_depthmap(image, depthmap, pred_depth, K,
                               (l, t, l + out_res[0], t + out_res[1]))
