"""Frame and prior loading for the port's tools (port of
align3r_tpu/inference/images.py).

Resize the long side to `size`, centre-crop to multiples of 16, normalise
to [-1, 1], and load the per-frame monocular prior `.npz` by the dataset's
naming convention as a min-max-normalised pointcloud. Outputs are numpy
arrays (n, H, W, C), as the JAX loader gives them.

No imaging library is needed at import time or for PNG frames:
- images are uint8 arrays; PNG is read by `utils.png` (8-bit gray, gray +
  alpha, RGB and RGBA), baseline JPEG by `utils.jpeg` (the bits cv2 and
  PIL give); HEIC, other PNGs and other JPEGs (progressive, arithmetic,
  12-bit, CMYK) go through PIL with `exif_transpose` where PIL is
  importable, else an ImportError names the file (and a JPEG's SOF marker);
  video goes through OpenCV where it is importable, likewise;
- the resamplers are the port's own, always: PIL's LANCZOS and NEAREST on
  uint8 (bit for bit) for frames and masks (and its BICUBIC for the scene
  viewer's thumbnails), OpenCV's INTER_CUBIC on float32 for priors. So the
  output does not depend on the installation.
"""
from __future__ import annotations

import functools
import importlib.util
import math
import os
from typing import Dict, List

import numpy as np
import torch

from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
from align3r_tpu_torch.utils.jpeg import UnsupportedJPEG, read_jpeg
from align3r_tpu_torch.utils.png import UnsupportedPNG, read_png

VIDEO_EXTS = (".mp4", ".avi", ".mov")
# HEIF/HEIC frames join the accepted set only where pillow_heif is installed,
# as in the JAX loader (checked without importing it)
heif_support_enabled = importlib.util.find_spec("pillow_heif") is not None
IMG_EXTS = (".jpg", ".jpeg", ".png") + ((".heic", ".heif") if heif_support_enabled else ())

PRECISION_BITS = 22          # PIL Resample.c: 32 - 8 - 2


# ------------------------------------------------------------- decoding

def _pil_image(path: str, why: str = ""):
    try:
        import PIL.Image
        from PIL.ImageOps import exif_transpose
    except ImportError as e:
        raise ImportError(f"reading {path} needs Pillow, which is not installed "
                          f"{why}(PNG and baseline JPEG frames are read without it)") from e
    if path.lower().endswith((".heic", ".heif")):
        from pillow_heif import register_heif_opener
        register_heif_opener()
    return PIL.Image, exif_transpose


def _decoded(path: str, orient: bool = True):
    """The port's own decode of a PNG or JPEG file, or None where it does not
    read the file (and PIL is to); None for other extensions."""
    low = path.lower()
    try:
        if low.endswith(".png"):
            return read_png(path)
        if low.endswith((".jpg", ".jpeg")):
            return read_jpeg(path, orient)
    except UnsupportedPNG:
        return None
    except UnsupportedJPEG as e:
        _pil_image(path, f"({e}) ")     # without PIL: raise naming the SOF marker
        return None
    return None


def rgb_to_l(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of uint8 RGB: (r 19595 + g 38470 + b 7471 + 2^15) >> 16."""
    c = img.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + (1 << 15))
            >> 16).astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3), as exif_transpose(PIL.Image.open(path)).convert("RGB")."""
    img = _decoded(path)
    if img is None:
        Image, exif_transpose = _pil_image(path)
        return np.asarray(exif_transpose(Image.open(path)).convert("RGB"))
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :1].repeat(3, axis=2) if img.shape[2] == 2 else img[..., :3]


def read_l(path: str) -> np.ndarray:
    """uint8 (H, W), as PIL.Image.open(path).convert("L")."""
    img = _decoded(path, orient=False)
    if img is None:
        Image, _ = _pil_image(path)
        return np.asarray(Image.open(path).convert("L"))
    if img.ndim == 2:
        return img
    return img[..., 0] if img.shape[2] == 2 else rgb_to_l(img[..., :3])


# ------------------------------------------------------------ resampling

def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, resample: str):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc: the first input index
    of each output and its integer weights (22 fractional bits), zero beyond
    the output's support."""
    filt, filter_support = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int, resample: str) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _pil_coeffs(in_size, out_size, resample)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)      # weight 0 past the support
        acc += np.take(img, idx, axis=axis).astype(np.int64) * kk[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's ImagingScaleAffine: the source coordinate starts at scale / 2
    and is advanced by `scale` in doubles."""
    a = in_size / out_size
    xo, idx = a * 0.5, []
    for _ in range(out_size):
        idx.append(-1 if xo < 0.0 else int(xo))
        xo += a
    return np.clip(np.asarray(idx, np.int64), 0, in_size - 1)


def resize_pil(img: np.ndarray, w: int, h: int, resample: str = "lanczos") -> np.ndarray:
    """PIL's Image.resize((w, h), resample) on a uint8 (H, W) or (H, W, C)
    array, bit for bit, for resample "lanczos", "bicubic" or "nearest". The
    first two are a horizontal pass (skipped when the width stays) into
    uint8, then a vertical one (skipped likewise)."""
    H, W = img.shape[:2]
    if resample == "nearest":
        return np.ascontiguousarray(img[_nearest_index(H, h)][:, _nearest_index(W, w)])
    if w != W:
        img = _pil_pass(img, w, 1, resample)
    if h != H:
        img = _pil_pass(img, h, 0, resample)
    return np.ascontiguousarray(img)


@functools.lru_cache(maxsize=64)
def _cubic_coeffs(in_size: int, out_size: int):
    """OpenCV's INTER_CUBIC taps: src = (dst + 0.5) scale - 0.5, A = -0.75,
    four taps from floor(src) - 1, indices clamped at the border; the
    coefficients in doubles, stored as float32 (OpenCV 5)."""
    scale = 1.0 / (out_size / in_size)
    fx = (np.arange(out_size) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(sx[:, None] + np.arange(-1, 3), 0, in_size - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32).astype(np.float64)


def _cubic_pass(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, c = _cubic_coeffs(arr.shape[axis], out_size)
    shape = [1] * arr.ndim
    shape[axis] = out_size
    return sum(np.take(arr, idx[:, j], axis=axis) * c[:, j].reshape(shape) for j in range(4))


def resize_cubic(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(arr, (w, h), interpolation=INTER_CUBIC) on float32 (H, W)
    or (H, W, C), in float64 and rounded once to float32."""
    H, W = arr.shape[:2]
    if (w, h) == (W, H):
        return np.array(arr, np.float32)
    out = _cubic_pass(np.asarray(arr, np.float64), w, 1)
    return _cubic_pass(out, h, 0).astype(np.float32)


def _resize_pil(img, long_edge, nearest=False):
    H, W = img.shape[:2]
    S = max(W, H)
    return resize_pil(img, round(W * long_edge / S), round(H * long_edge / S),
                      "nearest" if nearest else "lanczos")


def _resize_np(arr, long_edge):
    H, W = arr.shape[:2]
    S = max(W, H)
    return resize_cubic(arr, round(W * long_edge / S), round(H * long_edge / S))


def _crop_center_np(arr, cw, ch):
    h, w = arr.shape[:2]
    cx, cy = h // 2, w // 2
    return arr[max(cx - ch // 2, 0): cx + ch // 2, max(cy - cw // 2, 0): cy + cw // 2]


def _crop(img, l, t, r, b):
    return np.ascontiguousarray(img[t:b, l:r])


def crop_img(img: np.ndarray, size: int, pred_depth=None, square_ok=False,
             nearest=False, crop=True):
    """Resize the long side to `size` (the short side for 224), then crop or
    resize to a multiple-of-16 canvas about the centre. img: uint8 (H, W[, C]).
    Returns (img, pred_depth)."""
    H1, W1 = img.shape[:2]
    if size == 224:
        img = _resize_pil(img, round(size * max(W1 / H1, H1 / W1)), nearest)
        if pred_depth is not None:
            pred_depth = _resize_np(pred_depth, round(size * max(W1 / H1, H1 / W1)))
        H, W = img.shape[:2]
        cx, cy = W // 2, H // 2
        half = min(cx, cy)
        img = _crop(img, cx - half, cy - half, cx + half, cy + half)
        if pred_depth is not None:
            pred_depth = _crop_center_np(pred_depth, 2 * half, 2 * half)
        return img, pred_depth
    img = _resize_pil(img, size, nearest)
    if pred_depth is not None:
        pred_depth = _resize_np(pred_depth, size)
    H, W = img.shape[:2]
    cx, cy = W // 2, H // 2
    halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    if not square_ok and W == H:
        halfh = 3 * halfw // 4
    if crop:
        img = _crop(img, cx - halfw, cy - halfh, cx + halfw, cy + halfh)
        if pred_depth is not None:
            pred_depth = _crop_center_np(pred_depth, 2 * halfw, 2 * halfh)
    else:
        img = resize_pil(img, 2 * halfw, 2 * halfh)
        if pred_depth is not None:
            pred_depth = resize_cubic(pred_depth, 2 * halfw, 2 * halfh)
    return img, pred_depth


# ---------------------------------------------------------------- priors

def prior_depth_path(img_path: str, traj_format: str, depth_prior_name: str) -> str:
    """Per-dataset prior-depth .npz naming convention."""
    p = img_path
    tag = "depth_prediction_" + depth_prior_name
    if traj_format == "sintel":
        return p.replace("clean", tag).replace(".png", ".npz")
    if traj_format in ("tum", "tartanair"):
        return p.replace("rgb_50", "rgb_50_" + tag).replace(".png", ".npz")
    if traj_format == "bonn":
        return p.replace("rgb_110", "rgb_110_" + tag).replace(".png", ".npz")
    if traj_format == "davis":
        return (p.replace("JPEGImages", tag).replace(".jpg", ".npz")
                .replace("480p", "1080p"))
    if traj_format == "scannet":
        return (p.replace("color_30", "color_90_" + tag)
                .replace(".jpg", ".npz").replace(".png", ".npz"))
    if traj_format == "kitti":
        return (p.replace("image_gathered", tag)
                .replace(".jpg", ".npz").replace(".png", ".npz"))
    return (p.replace(".png", "_pred_depth_" + depth_prior_name + ".npz")
            .replace(".jpg", "_pred_depth_" + depth_prior_name + ".npz"))


def load_prior_pointcloud(img_path: str, traj_format: str,
                          depth_prior_name: str = "depthpro"):
    """The cached monocular prior unprojected to the normalised pointcloud
    prior: (H, W, 3) float32, or None if the file is missing."""
    path = prior_depth_path(img_path, traj_format, depth_prior_name)
    if path == img_path or not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=True)
    depth = np.asarray(data["depth"])
    if depth.ndim == 3:
        depth = np.squeeze(depth)
    focal = float(data["focallength_px"]) if depth_prior_name == "depthpro" else 200.0
    return pixel_to_pointcloud(torch.from_numpy(np.asarray(depth, np.float32)),
                               focal).numpy()


def normalize_img(img: np.ndarray) -> np.ndarray:
    """uint8 -> [-1, 1] float32, NHWC."""
    return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5


# ---------------------------------------------------------------- loader

def _frame(img, prior, size, square_ok, crop, idx, instance):
    img_c, prior_c = crop_img(img, size, prior, square_ok=square_ok, crop=crop)
    hw = img_c.shape[:2]
    if prior_c is None:
        prior_c = np.zeros(hw + (3,), np.float32)
    return dict(img=normalize_img(img_c)[None],
                pred_depth=np.asarray(prior_c, np.float32)[None],
                true_shape=np.int32([hw]), idx=idx, instance=instance)


def _video_frames(path: str, fps: int, limit: int):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading the video {path} needs OpenCV, which is not "
                          "installed (pass a folder of PNG frames instead)") from e
    cap = cv2.VideoCapture(path)
    video_fps = cap.get(cv2.CAP_PROP_FPS) or 30
    step = max(int(round(video_fps / fps)), 1) if fps > 0 else 1
    k, kept = 0, 0
    try:
        while kept < limit:
            ok, frame = cap.read()
            if not ok:
                break
            if k % step == 0:
                yield k, np.ascontiguousarray(frame[..., ::-1])
                kept += 1
            k += 1
    finally:
        cap.release()


def load_images(folder_or_list, size: int, square_ok=False, verbose=False,
                dynamic_mask_root=None, crop=True, fps: int = 0,
                traj_format: str = "sintel", start: int = 0,
                interval: int = 10 ** 9, depth_prior_name: str = "depthpro"
                ) -> List[Dict]:
    """A folder or list of frames (or a video file) -> per-frame dicts
    {'img' (1, H, W, 3) in [-1, 1], 'pred_depth' (1, H, W, 3), 'true_shape',
    'idx', 'instance', 'dynamic_mask' (1, H, W)}, as the JAX load_images.
    `interval` caps both the folder slice and the number of fps-strided
    video frames; the library default is unlimited."""
    if isinstance(folder_or_list, str):
        if os.path.isdir(folder_or_list):
            root = folder_or_list
            content = sorted(os.listdir(folder_or_list))
        else:
            root, content = "", [folder_or_list]
    else:
        root, content = "", list(folder_or_list)
    content = sorted(content, key=lambda x: x.split("/")[-1])[start:start + interval]

    imgs: List[Dict] = []
    for path in content:
        full = os.path.join(root, path)
        low = path.lower()
        if low.endswith(IMG_EXTS):
            prior = load_prior_pointcloud(full, traj_format, depth_prior_name)
            d = _frame(read_rgb(full), prior, size, square_ok, crop, len(imgs), full)
            dyn_path = None
            if dynamic_mask_root is not None:
                dyn_path = os.path.join(dynamic_mask_root, os.path.basename(path))
            elif traj_format == "sintel":
                dyn_path = (full.replace("final", "dynamic_label_perfect")
                            .replace("clean", "dynamic_label_perfect")
                            .replace("MPI-Sintel-training_images",
                                     "MPI-Sintel-depth-training"))
            if dyn_path and os.path.exists(dyn_path):
                dm, _ = crop_img(read_l(dyn_path), size, square_ok=square_ok, crop=crop)
                d["dynamic_mask"] = (np.asarray(dm, np.float32) / 255.0 > 0.99)[None]
            else:
                d["dynamic_mask"] = np.zeros((1,) + d["img"].shape[1:3], bool)
            imgs.append(d)
        elif low.endswith(VIDEO_EXTS):
            for k, frame in _video_frames(full, fps, interval):
                d = _frame(frame, None, size, square_ok, crop, len(imgs), f"{full}:frame{k}")
                d["dynamic_mask"] = np.zeros((1,) + d["img"].shape[1:3], bool)
                imgs.append(d)
    assert imgs, f"no images found in {folder_or_list}"
    if verbose:
        print(f">> loaded {len(imgs)} frames at {imgs[0]['img'].shape}")
    return imgs


def stack_views(views: List[Dict]) -> Dict[str, np.ndarray]:
    """Per-frame dicts -> stacked arrays for the engine."""
    return {
        "imgs": np.concatenate([v["img"] for v in views], axis=0),
        "priors": np.concatenate([v["pred_depth"] for v in views], axis=0),
        "dynamic_masks": np.concatenate([v["dynamic_mask"] for v in views], axis=0),
        "instances": [v["instance"] for v in views],
    }
