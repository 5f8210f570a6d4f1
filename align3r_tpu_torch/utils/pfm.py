"""Portable float maps (the SceneFlow / PointOdyssey depth format): the
port's copies of align3r_tpu/training/data/datasets.py read_pfm and
datasets_preprocess/common.py write_pfm."""
from __future__ import annotations

import numpy as np


def read_pfm(path):
    """(H, W) or (H, W, 3) float32, rows top to bottom."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        color = header == "PF"
        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        w, h = map(int, dims.split())
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, arr):
    """One-channel little-endian PFM of a (H, W) map, rows bottom to top."""
    arr = np.asarray(arr, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(arr).astype("<f4").tofile(f)
