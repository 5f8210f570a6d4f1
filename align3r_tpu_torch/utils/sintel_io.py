"""Sintel file format readers (.dpt depth, .cam camera, .flo flow); port of
align3r_tpu/utils/sintel_io.py.

Format spec: the public MPI-Sintel I/O convention — little-endian float32
tag 202021.25, then width/height int32, then row-major float32 data
(reference uses the same convention in datasets_preprocess/sintel_get_dynamics.py
and dust3r/utils/vo_eval.py:17-37).
"""
from __future__ import annotations

import numpy as np

TAG_FLOAT = 202021.25


def depth_read(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, f"bad .dpt tag {check} in {filename}"
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        depth = np.fromfile(f, dtype=np.float32, count=width * height)
    return depth.reshape(height, width)


def depth_write(filename: str, depth: np.ndarray):
    height, width = depth.shape
    with open(filename, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.int32(width).tofile(f)
        np.int32(height).tofile(f)
        depth.astype(np.float32).tofile(f)


def flow_read(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, f"bad .flo tag {check} in {filename}"
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        data = np.fromfile(f, dtype=np.float32, count=2 * width * height)
    return data.reshape(height, width, 2)


def cam_read(filename: str):
    from align3r_tpu_torch.eval.trajectory import sintel_cam_read
    return sintel_cam_read(filename)
