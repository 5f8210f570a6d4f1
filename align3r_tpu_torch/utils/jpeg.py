"""JPEG read and write without an imaging library.

`read_jpeg` decodes baseline JPEG (Huffman, 8-bit, gray or YCbCr, 4:4:4,
4:2:2 or 4:2:0, restart markers) to the bits libjpeg-turbo's default
decompression gives, which is what ``cv2.imread`` and Pillow return, and
applies the EXIF orientation as Pillow's ``exif_transpose`` and OpenCV's
``IMREAD_COLOR`` do. Other JPEGs (progressive, arithmetic-coded, lossless,
12-bit, CMYK) raise `UnsupportedJPEG`, which names the file and its SOF
marker, so that a caller can hand them to an imaging library where one is
installed. `encode_jpeg` / `write_jpeg` write baseline JFIF (the standard
tables scaled by quality; 4:2:0 at quality 75 by default, as Pillow's
``save``).

Both live in ``csrc/jpeg_decode.cpp``, compiled at first use by the host C++
compiler (``c++ -O3 -shared -fPIC -std=c++17``) into ``build/jpeg/`` at the
repository root, under a name that carries a hash of the source and flags,
and loaded with ``ctypes``. A ctypes call releases the GIL, so the data
loader's threads decode in parallel. A failed build raises with the
compiler's messages.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from align3r_tpu_torch.utils.png import _exif_orientation, _orient

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "jpeg_decode.cpp"
BUILD_DIR = _PKG.parent / "build" / "jpeg"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "a3r_jpeg_header": [_P, _LL, _P, _P, _I],
    "a3r_jpeg_decode": [_P, _LL, _P, _P, _I],
    "a3r_jpeg_encode": [_P, _I, _I, _I, _I, _I, _P, _P],
    "a3r_jpeg_free": [_P],
}
_lock = threading.Lock()
_loaded: dict = {}


class UnsupportedJPEG(ValueError):
    """A JPEG this decoder does not read (progressive, arithmetic, 12-bit, CMYK)."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libalign3r_jpeg-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing. Returns (path, seconds spent
    compiling; 0.0 when it already existed)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["c++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"c++ failed to build {SOURCE.name} ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded codec library (built on first call in this process)."""
    lib = _loaded.get("lib")
    if lib is None:
        with _lock:
            lib = _loaded.get("lib")
            if lib is None:
                path, _ = build()
                lib = ctypes.CDLL(str(path))
                for name, args in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = None if name == "a3r_jpeg_free" else ctypes.c_int
                _loaded["lib"] = lib
    return lib


def _ptr(buf) -> int:
    return ctypes.cast(buf, ctypes.c_void_p).value


def decode_jpeg(data: bytes, name: str = "<bytes>", orient: bool = True) -> np.ndarray:
    """uint8 (H, W) for a gray file, else (H, W, 3) RGB; the EXIF orientation
    applied unless `orient` is False."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int * 6)()
    err = ctypes.create_string_buffer(256)
    code = lib.a3r_jpeg_header(buf.ctypes.data, len(buf), _ptr(info), _ptr(err), 256)
    w, h, nc, sof, exif_off, exif_len = info
    if code == 0:
        out = np.empty((h, w) if nc == 1 else (h, w, 3), np.uint8)
        code = lib.a3r_jpeg_decode(buf.ctypes.data, len(buf), out.ctypes.data, _ptr(err), 256)
    msg = err.value.decode(errors="replace")
    if code == 1:
        raise UnsupportedJPEG(f"{name}: SOF marker 0x{sof:02X} ({msg})")
    if code != 0:
        raise ValueError(f"{name}: {msg}")
    if orient and exif_off >= 0:
        out = np.ascontiguousarray(_orient(out, _exif_orientation(
            bytes(data[exif_off:exif_off + exif_len]))))
    return out


def read_jpeg(path, orient: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path), orient)


def encode_jpeg(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """The baseline JFIF file of a uint8 (H, W) gray or (H, W, 3) RGB image."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3), got {img.shape}")
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_longlong()
    code = lib.a3r_jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0],
                               1 if img.ndim == 2 else 3, int(quality),
                               SUBSAMPLING[subsampling], ctypes.addressof(out),
                               ctypes.addressof(n))
    if code != 0:
        raise ValueError(f"encode_jpeg: cannot encode an image of shape {img.shape}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.a3r_jpeg_free(out)


def write_jpeg(img: np.ndarray, path, quality: int = 75, subsampling: str = "4:2:0") -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))
