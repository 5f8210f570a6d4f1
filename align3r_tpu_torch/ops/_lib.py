"""Build and load the port's CUDA kernels (``align3r_tpu_torch/csrc``).

All ``*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
process per source, all started together) and linked into one shared
library with a plain C interface, at first use, under ``build/`` at the repo
root (listed in ``.gitignore``); the file name carries a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the library.
The library is loaded with ``ctypes``: pointers and the stream are passed as
``c_void_p`` and every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception. ``ptxas -v`` reports each kernel's
registers and spill bytes; the report is kept beside the library
(``.log``). The TMA descriptors of the sm90 attention and GEMM kernels are encoded
through the runtime's driver entry point, so the link needs no ``-lcuda``.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "align3r_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "a3r_layernorm": [_P, _P, _P, _P, _LL, _LL, _I, _F, _P],
    "a3r_gemm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "a3r_finish": [_P, _P, _P, _P, _LL, _LL, _I, _P],
    "a3r_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "a3r_small_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "a3r_edge_fwd": [_P] * 10 + [_I] * 5 + [_P],
    "a3r_edge_bwd": [_P] * 10 + [_I] * 6 + [_P],
    "a3r_permute_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _P],
    "a3r_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "a3r_flash_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
    "a3r_conv3x3": [_P] * 8 + [_I] * 9 + [_P],
    "a3r_upsample2x": [_P] * 6 + [_I] * 5 + [_P],
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libalign3r_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing.
    Returns (path, seconds spent compiling; 0.0 when it already existed)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{f.stem}.o" for f in cu]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
                                   str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for f, o in zip(cu, objs)]
        logs = [p.communicate()[1] for p in procs]
        errs = [f"{f.name} ({p.returncode}):\n{log}"
                for f, p, log in zip(cu, procs, logs) if p.returncode]
        if errs:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errs))
        path.with_suffix(".log").write_text("\n".join(logs))
        out = Path(tmp) / path.name
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(out, path)
    return path, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = _loaded.get("lib")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def dense(t):
    """t contiguous, with 16-byte aligned rows for the kernels' TMA and 16-byte loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
