"""Layer functions (port of align3r_tpu/models/nn.py).

Plain functions on tensors with the JAX package's conventions, so the parity
tests compare like with like: activations are NHWC / (..., C); a dense kernel
is (in, out); LayerNorm eps is 1e-6 with fp32 statistics. The rounding
points follow the JAX functions: a bf16 dense is a bf16 product (fp32
accumulation) rounded to bf16, then the bias added in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def device_or_raise(device) -> torch.device:
    """The device a serving entry point puts its weights on: the card unless
    the caller asks for the CPU. "cuda" without CUDA raises; it never falls
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def dense(x, kernel, bias=None):
    """y = x @ kernel (+ bias), kernel (in, out) cast to x's dtype."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last dim with fp32 statistics, result in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0):
    """NHWC conv with a torch (out, in, kh, kw) weight cast to x's dtype;
    the bias is added after the conv output is rounded, as in nn.conv2d.
    `padding` is symmetric (SAME for odd kernels at stride 1, and the DPT
    head's explicit (1, 1) at stride 2)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv_transpose2d(x, weight, bias=None):
    """ConvTranspose2d with kernel == stride (the only case DPT uses);
    x NHWC, weight torch (in, out, s, s)."""
    s = weight.shape[-1]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                           stride=s).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def gelu(x):
    """Exact-erf GELU (torch nn.GELU default)."""
    return F.gelu(x, approximate="none")


def bilinear_resize(x, out_h: int, out_w: int, align_corners: bool = True):
    """NHWC bilinear resize with torch F.interpolate semantics (the JAX
    function's contract), in x's dtype: PyTorch interpolates bf16 in fp32
    and rounds once, as the JAX bf16 head's fp32 matrix form does."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def _interp_matrix(in_size: int, out_size: int, align_corners: bool):
    """(out, in) bilinear interpolation matrix (two nonzeros per row), a
    numpy copy of the JAX nn._interp_matrix (nn.py:166-180)."""
    import numpy as np
    d = np.arange(out_size, dtype=np.float64)
    if align_corners:
        c = d * ((in_size - 1) / max(out_size - 1, 1)) if out_size > 1 else np.zeros(1)
    else:
        c = np.clip((d + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    lo = np.clip(np.floor(c).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w = c - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += (1 - w)
    m[np.arange(out_size), hi] += w
    return m


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax.image's "bicubic"; torch's
    bicubic takes a = -0.75), on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


_RESIZE_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str = "bilinear", device=None):
    """(in, out) fp32 weights of jax.image.resize along one axis
    (jax/_src/image/scale.py compute_weight_mat): half-pixel centres, the
    kernel widened by in/out when shrinking (antialiasing), each column
    normalised to sum 1, and columns whose sample lies outside the input
    zeroed."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kscale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kscale
    w = _RESIZE_KERNELS[method](x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(x, out_h: int, out_w: int, method: str = "bilinear"):
    """jax.image.resize(x, (B, out_h, out_w[, C]), method) of an NHWC (or
    (B, H, W)) fp32 tensor: one product with resize_weights per axis whose
    size changes. Unlike F.interpolate it antialiases when it shrinks, and
    its bicubic is Keys' a = -0.5."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[..., None]
    H, W = x.shape[1:3]
    if out_h != H:
        x = torch.einsum("hH,bhwc->bHwc",
                         resize_weights(H, out_h, method, x.device).to(x.dtype), x)
    if out_w != W:
        x = torch.einsum("wW,bhwc->bhWc",
                         resize_weights(W, out_w, method, x.device).to(x.dtype), x)
    return x[..., 0] if squeeze else x
