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
