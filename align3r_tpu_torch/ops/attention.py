"""Attention dispatch (port of align3r_tpu/ops/attention.py).

``xla_attention`` is the plain semantic reference (softmax in fp32, P cast to
v's dtype before P V). ``attention(q, k, v, impl)`` routes as the JAX
dispatch does (attention.py:71-96):
- "xla" -> ``xla_attention``;
- "small" -> K6 (``ops/small_attention.py``; its plain version on the CPU);
- "auto" on a CUDA tensor -> K6 where ``small_attention.supported`` holds,
  else K9 where ``flash_ok`` holds, else ``xla_attention``. On a CPU tensor
  "auto" resolves to ``xla_attention``, as JAX does on its CPU backend;
- "flash" and every route to K9 (the JAX package's stock Pallas flash
  attention, attention.py:44-68) raise ``NotImplementedError``: K9 is not
  ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.ops import small_attention as K6


def xla_attention(q, k, v):
    """q, k, v: (B, H, N, D). Softmax in fp32, output in q.dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_ok(q, k, v) -> bool:
    """Where the JAX package would take its stock flash kernel (K9)."""
    D = q.shape[-1]
    return (q.is_cuda and D in (64, 128, 256) and q.dtype == k.dtype == v.dtype
            and q.shape[2] == k.shape[2])


def _k9():
    raise NotImplementedError(
        "attention route K9 (stock flash attention, align3r_tpu/ops/"
        "attention.py:44) is not ported yet: see ROADMAP.md queue 2")


def attention(q, k, v, impl: str = "auto"):
    """impl: 'auto' | 'xla' | 'small' | 'flash' (see the module docstring)."""
    if impl == "auto":
        if q.is_cuda and K6.supported(q, k, v):
            impl = "small"
        elif flash_ok(q, k, v):
            impl = "flash"
        else:
            impl = "xla"
    if impl == "xla":
        return xla_attention(q, k, v)
    if impl == "small":
        return K6.small_attention(q, k, v)
    if impl == "flash":
        _k9()
    raise ValueError(f"unknown attention impl {impl!r}")
