"""Attention dispatch (port of align3r_tpu/ops/attention.py).

``xla_attention`` is the plain semantic reference (softmax in fp32, P cast to
v's dtype before P V). ``attention(q, k, v, impl)`` routes as the JAX
dispatch does (attention.py:71-96):
- "xla" -> ``xla_attention``;
- "small" -> K6 (``ops/small_attention.py``; its plain version on the CPU);
- "flash" -> K9 (``ops/flash_attention.py``, the counterpart of the JAX
  package's stock Pallas flash attention, attention.py:44-68) where
  ``flash_ok`` holds, else ``xla_attention`` (attention.py:92-95). It holds
  only on the card, as JAX's holds only on the TPU, so every CPU tensor
  takes ``xla_attention``;
- "auto" -> ``route``: on the card K6 where ``small_attention.supported``
  holds, else K9 where ``flash_ok`` holds, else ``xla_attention``; on the
  CPU ``xla_attention``, as JAX does on its CPU backend.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.ops import flash_attention as K9
from align3r_tpu_torch.ops import small_attention as K6


def xla_attention(q, k, v):
    """q, k, v: (B, H, N, D). Softmax in fp32, output in q.dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_ok(q, k, v, on_card=None) -> bool:
    """Where the JAX package would take its stock flash kernel (K9):
    on the card (``on_card`` defaults to ``q.is_cuda``), D in {64, 128,
    256}, one dtype, Nq == Nk."""
    on_card = q.is_cuda if on_card is None else on_card
    return (on_card and q.shape[-1] in K9.HEAD_DIMS and q.dtype == k.dtype == v.dtype
            and q.shape[2] == k.shape[2])


def route(q, k, v, on_card: bool) -> str:
    """What "auto" resolves to, from shapes, dtypes and whether the tensors
    are on the card: "small" (K6), "flash" (K9) or "xla"."""
    if on_card and K6.supported(q, k, v):
        return "small"
    return "flash" if flash_ok(q, k, v, on_card) else "xla"


def attention(q, k, v, impl: str = "auto"):
    """impl: 'auto' | 'xla' | 'small' | 'flash' (see the module docstring)."""
    if impl == "auto":
        impl = route(q, k, v, q.is_cuda)
    if impl == "xla":
        return xla_attention(q, k, v)
    if impl == "small":
        return K6.small_attention(q, k, v)
    if impl == "flash":
        if not flash_ok(q, k, v):
            return xla_attention(q, k, v)
        return K9.flash_attention(q, k, v)
    raise ValueError(f"unknown attention impl {impl!r}")
