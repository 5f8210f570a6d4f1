"""Softmax attention for short sequences: kernel K6 beside its plain PyTorch
version (port of align3r_tpu/ops/small_attention.py).

K6 ``small_attention`` replaces the Pallas ``_kernel_unrolled``
(small_attention.py:47-65, called through ``_call`` :69-94). Per head: fp32
logits q k^T scaled by D^-1/2, the exact row max over all keys,
p = exp(logits - max) in fp32, s = the sum of the unrounded p, P rounded to
v's dtype before P V (fp32 accumulation), and (P V) / s in q's dtype. The
CUDA implementation is csrc/small_attention.cu; what bounds it and what its
design does about that is written at the top of that file.

The backward is autograd of a plain twin of ``_xla_equiv`` (:149-160), by
recompute, as the JAX custom VJP does (``_small_bwd``, :167-170): the twin
normalises p / s before the rounding, with the row max held constant. The
forward and the backward twin differ on purpose, as they do in JAX.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (and counts the launch on ``small_attention.launches``) or raises for
a dtype or shape the kernel does not take. There is no fallback.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.ops import _lib
from align3r_tpu_torch.ops.autograd import KernelWithTwin


def supported(q, k, v) -> bool:
    """The JAX predicate (small_attention.py:97-110), VMEM gate included, so
    that attn_impl="auto" picks the route the JAX package picks on its
    target."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    itemsize = q.element_size()
    vmem = 2 * 4 * 2 * (Nq + Nk) * D * itemsize + 4 * 8 * Nq * Nk
    return (Nq % 16 == 0 and Nk % 16 == 0 and D <= 128 and D % 8 == 0
            and q.dtype == k.dtype == v.dtype
            and Nq * Nk >= 128 * 128
            and vmem < 32 * 1024 * 1024)


def small_attention_plain(q, k, v):
    """Plain version of K6 (the semantics of _kernel_unrolled)."""
    D = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (out / s).to(q.dtype)


def small_attention_twin(q, k, v):
    """The computation whose autograd is K6's backward (the JAX _xla_equiv):
    p / s normalised before the rounding to v's dtype; the row max is a
    constant."""
    D = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", (p / s).to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _cuda(q, k, v):
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"K6 takes bf16 or fp32 CUDA tensors; {name} is "
                             f"{t.dtype} on {t.device}")
    if not (q.dtype == k.dtype == v.dtype) or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[-1] != D:
        raise ValueError(f"K6 needs equal dtypes and q (B, H, Nq, D), k/v "
                         f"(B, H, Nk, D); got {tuple(q.shape)} {q.dtype}, "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    if D > 128 or D % 8:
        raise ValueError(f"K6 needs D <= 128 and D % 8 == 0; got D={D}")

    q, k, v = _lib.dense(q), _lib.dense(k), _lib.dense(v)
    o = torch.empty_like(q)
    _lib.check(_lib.library().a3r_small_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, Nq, Nk,
        D, int(q.dtype == torch.bfloat16), D ** -0.5, _lib.stream()), "K6")
    small_attention.launches += 1
    return o


def _forward(q, k, v):
    return _cuda(q, k, v) if q.is_cuda else small_attention_plain(q, k, v)


def small_attention(q, k, v):
    """Fused softmax attention for short sequences (K6). q: (B, H, Nq, D);
    k, v: (B, H, Nk, D); fp32 softmax, output in q.dtype. Differentiable:
    the backward is autograd of small_attention_twin."""
    return KernelWithTwin.apply(_forward, small_attention_twin, q, k, v)


small_attention.launches = 0
