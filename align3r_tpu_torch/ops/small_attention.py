"""Softmax attention for short sequences: kernel K6 beside its plain PyTorch
version (port of align3r_tpu/ops/small_attention.py).

K6 ``small_attention`` replaces the Pallas ``_kernel_unrolled``
(small_attention.py:47-65, called through ``_call`` :69-94). Per head: fp32
logits q k^T scaled by D^-1/2, the exact row max over all keys,
p = exp(logits - max) in fp32, s = the sum of the unrounded p, P rounded to
v's dtype before P V (fp32 accumulation), and (P V) / s in q's dtype. The
CUDA implementation is csrc/small_attention.cu; what bounds it and what its
design does about that is written at the top of that file. In fp32 it runs
on the tensor cores as 3xTF32 split products with one online-softmax pass
(csrc/sm90_attention_tf32.cuh); ``small_attention_f32_tiles_plain`` is that
walk in PyTorch, for the CPU tests.

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


# the fp32 kernel's keys per stage (csrc/sm90_attention_tf32.cuh, F32_BK)
F32_BK = 32


def tf32_round(x):
    """fp32 x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, 10 mantissa bits (the 13 low bits cleared). Finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_mm(a, b, split: bool = True):
    """a (.., M, K) @ b (.., K, N) as the fp32 kernels' products: operands
    split as hi = tf32(x), lo = tf32(x - hi), the product lo hi + hi lo +
    hi hi in fp32 (3xTF32). split=False runs single-pass TF32 (hi hi
    alone), the function the split exists to avoid."""
    ah, bh = tf32_round(a), tf32_round(b)
    if not split:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def f32_tiles_walk(q, k, v, bk: int, split: bool = True):
    """The fp32 forward kernels' walk in PyTorch (csrc/sm90_attention_tf32.cuh):
    key tiles of bk, one online-softmax pass (running max and sum of the
    unrounded p, O and the sum rescaled by exp2(m_old - m_new), log2 units),
    every product through tf32_mm. fp32 in; (o fp32, lse fp32 (.., Nq))."""
    D, Nk = q.shape[-1], k.shape[-2]
    scale_log2 = D ** -0.5 * 1.4426950408889634
    q, k, v = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, Nk, bk):
        s = tf32_mm(q, k[..., k0:k0 + bk, :].transpose(-1, -2), split)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + tf32_mm(p, v[..., k0:k0 + bk, :], split)
        m = m_new
    return acc / l, ((m + torch.log2(l)) * 0.6931471805599453).squeeze(-1)


def small_attention_f32_tiles_plain(q, k, v, split: bool = True):
    """The fp32 kernel's walk in PyTorch: key tiles of F32_BK, one
    online-softmax pass and every product as 3xTF32 (f32_tiles_walk).
    split=False runs single-pass TF32. fp32 in, fp32 out."""
    return f32_tiles_walk(q, k, v, F32_BK, split)[0]


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
    bf16 = q.dtype == torch.bfloat16
    # fp32: K's TF32 hi and lo, and V^T's over Nk rounded up to 8 keys
    scratch = None if bf16 else torch.empty(
        2 * B * H * D * (Nk + -(-Nk // 8) * 8), device=q.device, dtype=torch.float32)
    _lib.check(_lib.library().a3r_small_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if bf16 else scratch.data_ptr(), B * H, Nq, Nk, D, int(bf16), D ** -0.5,
        _lib.stream()), "K6")
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
