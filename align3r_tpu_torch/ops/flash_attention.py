"""Flash attention, forward and backward: kernel K9 beside its plain PyTorch
versions (port of align3r_tpu/ops/attention.py:44-68 stock_flash_attention,
which runs JAX's library Pallas TPU flash attention).

For q, k, v (B, H, N, D) with Nq == Nk, D in {64, 128, 256}, bf16 or fp32:
- forward: S = (q k^T) * D^-1/2 in fp32 over key blocks of ``block_k``
  keys, an online row max and sum, P = exp(S - running max) rounded to v's
  dtype before P V (fp32 accumulation), output in q's dtype, and the fp32
  log-sum-exp per row kept for the backward;
- backward: Di = sum(O * dO) in fp32, P = exp(S - LSE) recomputed, P and
  dS rounded to dO's dtype before their products, as the stock backward
  kernels do (flash_attention.py:900, :918).
The CUDA implementation is csrc/flash_attention.cu; what bounds it and what
its design does about that is written at the top of that file.

``flash_attention_plain`` runs the kernel's own blocking (the same key-block
width, ``block_k``, so P is rounded against the same running max), so the
CPU tests exercise it. The stock TPU kernel's key block is 128-512 keys
(attention.py:62), so the two agree to one bf16 rounding of P, not bit for
bit. ``flash_attention_bwd_plain`` is the recompute-from-LSE backward.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels (counted on ``flash_attention.launches`` and
``flash_attention_bwd.launches``) or raises for a dtype or shape they do not
take. There is no fallback.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.ops import _lib

HEAD_DIMS = (64, 128, 256)


def block_k(D: int, dtype) -> int:
    """The forward kernel's key-block width for (D, dtype) (csrc Tiles::BK):
    bf16 128 keys at D = 64 and 64 at D = 128, 256; fp32 64 keys, 32 at
    D = 256 where 64 would not fit shared memory."""
    if dtype == torch.bfloat16:
        return 128 if D == 64 else 64
    return 32 if D == 256 else 64


def flash_attention_plain(q, k, v):
    """Plain version of K9's forward: the online-softmax recurrence over key
    blocks of the kernel's width. Returns (o in q.dtype, lse fp32 (B, H, N))."""
    D = q.shape[-1]
    N = k.shape[2]
    scale = D ** -0.5
    qf = q.float()
    m = torch.full(q.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    bk = block_k(D, q.dtype)
    for k0 in range(0, N, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, k0:k0 + bk].float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v[:, :, k0:k0 + bk].float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """Plain version of K9's backward (recompute from the log-sum-exp).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5
    qf, kf = q.float(), k.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    di = (o.float() * dof).sum(dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = ((dp - di[..., None]) * p * scale).to(do.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(named):
    q = named[0][1]
    B, H, N, D = q.shape
    for name, t in named:
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"K9 takes bf16 or fp32 CUDA tensors; {name} is "
                             f"{t.dtype} on {t.device}")
        if t.dtype != q.dtype or tuple(t.shape) != (B, H, N, D):
            raise ValueError(f"K9 needs q, k, v (and o, do) of one dtype and shape "
                             f"(B, H, N, D); {name} is {tuple(t.shape)} {t.dtype}, "
                             f"q {tuple(q.shape)} {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"K9 needs D in {HEAD_DIMS}; got D={D}")


def _fwd_cuda(q, k, v):
    _check([("q", q), ("k", k), ("v", v)])
    B, H, N, D = q.shape
    q, k, v = _lib.dense(q), _lib.dense(k), _lib.dense(v)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
    _lib.check(_lib.library().a3r_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B * H, N, D, int(q.dtype == torch.bfloat16), D ** -0.5, _lib.stream()), "K9 fwd")
    flash_attention.launches += 1
    return o, lse


def _bwd_cuda(q, k, v, o, lse, do):
    _check([("q", q), ("k", k), ("v", v), ("o", o), ("do", do)])
    B, H, N, D = q.shape
    q, k, v, o, do = (_lib.dense(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Di and the log2-unit log-sum-exp, each (B H, N padded to 64 rows)
    scratch = torch.empty(2 * B * H * (-(-N // 64) * 64), device=q.device,
                          dtype=torch.float32)
    _lib.check(_lib.library().a3r_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        B * H, N, D, int(q.dtype == torch.bfloat16), D ** -0.5, _lib.stream()), "K9 bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v):
    """K9's forward on CUDA tensors, its plain version on CPU tensors:
    (o, lse)."""
    return _fwd_cuda(q, k, v) if q.is_cuda else flash_attention_plain(q, k, v)


def flash_attention_bwd(q, k, v, o, lse, do):
    """K9's backward on CUDA tensors, its plain version on CPU tensors:
    (dq, dk, dv)."""
    if q.is_cuda:
        return _bwd_cuda(q, k, v, o, lse, do)
    return flash_attention_bwd_plain(q, k, v, o, lse, do)


class FlashAttention(torch.autograd.Function):
    """Forward and backward both through K9 (its plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors      # unpacked once (remat's rule)
        return flash_attention_bwd(q, k, v, o, lse, do.to(q.dtype))


def flash_attention(q, k, v):
    """Softmax attention (K9). q, k, v: (B, H, N, D) of one dtype, scale
    D^-1/2, output in q.dtype; differentiable through K9's backward."""
    return FlashAttention.apply(q, k, v)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
