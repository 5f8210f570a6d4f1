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
its design does about that is written at the top of that file. In fp32 the
forward and the backward run on the tensor cores as 3xTF32 split products
(csrc/sm90_attention_tf32.cuh); ``flash_attention_f32_tiles_plain`` and
``flash_attention_bwd_f32_tiles_plain`` are those kernels' walks in
PyTorch, for the CPU tests.

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
from align3r_tpu_torch.ops import small_attention as _sa

HEAD_DIMS = (64, 128, 256)
LOG2E = 1.4426950408889634
F32_BQ = 64   # queries of a forward or dQ block, keys of a dK/dV block


def block_k(D: int, dtype) -> int:
    """The forward kernel's key-block width for (D, dtype) (csrc Tiles::BK):
    bf16 128 keys at D = 64 and 64 at D = 128, 256; fp32 32 keys, 16 at
    D = 256 where Q's split tiles take 128 KB of shared memory."""
    if dtype == torch.bfloat16:
        return 128 if D == 64 else 64
    return 16 if D == 256 else 32


def f32_bwd_tiles(D: int) -> tuple:
    """The fp32 backward's (queries a dK/dV stage, keys a dQ stage) at head
    dim D (csrc Tiles<float, D>::KV_Q, DQ_K): 32 at D = 64, else 16 (at
    D = 256 on clusters of two CTAs, each holding 128 of D's columns)."""
    return (32, 32) if D == 64 else (16, 16)


def _tf32_order(n: int):
    """Positions of n rows (n % 8 == 0) in the transposed copies' order:
    each group of 8 as 0 2 4 6 1 3 5 7 (csrc tf32_key_order)."""
    pos = torch.arange(n)
    w = pos % 8
    return pos - w + torch.where(w < 4, 2 * w, 2 * (w - 4) + 1)


def _pad8(x, dim: int):
    """x zero-padded along dim to a multiple of 8 rows."""
    n = x.shape[dim]
    pad = -n % 8
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def flash_attention_f32_tiles_plain(q, k, v, split: bool = True):
    """The fp32 forward kernel's walk: key tiles of block_k(D, fp32), one
    online-softmax pass, every product as 3xTF32 (split=False: single-pass
    TF32). fp32 in; (o, lse (B, H, N)) fp32."""
    return _sa.f32_tiles_walk(q, k, v, block_k(q.shape[-1], torch.float32), split)


def flash_attention_bwd_f32_tiles_plain(q, k, v, o, lse, do, split: bool = True):
    """The fp32 backward kernels' walk (csrc/sm90_attention_tf32.cuh), every
    product as 3xTF32 (split=False: single-pass TF32), from lse2 = lse log2(e)
    and Di = sum(o do):
    - dK/dV: per 64-key tile, query tiles of f32_bwd_tiles(D)[0]:
      S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T scale log2(e) - lse2),
      dS^T = P^T (dP^T - Di) scale; dV += P^T dO and dK += dS^T Q with the
      queries in the transposed copies' 8-row order on both operands;
    - dQ: per 64-query tile, key tiles of f32_bwd_tiles(D)[1]: S, dP, dS the
      same way, dQ += dS K with the keys in that order.
    At D = 256 the kernels sum S and dP over the two halves of D, one a CTA;
    the walk takes the whole products. fp32 in; (dq, dk, dv) fp32."""
    D, N = q.shape[-1], q.shape[-2]
    bqk, bkq = f32_bwd_tiles(D)
    scale = D ** -0.5
    sl2 = scale * LOG2E
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * do).sum(-1)
    lse2 = lse.float() * LOG2E

    def mm(a, b):
        return _sa.tf32_mm(a, b, split)

    def reduce_rows(a, b):   # a (.., M, n) @ b (.., n, N) over n in the 8-row order
        a, b = _pad8(a, -1), _pad8(b, -2)
        order = _tf32_order(a.shape[-1])
        return mm(a[..., order], b[..., order, :])

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, N, F32_BQ):
        kt, vt = k[..., k0:k0 + F32_BQ, :], v[..., k0:k0 + F32_BQ, :]
        for q0 in range(0, N, bqk):
            qs, dos = q[..., q0:q0 + bqk, :], do[..., q0:q0 + bqk, :]
            st = mm(kt, qs.transpose(-1, -2))
            dpt = mm(vt, dos.transpose(-1, -2))
            pt = torch.exp2(st * sl2 - lse2[..., None, q0:q0 + bqk])
            dst = pt * (dpt - di[..., None, q0:q0 + bqk]) * scale
            dv[..., k0:k0 + F32_BQ, :] += reduce_rows(pt, dos)
            dk[..., k0:k0 + F32_BQ, :] += reduce_rows(dst, qs)
    dq = torch.zeros_like(q)
    for q0 in range(0, N, F32_BQ):
        qs, dos = q[..., q0:q0 + F32_BQ, :], do[..., q0:q0 + F32_BQ, :]
        for k0 in range(0, N, bkq):
            kt, vt = k[..., k0:k0 + bkq, :], v[..., k0:k0 + bkq, :]
            s = mm(qs, kt.transpose(-1, -2))
            dp = mm(dos, vt.transpose(-1, -2))
            p = torch.exp2(s * sl2 - lse2[..., q0:q0 + F32_BQ, None])
            ds = p * (dp - di[..., q0:q0 + F32_BQ, None]) * scale
            dq[..., q0:q0 + F32_BQ, :] += reduce_rows(ds, kt)
    return dq, dk, dv


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
    bf16 = q.dtype == torch.bfloat16
    # fp32: K's TF32 hi and lo, and V^T's over N rounded up to 8 keys
    scratch = None if bf16 else torch.empty(
        2 * B * H * D * (N + -(-N // 8) * 8), device=q.device, dtype=torch.float32)
    _lib.check(_lib.library().a3r_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if bf16 else scratch.data_ptr(), B * H, N, D, int(bf16), D ** -0.5,
        _lib.stream()), "K9 fwd")
    flash_attention.launches += 1
    return o, lse


def _bwd_cuda(q, k, v, o, lse, do):
    _check([("q", q), ("k", k), ("v", v), ("o", o), ("do", do)])
    B, H, N, D = q.shape
    q, k, v, o, do = (_lib.dense(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Di and the log2-unit log-sum-exp, each (B H, N padded to 64 rows); in
    # fp32 also the TF32 hi and lo of q, k, v, do (B H, N, D) and of q^T,
    # do^T, k^T (B H, D, N padded to 8)
    rows = 2 * B * H * (-(-N // 64) * 64)
    if q.dtype == torch.float32:
        rows += 8 * B * H * N * D + 6 * B * H * D * (-(-N // 8) * 8)
    scratch = torch.empty(rows, device=q.device, dtype=torch.float32)
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
