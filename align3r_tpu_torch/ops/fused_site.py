"""Fused attention and MLP sites: kernels K1 and K2, each beside its plain
PyTorch version (port of align3r_tpu/ops/fused_site.py).

K1 ``attention_site`` replaces the Pallas ``_kernel`` (fused_site.py:78,
called through ``_call`` :170-221): [LN] -> q/k/v projection + bias -> RoPE2D
from one shared (N, 2) grid -> fp32 softmax(q k^T D^-1/2), P rounded to the
activation dtype before PV -> out-projection + bias [+ residual].

K2 ``mlp_site`` replaces ``_mlp_kernel`` (:242) and ``_mlp_fblock_kernel``
(:289): [LN] -> fc1 + bias -> exact-erf GELU -> fc2 + bias [+ residual].

The CUDA implementation (csrc/fused_site.cu, csrc/gemm.cuh) runs each site as
several hand-written launches: a LayerNorm kernel, tiled bf16 tensor-core
GEMMs with fused epilogues (bias, bias + RoPE, bias + GELU, bias + residual)
and a two-pass attention kernel. What bounds it and what the design does
about it is written at the top of those files.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernels (and counts the launch on the wrapper's ``launches``) or raises for a
dtype or shape the kernels do not take. There is no fallback.

Shapes (the JAX package's): x (G, B, N, C) with G the stacked streams;
weights (G, C_in, C_out) in the activation dtype; biases, LayerNorm scales
and shifts (G, C) fp32; ``pos`` one (N, 2) grid shared by every row.
"""
from __future__ import annotations

import torch

from align3r_tpu_torch.models.rope import rope_tables, rotate_halves
from align3r_tpu_torch.ops import _lib
from align3r_tpu_torch.ops.autograd import KernelWithTwin

_EPI_BIAS, _EPI_ROPE, _EPI_GELU, _EPI_RESID = 0, 1, 2, 3


def _check_cuda(what, bf16, fp32):
    """The kernels take bf16 activations and weights, and biases and
    LayerNorm parameters of any float dtype, all on the card."""
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError(f"{what} takes bf16 CUDA tensors; {name} is "
                             f"{t.dtype} on {t.device}")
    for name, t in fp32.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")


def _ln(x, p, eps: float = 1e-6):
    """LayerNorm with per-stream (scale, bias) each (G, C); fp32 stats."""
    scale, bias = p
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


def _proj(x, w, b):
    """bf16 x bf16 -> fp32 product + fp32 bias, rounded to x's dtype."""
    t = torch.einsum("gbnc,gck->gbnk", x.float(), w.float())
    return (t + b.float()[:, None, None]).to(x.dtype)


# ------------------------------------------------------------------- K1

def site_plain(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
               num_heads: int, ln_q=None, ln_kv=None, residual: bool = False,
               twin: bool = False):
    """Plain PyTorch version of K1 (the semantics of the Pallas _kernel).
    cos/sin: (N, D) tables in xq's dtype. twin=True gives the XLA twin
    _site_xla (fused_site.py:427-473) instead, whose autograd is the
    backward of attention_site_diff: it rounds p / s, not p, to v's dtype
    before P V, and rounds the attention output before the projection."""
    raw = xq
    xq = _ln(raw, ln_q) if ln_q is not None else raw
    if isinstance(ln_kv, str):
        xkv = xq
    elif ln_kv is not None:
        xkv = _ln(xkv, ln_kv)
    G, B, N, C = xq.shape
    H = num_heads
    D = C // H

    def heads(t):
        return t.reshape(G, B, N, H, D)

    def rope(t):
        return t * cos[:, None, :] + rotate_halves(t) * sin[:, None, :]

    q = rope(heads(_proj(xq, wq, bq)))
    k = rope(heads(_proj(xkv, wk, bk)))
    v = heads(_proj(xkv, wv, bv))
    logits = torch.einsum("gbqhd,gbkhd->gbhqk", q.float(), k.float()) * D ** -0.5
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    if twin:
        pn = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
        oh = torch.einsum("gbhqk,gbkhd->gbqhd", pn.float(), v.float())
        o = oh.to(v.dtype).reshape(G, B, N, C)
    else:
        rs = 1.0 / p.sum(dim=-1)                                # (G,B,H,Nq)
        oh = torch.einsum("gbhqk,gbkhd->gbqhd", p.to(v.dtype).float(), v.float())
        o = (oh * rs.permute(0, 1, 3, 2)[..., None]).to(xq.dtype).reshape(G, B, N, C)
    y = _proj(o, wo, bo)
    return raw + y if residual else y


def _ln_cuda(lib, x, p, s):
    """LayerNorm kernel on contiguous bf16 x (G, B, N, C); p = (scale, bias)
    each (G, C)."""
    G, B, N, C = x.shape
    y = torch.empty_like(x)
    _lib.check(lib.a3r_layernorm(x.data_ptr(), p[0].float().contiguous().data_ptr(),
                                 p[1].float().contiguous().data_ptr(), y.data_ptr(),
                                 B * N, G * B * N, C, 1e-6, s), "layernorm")
    return y


def _site_cuda(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
               num_heads, ln_q, ln_kv, residual):
    G, B, N, C = xq.shape
    D = C // num_heads
    lns = {f"{n}[{i}]": t for n, p in (("ln_q", ln_q), ("ln_kv", ln_kv))
           if p is not None and not isinstance(p, str) for i, t in enumerate(p)}
    _check_cuda("K1", dict(xq=xq, xkv=xkv, wq=wq, wk=wk, wv=wv, wo=wo, cos=cos,
                           sin=sin), dict(bq=bq, bk=bk, bv=bv, bo=bo, **lns))
    if D != 64 or C % 128 or C > 1024 or xkv.shape != xq.shape:
        raise ValueError(f"K1 needs D == 64, C % 128 == 0, C <= 1024 and "
                         f"equal q/kv shapes; got {tuple(xq.shape)}, "
                         f"{num_heads} heads, kv {tuple(xkv.shape)}")
    lib = _lib.library()
    s = _lib.stream()
    rows = B * N
    xq = xq.contiguous()
    xkv = xkv.contiguous()

    def gemm(x, w, b, epi, resid=None):
        out = torch.empty((G, B, N, w.shape[-1]), dtype=torch.bfloat16,
                          device=x.device)
        w = w.contiguous()
        b = b.float().contiguous()
        _lib.check(lib.a3r_gemm(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            resid.data_ptr() if resid is not None else None, out.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), G, rows, w.shape[-1], C, epi, D, N,
            s), "K1 gemm")
        return out

    cos = cos.contiguous()
    sin = sin.contiguous()
    xn = _ln_cuda(lib, xq, ln_q, s) if ln_q is not None else xq
    if isinstance(ln_kv, str):
        kvn = xn
    elif ln_kv is not None:
        kvn = _ln_cuda(lib, xkv, ln_kv, s)
    else:
        kvn = xkv
    q = gemm(xn, wq, bq, _EPI_ROPE)
    k = gemm(kvn, wk, bk, _EPI_ROPE)
    v = gemm(kvn, wv, bv, _EPI_BIAS)
    o = torch.empty_like(q)
    _lib.check(lib.a3r_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), G * B, N, C, num_heads,
                                 D ** -0.5, s), "K1 attention")
    if residual:
        return gemm(o, wo, bo, _EPI_RESID, resid=xq)
    return gemm(o, wo, bo, _EPI_BIAS)


def site_tables(pos, D: int, rope_base, dtype):
    """(N, D) cos/sin for one shared grid; identity tables without RoPE."""
    if rope_base is None:
        N = pos.shape[0]
        return (torch.ones((N, D), dtype=dtype, device=pos.device),
                torch.zeros((N, D), dtype=dtype, device=pos.device))
    return rope_tables(pos, D, rope_base, dtype)


def attention_site(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, pos,
                   num_heads: int, rope_base: float | None = 100.0,
                   ln_q=None, ln_kv=None, residual: bool = False):
    """Fused [LN+] qkv + RoPE + attention + proj [+ residual] (K1).

    xq, xkv: (G, B, N, C) (the same tensor for self-attention); w*: (G, C, C)
    stored (in, out); b*: (G, C); pos: (N, 2) shared by every row. ln_q:
    optional (scale, bias) each (G, C) applied to xq; ln_kv: the same for
    xkv, or "same" to reuse xq's normalised tokens. Returns (G, B, N, C)."""
    D = xq.shape[-1] // num_heads
    cos, sin = site_tables(pos, D, rope_base, xq.dtype)
    return _site(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin, num_heads,
                 ln_q, ln_kv, residual)


def _site(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin, num_heads,
          ln_q, ln_kv, residual):
    if xq.is_cuda:
        out = _site_cuda(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
                         num_heads, ln_q, ln_kv, residual)
        attention_site.launches += 1
        return out
    return site_plain(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
                      num_heads, ln_q, ln_kv, residual)


attention_site.launches = 0


# ------------------------------------------------------------------- K2

def mlp_plain(x, w1, b1, w2, b2, ln=None, residual: bool = False):
    """Plain PyTorch version of K2 (the semantics of the Pallas kernels)."""
    raw = x
    if ln is not None:
        x = _ln(raw, ln)
    h = torch.einsum("gbnc,gcf->gbnf", x.float(), w1.float()) + b1.float()[:, None, None]
    h = torch.nn.functional.gelu(h, approximate="none").to(x.dtype)
    y = _proj(h, w2, b2)
    return raw + y if residual else y


def _mlp_cuda(x, w1, b1, w2, b2, ln, residual):
    G, B, N, C = x.shape
    F = w1.shape[-1]
    lns = {f"ln[{i}]": t for i, t in enumerate(ln or ())}
    _check_cuda("K2", dict(x=x, w1=w1, w2=w2), dict(b1=b1, b2=b2, **lns))
    if C % 128 or F % 128 or C > 1024:
        raise ValueError(f"K2 needs C, F % 128 == 0 and C <= 1024; "
                         f"got C={C}, F={F}")
    lib = _lib.library()
    s = _lib.stream()
    rows = B * N
    x = x.contiguous()
    xn = _ln_cuda(lib, x, ln, s) if ln is not None else x
    h = torch.empty((G, B, N, F), dtype=torch.bfloat16, device=x.device)
    w1 = w1.contiguous()
    w2 = w2.contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    _lib.check(lib.a3r_gemm(xn.data_ptr(), w1.data_ptr(), b1.data_ptr(), None,
                            h.data_ptr(), None, None, G, rows, F, C, _EPI_GELU,
                            0, N, s), "K2 fc1")
    out = torch.empty_like(x)
    _lib.check(lib.a3r_gemm(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                            x.data_ptr() if residual else None, out.data_ptr(),
                            None, None, G, rows, C, F,
                            _EPI_RESID if residual else _EPI_BIAS, 0, N, s),
               "K2 fc2")
    return out


def mlp_site(x, w1, b1, w2, b2, ln=None, residual: bool = False):
    """Fused [LN+] fc1 + GELU + fc2 [+ residual] (K2).

    x: (G, B, N, C); w1: (G, C, F); w2: (G, F, C); b1: (G, F); b2: (G, C);
    ln: optional (scale, bias) each (G, C). GELU is exact (erf)."""
    if x.is_cuda:
        out = _mlp_cuda(x, w1, b1, w2, b2, ln, residual)
        mlp_site.launches += 1
        return out
    return mlp_plain(x, w1, b1, w2, b2, ln, residual)


mlp_site.launches = 0


# ------------------------------------------------- differentiable wrappers
#
# Training with attn_impl="fused" (fused_site.py:419-607): the kernel
# forward (plain version on the CPU), and a backward that is autograd of the
# XLA twins _site_xla / _mlp_xla by recompute. Weights may be fp32 masters:
# both sides cast them to the activation dtype, as the JAX wrappers do, so
# their gradients flow back through the cast. cos/sin get no gradient.

def supported(x, num_heads: int) -> bool:
    """The JAX gate of the fused attention site (fused_site.py:622-633)."""
    G, B, N, C = x.shape
    D = C // num_heads
    working = N * N * 4 + 3 * C * N * 2 + 4 * C * C * 2 + 4 * N * C * 2
    return (C % num_heads == 0 and D % 8 == 0 and 8 <= D <= 128
            and D % 4 == 0 and N % 16 == 0
            and working < 26 * 1024 * 1024)


def mlp_supported(x, hidden: int) -> bool:
    """The JAX gate of the fused MLP site (fused_site.py:363-386): some
    power-of-two split of `hidden` into 128-multiples fits the VMEM gate."""
    *_, N, C = x.shape
    for nf in (1, 2, 4, 8, 16):
        fb = hidden // nf
        if hidden % nf == 0 and fb % 128 == 0 and \
                2 * C * fb * 2 + N * fb * 6 + 4 * N * C * 2 + 4 * N * C < 30 * 2 ** 20:
            return True
    return False


def attention_site_diff(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, pos,
                        num_heads: int, rope_base: float | None = 100.0,
                        ln_q=None, ln_kv=None, residual: bool = False):
    """Differentiable K1: kernel forward, backward = autograd of
    site_plain(twin=True). Same contract as attention_site."""
    D = xq.shape[-1] // num_heads
    cos, sin = site_tables(pos, D, rope_base, xq.dtype)
    same = isinstance(ln_kv, str)
    lns = [*(ln_q or (None, None)), *((None, None) if same or ln_kv is None else ln_kv)]

    def call(fn, xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin, lqs, lqb,
             lks, lkb):
        w = [t.to(xq.dtype) for t in (wq, wk, wv, wo)]
        lq = None if lqs is None else (lqs, lqb)
        lkv = "same" if same else (None if lks is None else (lks, lkb))
        return fn(xq, xkv, *w, bq, bk, bv, bo, cos, sin, num_heads, lq, lkv,
                  residual)

    def twin(*a):
        return call(lambda *b: site_plain(*b, twin=True), *a)

    return KernelWithTwin.apply(lambda *a: call(_site, *a), twin, xq, xkv, wq,
                                wk, wv, wo, bq, bk, bv, bo, cos, sin, *lns)


def mlp_site_diff(x, w1, b1, w2, b2, ln=None, residual: bool = False):
    """Differentiable K2: kernel forward, backward = autograd of mlp_plain
    on the weights cast to x's dtype (the JAX _mlp_xla). Same contract as
    mlp_site."""
    def call(fn, x, w1, b1, w2, b2, lns, lnb):
        return fn(x, w1.to(x.dtype), b1, w2.to(x.dtype), b2,
                  None if lns is None else (lns, lnb), residual)

    return KernelWithTwin.apply(lambda *a: call(mlp_site, *a),
                                lambda *a: call(mlp_plain, *a),
                                x, w1, b1, w2, b2, *(ln or (None, None)))
