"""Fused attention and MLP sites: kernels K1 and K2, each beside its plain
PyTorch version (port of align3r_tpu/ops/fused_site.py).

K1 ``attention_site`` replaces the Pallas ``_kernel`` (fused_site.py:78,
called through ``_call`` :170-221): [LN] -> q/k/v projection + bias -> RoPE2D
from one shared (N, 2) grid -> fp32 softmax(q k^T D^-1/2), P rounded to the
activation dtype before PV -> out-projection + bias [+ residual].

K2 ``mlp_site`` replaces ``_mlp_kernel`` (:242) and ``_mlp_fblock_kernel``
(:289): [LN] -> fc1 + bias -> exact-erf GELU -> fc2 + bias [+ residual].

The CUDA implementation (csrc/fused_site.cu, csrc/gemm.cuh) runs each site as
several hand-written launches: a LayerNorm kernel, GEMMs on one Hopper core
with the epilogues fused (bias, bias + RoPE, bias + GELU, bias + residual;
``gemm``: a TMA-fed ring, wgmma with register accumulators, the epilogues in
registers, TMA stores) and an attention launch on the exact-max policy of
csrc/sm90_attention.cuh, K6's per-block code on the (rows, N, C) layout
(``site_attention``). Each launch has its plain version (``gemm_plain``,
``site_attention_plain``, ``_ln``). ``site_plain`` / ``mlp_plain`` are
built from ``_ln`` and ``gemm_plain``, with the Pallas kernel's attention
step (``site_attention_step``, within an ulp of ``site_attention_plain``),
so a site and its GEMM launches share one oracle. What bounds each launch
and what the design does about it is written at the top of those files.

Tensor parallelism (parallel/shardings.py): on a rank of a model group of
m, ``attention_partial`` and ``mlp_partial`` run a site on the rank's H / m
heads or F / m hidden units and end in an fp32 partial of the out-projection
or fc2 with no bias (``EPI_PARTIAL``); the sum of the ranks' partials,
finished by ``finish`` (bf16(resid + bf16(sum + bias))), is the whole site up
to the order of the fp32 sums. They count on the sites' ``launches``.

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

# the GEMM's epilogues (csrc/gemm.cuh, enum Epilogue)
EPI_BIAS, EPI_ROPE, EPI_GELU, EPI_RESID, EPI_PARTIAL = 0, 1, 2, 3, 5
# its tile (gemm.cuh: GBM, GBN, GBK), the step of N for the bias, RoPE and
# partial epilogues (GBN_TAIL: their last tile may be 64 wide) and the head
# dim of its RoPE epilogue
GEMM_BM, GEMM_BN, GEMM_BK, GEMM_ROPE_D = 128, 128, 64, 64
GEMM_BN_TAIL = 64


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


def gemm_plain(a, w, bias, epi, resid=None, cos=None, sin=None, rope_d=0, rope_n=0):
    """Plain version of one GEMM launch, in the kernel's rounding order:
    a (G, ..., K) @ w (G, K, N) in fp32; EPI_PARTIAL returns that in fp32
    (bias unread, may be None); the others add bias (G, N) fp32, then
      EPI_BIAS   rounded to a's dtype;
      EPI_ROPE   t rounded, then t cos + rotate_halves(t) sin per rope_d-wide
                 head, each product and the sum in a's dtype, with the (rope_n,
                 rope_d) tables' row (row index % rope_n) for each row;
      EPI_GELU   exact-erf GELU in fp32, then rounded;
      EPI_RESID  rounded, then resid + it in a's dtype.
    Returns (G, ..., N) in a's dtype."""
    G, K = a.shape[0], a.shape[-1]
    lead = a.shape[1:-1]
    t = torch.einsum("gmk,gkn->gmn", a.reshape(G, -1, K).float(), w.float())
    if epi == EPI_PARTIAL:
        return t.reshape(G, *lead, -1)
    t = t + bias.float()[:, None]
    y = (torch.nn.functional.gelu(t, approximate="none") if epi == EPI_GELU else t)
    y = y.to(a.dtype)
    if epi == EPI_RESID:
        y = resid.reshape(y.shape) + y
    elif epi == EPI_ROPE:
        M, N = y.shape[1:]
        tok = torch.arange(M, device=y.device) % rope_n
        yh = y.reshape(G, M, N // rope_d, rope_d)
        y = (yh * cos[tok][:, None] + rotate_halves(yh) * sin[tok][:, None]).reshape(G, M, N)
    return y.reshape(G, *lead, -1)


def gemm_check(G: int, M: int, N: int, K: int, epi: int, rope_d: int = 0) -> None:
    """The GEMM kernel's gate (a3r_gemm's checks): raises ValueError for a
    shape or epilogue it does not take. Every product of the sites passes it
    (C % 128 == 0, F % 128 == 0, D == 64), and so does every product of a
    rank's split sites (q/k/v C / m wide, a multiple of 64; fc1 F / m, of
    128)."""
    if epi not in (EPI_BIAS, EPI_ROPE, EPI_GELU, EPI_RESID, EPI_PARTIAL):
        raise ValueError(f"unknown GEMM epilogue {epi}")
    step = GEMM_BN_TAIL if epi in (EPI_BIAS, EPI_ROPE, EPI_PARTIAL) else GEMM_BN
    if G < 1 or M < 1 or K < GEMM_BK or K % GEMM_BK or N < step or N % step:
        raise ValueError(f"the GEMM needs K % {GEMM_BK} == 0, N % {step} == 0 (epilogue "
                         f"{epi}) and G, M >= 1; got G={G} M={M} N={N} K={K}")
    if epi == EPI_ROPE and rope_d != GEMM_ROPE_D:
        raise ValueError(f"the RoPE epilogue needs a head dim of {GEMM_ROPE_D}; got {rope_d}")


def _gemm_cuda(a, w, bias, epi, resid=None, cos=None, sin=None, rope_d=0, rope_n=0):
    """One launch of gemm.cuh's kernel on contiguous bf16 a (G, ..., K), w
    (G, K, N); bias (G, N) of any float dtype (None for EPI_PARTIAL, whose
    output is fp32)."""
    G, K = a.shape[0], a.shape[-1]
    M = a.numel() // (G * K)
    N = w.shape[-1]
    gemm_check(G, M, N, K, epi, rope_d)
    out = torch.empty((*a.shape[:-1], N), device=a.device,
                      dtype=torch.float32 if epi == EPI_PARTIAL else torch.bfloat16)
    b = None if epi == EPI_PARTIAL else _lib.dense(bias.float())
    ptr = lambda t: None if t is None else t.data_ptr()
    _lib.check(_lib.library().a3r_gemm(
        a.data_ptr(), w.data_ptr(), ptr(b), ptr(resid), out.data_ptr(), ptr(cos),
        ptr(sin), G, M, N, K, epi, rope_d, rope_n, _lib.stream()), "GEMM")
    gemm.launches += 1
    return out


def gemm(a, w, bias, epi, resid=None, cos=None, sin=None, rope_d=0, rope_n=0):
    """One GEMM launch of K1 / K2 alone: C = epilogue(a @ w) (gemm_plain's
    contract). bf16 CUDA tensors launch the kernel (gemm.launches counts every
    launch of it, the sites' included); CPU tensors take gemm_plain."""
    tensors = dict(a=a, w=w, bias=bias, resid=resid, cos=cos, sin=sin)
    given = {k: t for k, t in tensors.items() if t is not None}
    if not a.is_cuda:
        if any(t.is_cuda for t in given.values()):
            raise ValueError("gemm: a is on the CPU and another tensor on the card")
        return gemm_plain(a, w, bias, epi, resid, cos, sin, rope_d, rope_n)
    if bias is None and epi != EPI_PARTIAL:
        raise ValueError("gemm: this epilogue needs a bias")
    _check_cuda("GEMM", {k: t for k, t in given.items() if k != "bias"},
                {k: t for k, t in given.items() if k == "bias"})
    if w.dim() != 3 or w.shape[0] != a.shape[0] or w.shape[1] != a.shape[-1]:
        raise ValueError(f"gemm needs a (G, ..., K) and w (G, K, N); got {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    if resid is not None and resid.shape != (*a.shape[:-1], w.shape[-1]):
        raise ValueError(f"gemm: resid {tuple(resid.shape)} is not the output's shape")
    if epi == EPI_RESID and resid is None:
        raise ValueError("gemm: the residual epilogue needs resid")
    if epi == EPI_ROPE and (cos is None or sin is None or cos.shape != (rope_n, rope_d)
                            or sin.shape != cos.shape):
        raise ValueError(f"gemm: RoPE needs cos and sin of shape (rope_n, rope_d) = "
                         f"({rope_n}, {rope_d})")
    return _gemm_cuda(_lib.dense(a), _lib.dense(w), bias, epi,
                      *(None if t is None else _lib.dense(t) for t in (resid, cos, sin)),
                      rope_d, rope_n)


gemm.launches = 0


# ------------------------------------------------------------------- K1

def site_attention_step(q, k, v, num_heads: int, twin: bool = False):
    """site_plain's attention on q, k, v (G, B, N, C), heads side by side:
    the Pallas _kernel's (fused_site.py:139-153), P rounded to v's dtype and
    P V times the reciprocal of the row sum of the unrounded p; K1's attention
    launch, site_attention_plain and K6 divide by the sum instead, which can
    differ in the last fp32 bit. twin=True: _site_xla's (p / s rounded before
    P V, the output rounded)."""
    G, B, N, C = q.shape
    H = num_heads
    D = C // H

    def heads(t):
        return t.reshape(G, B, N, H, D)

    logits = torch.einsum("gbqhd,gbkhd->gbhqk", heads(q).float(), heads(k).float()) * D ** -0.5
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    if twin:
        pn = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
        oh = torch.einsum("gbhqk,gbkhd->gbqhd", pn.float(), heads(v).float())
        return oh.to(v.dtype).reshape(G, B, N, C)
    rs = 1.0 / p.sum(dim=-1)                                # (G,B,H,Nq)
    oh = torch.einsum("gbhqk,gbkhd->gbqhd", p.to(v.dtype).float(), heads(v).float())
    return (oh * rs.permute(0, 1, 3, 2)[..., None]).to(q.dtype).reshape(G, B, N, C)


def site_plain(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
               num_heads: int, ln_q=None, ln_kv=None, residual: bool = False,
               twin: bool = False):
    """Plain PyTorch version of K1 (the semantics of the Pallas _kernel),
    composed of its launches' plain versions: _ln, gemm_plain (q and k with
    RoPE, v, the out-projection [+ residual]) and site_attention_step.
    cos/sin: (N, D) tables in xq's dtype. bo=None: a rank's share of a site
    split over heads (w* q/k/v columns and wo rows of its num_heads heads):
    the out-projection's fp32 partial, no bias (EPI_PARTIAL), returned before
    any residual. twin=True gives the XLA twin
    _site_xla (fused_site.py:427-473) instead, whose autograd is the backward
    of attention_site_diff: it rounds p / s, not p, to v's dtype before P V,
    and rounds the attention output before the projection."""
    raw = xq
    xq = _ln(raw, ln_q) if ln_q is not None else raw
    if isinstance(ln_kv, str):
        xkv = xq
    elif ln_kv is not None:
        xkv = _ln(xkv, ln_kv)
    N = xq.shape[-2]
    D = wq.shape[-1] // num_heads
    q = gemm_plain(xq, wq, bq, EPI_ROPE, cos=cos, sin=sin, rope_d=D, rope_n=N)
    k = gemm_plain(xkv, wk, bk, EPI_ROPE, cos=cos, sin=sin, rope_d=D, rope_n=N)
    v = gemm_plain(xkv, wv, bv, EPI_BIAS)
    o = site_attention_step(q, k, v, num_heads, twin)
    if bo is None:
        return gemm_plain(o, wo, None, EPI_PARTIAL)
    return gemm_plain(o, wo, bo, EPI_RESID if residual else EPI_BIAS, resid=raw)


def _ln_cuda(lib, x, p, s):
    """K1/K2's LayerNorm launch on bf16 x (G, B, N, C), C % 8 == 0
    and C <= 1024; p = (scale, bias) each (G, C). Its plain version is _ln;
    each launch counts on _ln_cuda.launches."""
    G, B, N, C = x.shape
    x = _lib.dense(x)
    y = torch.empty_like(x)
    scale, bias = (_lib.dense(t.float()) for t in p)
    _lib.check(lib.a3r_layernorm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                 B * N, G * B * N, C, 1e-6, s), "layernorm")
    _ln_cuda.launches += 1
    return y


_ln_cuda.launches = 0


def site_attention_plain(q, k, v, num_heads: int):
    """Plain version of K1's attention launch: q, k, v (..., N, C) with head h
    at columns h D .. h D + D - 1; the exact row max, P rounded to v's dtype
    before P V, then / the sum of the unrounded p (K6's function per head)."""
    *lead, N, C = q.shape
    D = C // num_heads

    def heads(t):
        return t.reshape(-1, N, num_heads, D).transpose(1, 2)

    logits = torch.einsum("bhqd,bhkd->bhqk", heads(q).float(), heads(k).float()) * D ** -0.5
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), heads(v).float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2).reshape(*lead, N, C)


def _site_attention_cuda(q, k, v, num_heads):
    """K1's attention launch on contiguous bf16 q, k, v (..., N, C), D = 64:
    the EXACT policy of csrc/sm90_attention.cuh, K6's per-block code."""
    N, C = q.shape[-2:]
    o = torch.empty_like(q)
    _lib.check(_lib.library().a3r_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.numel() // (N * C), N, C,
        num_heads, (C // num_heads) ** -0.5, _lib.stream()), "K1 attention")
    return o


def site_attention(q, k, v, num_heads: int):
    """K1's attention launch alone, on (..., N, C) bf16 tensors with the
    heads side by side (D = 64) on the card; its plain version on the CPU.
    The site's counter (attention_site.launches) counts whole sites, so this
    counts nothing."""
    if not q.is_cuda:
        return site_attention_plain(q, k, v, num_heads)
    _check_cuda("K1 attention", dict(q=q, k=k, v=v), {})
    if q.shape != k.shape or k.shape != v.shape or q.shape[-1] != 64 * num_heads:
        raise ValueError(f"K1's attention needs q, k, v of one shape (..., N, 64 H); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{num_heads} heads")
    return _site_attention_cuda(*(_lib.dense(t) for t in (q, k, v)), num_heads)


def _site_cuda(xq, xkv, wq, wk, wv, wo, bq, bk, bv, bo, cos, sin,
               num_heads, ln_q, ln_kv, residual):
    """K1's launches; bo=None: a rank's share, the fp32 partial (site_plain)."""
    G, B, N, C = xq.shape
    Cl = wq.shape[-1]   # q/k/v width: C, or C / m on a rank of a model group
    D = Cl // num_heads
    lns = {f"{n}[{i}]": t for n, p in (("ln_q", ln_q), ("ln_kv", ln_kv))
           if p is not None and not isinstance(p, str) for i, t in enumerate(p)}
    _check_cuda("K1", dict(xq=xq, xkv=xkv, wq=wq, wk=wk, wv=wv, wo=wo, cos=cos, sin=sin),
                dict(bq=bq, bk=bk, bv=bv, **({} if bo is None else dict(bo=bo)), **lns))
    if (D != 64 or Cl % 64 or C % 128 or C > 1024 or xkv.shape != xq.shape
            or wo.shape[-2:] != (Cl, C)):
        raise ValueError(f"K1 needs D == 64, C % 128 == 0, C <= 1024, equal q/kv shapes "
                         f"and wo (.., {Cl}, {C}); got {tuple(xq.shape)}, {num_heads} heads "
                         f"of q/k/v width {Cl}, kv {tuple(xkv.shape)}, wo {tuple(wo.shape)}")
    lib = _lib.library()
    s = _lib.stream()
    xq = xq.contiguous()
    xkv = xkv.contiguous()
    cos = cos.contiguous()
    sin = sin.contiguous()
    xn = _ln_cuda(lib, xq, ln_q, s) if ln_q is not None else xq
    if isinstance(ln_kv, str):
        kvn = xn
    elif ln_kv is not None:
        kvn = _ln_cuda(lib, xkv, ln_kv, s)
    else:
        kvn = xkv
    w = [t.contiguous() for t in (wq, wk, wv, wo)]
    rope = dict(cos=cos, sin=sin, rope_d=D, rope_n=N)
    q = _gemm_cuda(xn, w[0], bq, EPI_ROPE, **rope)
    k = _gemm_cuda(kvn, w[1], bk, EPI_ROPE, **rope)
    v = _gemm_cuda(kvn, w[2], bv, EPI_BIAS)
    o = _site_attention_cuda(q, k, v, num_heads)
    if bo is None:
        return _gemm_cuda(o, w[3], None, EPI_PARTIAL)
    if residual:
        return _gemm_cuda(o, w[3], bo, EPI_RESID, resid=xq)
    return _gemm_cuda(o, w[3], bo, EPI_BIAS)


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
    """Plain PyTorch version of K2 (the semantics of the Pallas kernels),
    composed of its launches' plain versions: _ln, gemm_plain with GELU,
    gemm_plain [+ residual]. b2=None: a rank's share of a site split over the
    hidden units (w1 columns, b1 and w2 rows of its F / m): fc2's fp32
    partial, no bias (EPI_PARTIAL)."""
    raw = x
    if ln is not None:
        x = _ln(raw, ln)
    h = gemm_plain(x, w1, b1, EPI_GELU)
    if b2 is None:
        return gemm_plain(h, w2, None, EPI_PARTIAL)
    return gemm_plain(h, w2, b2, EPI_RESID if residual else EPI_BIAS, resid=raw)


def _mlp_cuda(x, w1, b1, w2, b2, ln, residual):
    """K2's launches; b2=None: a rank's share, the fp32 partial (mlp_plain)."""
    G, B, N, C = x.shape
    F = w1.shape[-1]   # F, or F / m on a rank of a model group
    lns = {f"ln[{i}]": t for i, t in enumerate(ln or ())}
    _check_cuda("K2", dict(x=x, w1=w1, w2=w2),
                dict(b1=b1, **({} if b2 is None else dict(b2=b2)), **lns))
    if C % 128 or F % 128 or C > 1024 or w2.shape[-2:] != (F, C):
        raise ValueError(f"K2 needs C, F % 128 == 0, C <= 1024 and w2 "
                         f"(.., F, C); got C={C}, F={F}, w2 {tuple(w2.shape)}")
    x = x.contiguous()
    xn = _ln_cuda(_lib.library(), x, ln, _lib.stream()) if ln is not None else x
    h = _gemm_cuda(xn, w1.contiguous(), b1, EPI_GELU)
    if b2 is None:
        return _gemm_cuda(h, w2.contiguous(), None, EPI_PARTIAL)
    if residual:
        return _gemm_cuda(h, w2.contiguous(), b2, EPI_RESID, resid=x)
    return _gemm_cuda(h, w2.contiguous(), b2, EPI_BIAS)


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


# ------------------------------------------------- tensor-parallel sites

def attention_partial(xq, xkv, wq, wk, wv, wo, bq, bk, bv, pos, num_heads: int,
                      rope_base: float | None = 100.0, ln_q=None, ln_kv=None):
    """One rank's share of a K1 site split over heads: attention_site's
    launches on wq/wk/wv (G, C, C / m), bq/bk/bv (G, C / m), the rank's
    num_heads = H / m heads, and wo (G, C / m, C), ending in the
    out-projection's fp32 partial (G, B, N, C) without bias. Counts on
    attention_site.launches; CPU tensors take site_plain(bo=None)."""
    cos, sin = site_tables(pos, wq.shape[-1] // num_heads, rope_base, xq.dtype)
    return _site(xq, xkv, wq, wk, wv, wo, bq, bk, bv, None, cos, sin, num_heads,
                 ln_q, ln_kv, False)


def mlp_partial(x, w1, b1, w2, ln=None):
    """One rank's share of a K2 site split over the hidden units: mlp_site's
    launches on w1 (G, C, F / m), b1 (G, F / m) and w2 (G, F / m, C), ending
    in fc2's fp32 partial (G, B, N, C) without bias. Counts on
    mlp_site.launches; CPU tensors take mlp_plain(b2=None)."""
    return mlp_site(x, w1, b1, w2, None, ln)


def finish_plain(s, bias, dtype, resid=None):
    """Plain version of the finishing pass: s (G, ..., N) fp32, the sum of
    the ranks' partials; bias (G, N) fp32. bf16(resid + bf16(s + bias)) in
    resid's dtype, or (s + bias) rounded to `dtype` without resid: gemm_plain's
    EPI_RESID and EPI_BIAS after the product."""
    G = s.shape[0]
    y = (s.float() + bias.float().reshape(G, *([1] * (s.dim() - 2)), -1)).to(dtype)
    return y if resid is None else resid + y


def finish(s, bias, dtype, resid=None):
    """The finishing pass of a split site (csrc/fused_site.cu finish_kernel)
    on CUDA tensors: fp32 s (G, ..., N), N % 8 == 0, bf16 out; finish_plain
    on CPU ones. Each launch counts on finish.launches."""
    if not s.is_cuda:
        return finish_plain(s, bias, dtype, resid)
    given = {} if resid is None else dict(resid=resid)
    _check_cuda("the finishing pass", given, dict(bias=bias))
    G, N = s.shape[0], s.shape[-1]
    if (dtype != torch.bfloat16 or s.dtype != torch.float32 or N % 8 or bias.shape != (G, N)
            or (resid is not None and resid.shape != s.shape)):
        raise ValueError(f"the finishing pass takes fp32 s (G, ..., N), N % 8 == 0, bias (G, N) "
                         f"and a bf16 output and resid like s; got s {tuple(s.shape)} "
                         f"{s.dtype}, bias {tuple(bias.shape)}, {dtype}")
    s = _lib.dense(s)
    r = None if resid is None else _lib.dense(resid)
    y = torch.empty(s.shape, dtype=torch.bfloat16, device=s.device)
    b = _lib.dense(bias.float())
    rows = s.numel() // N
    _lib.check(_lib.library().a3r_finish(
        s.data_ptr(), b.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(),
        rows // G, rows, N, _lib.stream()), "finishing pass")
    finish.launches += 1
    return y


finish.launches = 0


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
