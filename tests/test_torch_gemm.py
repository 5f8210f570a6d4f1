"""Port parity: the plain version of K1's and K2's GEMM launch
(align3r_tpu_torch.ops.fused_site.gemm_plain) and the sites composed from the
launches' plain versions.

- The sites composed here from _ln, gemm_plain (every epilogue) and the
  site's attention step equal site_plain / mlp_plain bit for bit, at G = 2
  and a ragged row count (B * N = 135, not a multiple of the 128-row tile).
  The attention step (the Pallas _kernel's: P V times the reciprocal of the
  row sum) and K1's attention launch's plain version site_attention_plain
  (K6's: divided by the sum) agree within the ulp that separates the two.
- The composed sites equal JAX's XLA twins `_site_xla` (fused_site.py:427)
  and `_mlp_xla` (:549), and the Pallas kernels in interpret mode, at one
  small shape, within test_torch_fused_site.py's tolerances: 1e-5 in fp32
  (the same math, sums in another order), 2 bf16 ulps of the output's
  largest magnitude (1.6e-2 x max) in bf16.
- The Python gate's tile constants are the ones written in csrc/gemm.cuh and
  checked by csrc/fused_site.cu's entry; every GEMM of VIT_L_512 passes the
  gate, and an unsupported N, K or RoPE head dim raises.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import fused_site as jfs
from align3r_tpu_torch.models.config import VIT_L_512
from align3r_tpu_torch.models.rope import rotate_halves
from align3r_tpu_torch.ops import fused_site as tfs

torch.set_num_threads(2)

CSRC = Path(tfs.__file__).resolve().parents[1] / "csrc"
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _rng_tensors(seed, G, B, N, C, F, dtype):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((sc * r.standard_normal(s)).astype(np.float32))
    x, kv = f(G, B, N, C).to(dtype), f(G, B, N, C).to(dtype)
    ws = [f(G, C, C, sc=C ** -0.5).to(dtype) for _ in range(4)]
    bs = [f(G, C, sc=0.1) for _ in range(4)]
    mlp = (f(G, C, F, sc=C ** -0.5).to(dtype), f(G, F, sc=0.1), f(G, F, C, sc=F ** -0.5).to(dtype),
           f(G, C, sc=0.1))
    ln = lambda: (1 + f(G, C, sc=0.1), f(G, C, sc=0.1))
    return x, kv, ws, bs, mlp, ln(), ln()


def _tables(N, D, dtype, seed=9):
    r = np.random.default_rng(seed)
    ang = torch.from_numpy(r.uniform(0, 6.3, (N, D)).astype(np.float32))
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _composed_site(x, kv, ws, bs, cos, sin, H, ln_q, ln_kv, residual,
                   attention=tfs.site_attention_step):
    """K1 as its launches run it: LN, q/k GEMMs with RoPE, v GEMM, the
    attention, the out-projection GEMM [+ residual]."""
    G, B, N, C = x.shape
    xn = tfs._ln(x, ln_q) if ln_q is not None else x
    kvn = xn if ln_kv == "same" else (tfs._ln(kv, ln_kv) if ln_kv is not None else kv)
    rope = dict(cos=cos, sin=sin, rope_d=C // H, rope_n=N)
    q = tfs.gemm_plain(xn, ws[0], bs[0], tfs.EPI_ROPE, **rope)
    k = tfs.gemm_plain(kvn, ws[1], bs[1], tfs.EPI_ROPE, **rope)
    v = tfs.gemm_plain(kvn, ws[2], bs[2], tfs.EPI_BIAS)
    o = attention(q, k, v, H)
    if residual:
        return tfs.gemm_plain(o, ws[3], bs[3], tfs.EPI_RESID, resid=x)
    return tfs.gemm_plain(o, ws[3], bs[3], tfs.EPI_BIAS)


def _composed_mlp(x, w1, b1, w2, b2, ln, residual):
    xn = tfs._ln(x, ln) if ln is not None else x
    h = tfs.gemm_plain(xn, w1, b1, tfs.EPI_GELU)
    if residual:
        return tfs.gemm_plain(h, w2, b2, tfs.EPI_RESID, resid=x)
    return tfs.gemm_plain(h, w2, b2, tfs.EPI_BIAS)


SITE_VARIANTS = {"self_same_ln_residual": ("same", True, False),
                 "self_plain": (None, False, False),
                 "cross_ln_residual": ("ln", True, True),
                 "cross_no_kv_ln": (None, False, True)}


@pytest.mark.parametrize("variant", list(SITE_VARIANTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_site_plain_is_its_launches_composed(variant, dtype):
    """G = 2, B * N = 3 * 45 = 135 rows, D = 64: bit for bit."""
    G, B, N, H, D = 2, 3, 45, 2, 64
    C = H * D
    tdt = DTYPES[dtype][0]
    x, kv, ws, bs, _, lnq, lnkv = _rng_tensors(1, G, B, N, C, 4 * C, tdt)
    kv_mode, residual, cross = SITE_VARIANTS[variant]
    ln_q = lnq if residual else None
    ln_kv = {"same": "same", "ln": lnkv, None: None}[kv_mode]
    kv = kv if cross else x
    cos, sin = _tables(N, D, tdt)
    got = _composed_site(x, kv, ws, bs, cos, sin, H, ln_q, ln_kv, residual)
    ref = tfs.site_plain(x, kv, *ws, *bs, cos, sin, H, ln_q=ln_q, ln_kv=ln_kv,
                         residual=residual)
    assert got.dtype == tdt and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_site_attention_step_is_the_launch_within_an_ulp(dtype):
    """site_plain's attention step against K1's attention launch's plain
    version on the same q, k, v (G = 2, 135 rows, D = 64): P V times the
    reciprocal of the row sum against P V over it, at most one ulp of the
    output's dtype apart in each element (fp32: 2 fp32 ulps, the reciprocal's
    rounding and the product's; bf16: one bf16 rounding flipped)."""
    G, B, N, H, D = 2, 3, 45, 2, 64
    tdt = DTYPES[dtype][0]
    r = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(r.standard_normal((G, B, N, H * D)).astype(np.float32)).to(tdt)
               for _ in range(3))
    step = tfs.site_attention_step(q, k, v, H).float()
    launch = tfs.site_attention_plain(q, k, v, H).float()
    ulp = 2.0 ** (-22 if dtype == "fp32" else -7)
    assert ((step - launch).abs() <= ulp * launch.abs()).all()


@pytest.mark.parametrize("ln_res", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_plain_is_its_launches_composed(ln_res, dtype):
    G, B, N, C, F = 2, 3, 45, 128, 512
    tdt = DTYPES[dtype][0]
    x, _, _, _, (w1, b1, w2, b2), ln, _ = _rng_tensors(2, G, B, N, C, F, tdt)
    use_ln, residual = ln_res
    ln = ln if use_ln else None
    got = _composed_mlp(x, w1, b1, w2, b2, ln, residual)
    assert got.dtype == tdt and torch.equal(got, tfs.mlp_plain(x, w1, b1, w2, b2, ln, residual))


@pytest.mark.parametrize("epi", ["bias", "rope", "gelu", "resid"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gemm_plain_epilogues(epi, dtype):
    """Each epilogue against its rounding order written out here, on a
    (G, M, K) = (2, 135, 128) input: the product and bias in fp32; then a
    rounding to the input's dtype (bias), exact-erf GELU before it (gelu),
    resid + the rounded value in the dtype (resid), or per 64-column head
    bf16r(t cos) + bf16r(rotate_halves(t) sin) with t rounded and the table
    row m % rope_n (rope)."""
    G, M, K, N, rope_n = 2, 135, 128, 256, 45
    tdt = DTYPES[dtype][0]
    r = np.random.default_rng(3)
    f = lambda *s, sc=1.0: torch.from_numpy((sc * r.standard_normal(s)).astype(np.float32))
    a, w, bias = f(G, M, K).to(tdt), f(G, K, N, sc=K ** -0.5).to(tdt), f(G, N, sc=0.1)
    resid = f(G, M, N).to(tdt)
    cos, sin = _tables(rope_n, 64, tdt)
    e = {"bias": tfs.EPI_BIAS, "rope": tfs.EPI_ROPE, "gelu": tfs.EPI_GELU,
         "resid": tfs.EPI_RESID}[epi]
    got = tfs.gemm_plain(a, w, bias, e, resid=resid, cos=cos, sin=sin, rope_d=64, rope_n=rope_n)
    acc = torch.bmm(a.float(), w.float()) + bias[:, None]
    if epi == "gelu":
        ref = (0.5 * acc * (1 + torch.erf(acc * 0.7071067811865476))).to(tdt)
        # F.gelu and the erf formula may differ by an fp32 ulp before rounding
        assert (got.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
        return
    t = acc.to(tdt)
    if epi == "resid":
        ref = (resid.float() + t.float()).to(tdt)
    elif epi == "rope":
        tok = torch.arange(M) % rope_n
        th = t.reshape(G, M, N // 64, 64)
        rot = rotate_halves(th)
        ref = ((th.float() * cos[tok][:, None].float()).to(tdt).float()
               + (rot.float() * sin[tok][:, None].float()).to(tdt).float()).to(tdt)
        ref = ref.reshape(G, M, N)
    else:
        ref = t
    assert got.shape == (G, M, N) and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_composed_sites_match_jax_xla_twins(dtype):
    """The composed K1 (self site with LN and residual) and K2 against
    _site_xla and _mlp_xla at D = 16, N = 32, G = 2."""
    G, B, N, H, D = 2, 2, 32, 4, 16
    C, F = H * D, 4 * H * D
    tdt, jdt = DTYPES[dtype]
    x, _, ws, bs, (w1, b1, w2, b2), ln, _ = _rng_tensors(4, G, B, N, C, F, torch.float32)
    ys, xs = np.meshgrid(np.arange(4), np.arange(8), indexing="ij")
    pos = np.stack([ys, xs], -1).reshape(N, 2).astype(np.int32)
    jcos, jsin = jfs._rope_tables(jnp.asarray(pos), D, 100.0, jdt)
    cos, sin = tfs.site_tables(torch.from_numpy(pos), D, 100.0, tdt)
    j = lambda t: jnp.asarray(t.numpy())
    lnp = jnp.stack([j(ln[0]), j(ln[1])], 1)
    ref = jfs._site_xla(jnp.asarray(x.numpy(), jdt), jnp.asarray(x.numpy(), jdt),
                        *[j(w) for w in ws], *[j(b) for b in bs], jcos, jsin, lnp,
                        jnp.zeros_like(lnp), H, True, "same", True, D ** -0.5)
    got = _composed_site(x.to(tdt), x.to(tdt), [w.to(tdt) for w in ws], bs, cos, sin, H,
                         ln, "same", True)
    refm = jfs._mlp_xla(jnp.asarray(x.numpy(), jdt), j(w1), j(b1), j(w2), j(b2), lnp, True, True)
    gotm = _composed_mlp(x.to(tdt), w1.to(tdt), b1, w2.to(tdt), b2, ln, True)
    for g, r in ((got, ref), (gotm, refm)):
        r = np.asarray(r.astype(jnp.float32))
        g = g.float().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(g - r).max() <= 1.6e-2 * np.abs(r).max()


def test_composed_sites_match_pallas_interpret():
    """The composed K1 (cross site, both LayerNorms, residual) and K2 (LN,
    residual) against the Pallas kernels in interpret mode, fp32."""
    G, B, N, H, D = 2, 2, 32, 4, 16
    C, F = H * D, 128
    x, kv, ws, bs, (w1, b1, w2, b2), lnq, lnkv = _rng_tensors(5, G, B, N, C, F, torch.float32)
    ys, xs = np.meshgrid(np.arange(4), np.arange(8), indexing="ij")
    pos = np.stack([ys, xs], -1).reshape(N, 2).astype(np.int32)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jfs.attention_site(j(x), j(kv), *[j(w) for w in ws], *[j(b) for b in bs],
                             jnp.asarray(pos), H, 100.0, interpret=True,
                             ln_q=(j(lnq[0]), j(lnq[1])), ln_kv=(j(lnkv[0]), j(lnkv[1])),
                             residual=True)
    cos, sin = tfs.site_tables(torch.from_numpy(pos), D, 100.0, torch.float32)
    got = _composed_site(x, kv, ws, bs, cos, sin, H, lnq, lnkv, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    refm = jfs.mlp_site(j(x), j(w1), j(b1), j(w2), j(b2), ln=(j(lnq[0]), j(lnq[1])),
                        residual=True, interpret=True)
    gotm = _composed_mlp(x, w1, b1, w2, b2, lnq, True)
    np.testing.assert_allclose(gotm.numpy(), np.asarray(refm), rtol=1e-5, atol=1e-5)


def test_gate_constants_are_the_kernels():
    """GEMM_BM, GEMM_BN, GEMM_BK, GEMM_ROPE_D and the epilogue numbers are
    gemm.cuh's GBM, GBN, GBK, GEMM_ROPE_D and enum Epilogue, and the C entry
    refuses what the gate refuses (K % GBK, N % GBN, the RoPE head dim)."""
    cuh = (CSRC / "gemm.cuh").read_text()
    cu = (CSRC / "fused_site.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", cuh).group(1))
    assert (tfs.GEMM_BM, tfs.GEMM_BN, tfs.GEMM_BK, tfs.GEMM_ROPE_D) == (
        const("GBM"), const("GBN"), const("GBK"), const("GEMM_ROPE_D"))
    epis = dict(re.findall(r"(EPI_BIAS\w*) = (\d+),", cuh))
    assert {k: int(v) for k, v in epis.items()} == {
        "EPI_BIAS": tfs.EPI_BIAS, "EPI_BIAS_ROPE": tfs.EPI_ROPE,
        "EPI_BIAS_GELU": tfs.EPI_GELU, "EPI_BIAS_RESID": tfs.EPI_RESID}
    entry = cu[cu.index("A3R_EXPORT int a3r_gemm("):]
    for check in ("K % GBK", "N % GBN", "rope_d != GEMM_ROPE_D"):
        assert check in entry[:entry.index("switch (epi)")]
    assert "gemm_kernel" not in cuh + cu and "wmma" not in cuh.lower()


def _vit_l_gemms():
    """(name, G, N, K, epi, rope_d) of every GEMM launch of VIT_L_512's sites:
    the encoder blocks (1 stream), the decoder layers (2 streams; self and
    cross sites) and the prior branch's blocks (1 stream, decoder width)."""
    cfg = VIT_L_512
    out = []
    for name, G, C, H in (("encoder", 1, cfg.enc_embed_dim, cfg.enc_num_heads),
                          ("decoder", 2, cfg.dec_embed_dim, cfg.dec_num_heads),
                          ("prior branch", 1, cfg.dec_embed_dim, cfg.dec_num_heads)):
        F = int(C * cfg.mlp_ratio)
        out += [(f"{name} q/k", G, C, C, tfs.EPI_ROPE, C // H),
                (f"{name} v", G, C, C, tfs.EPI_BIAS, 0),
                (f"{name} out-projection", G, C, C, tfs.EPI_RESID, 0),
                (f"{name} fc1", G, F, C, tfs.EPI_GELU, 0),
                (f"{name} fc2", G, C, F, tfs.EPI_RESID, 0)]
    return out


@pytest.mark.parametrize("rows", [1, 135, 9216, 18432, 36864])
def test_every_vit_l_gemm_passes_the_gate(rows):
    for name, G, N, K, epi, rope_d in _vit_l_gemms():
        tfs.gemm_check(G, rows, N, K, epi, rope_d)


@pytest.mark.parametrize("bad", [dict(N=96), dict(N=1000), dict(K=96), dict(K=32),
                                 dict(rope_d=32), dict(M=0), dict(epi=4)])
def test_gate_refuses_unsupported_shapes(bad):
    args = dict(G=2, M=135, N=768, K=768, epi=tfs.EPI_ROPE, rope_d=64)
    args.update(bad)
    with pytest.raises(ValueError):
        tfs.gemm_check(**args)


def test_gemm_wrapper_on_the_cpu_takes_gemm_plain():
    """A CPU call computes gemm_plain and counts no launch."""
    G, M, K, N = 2, 135, 128, 128
    r = np.random.default_rng(6)
    a = torch.from_numpy(r.standard_normal((G, 3, 45, K)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.standard_normal((G, K, N)).astype(np.float32)).bfloat16()
    bias = torch.zeros(G, N)
    before = tfs.gemm.launches
    out = tfs.gemm(a, w, bias, tfs.EPI_GELU)
    assert tfs.gemm.launches == before and out.shape == (G, 3, 45, N)
    assert torch.equal(out, tfs.gemm_plain(a.reshape(G, M, K), w, bias, tfs.EPI_GELU)
                       .reshape(G, 3, 45, N))
