"""Port parity: the plain versions of kernels K1 (attention site) and K2 (MLP
site) in align3r_tpu_torch.ops.fused_site against align3r_tpu.ops.fused_site.

Oracles: the XLA twins `_site_xla` (fused_site.py:427) and `_mlp_xla` (:549),
and the Pallas kernels themselves in interpret mode at one small shape
(D = 16, N = 32). Tolerances:
- fp32 inputs: 1e-5 — the same math, sums in another order;
- bf16 inputs: 2 bf16 ulps of the output's largest magnitude (1.6e-2 x max)
  — both sides round q, k, v, P and the output to bf16, the XLA twin
  normalises P before that rounding (the kernel and the port after it), and
  one flipped rounding of an intermediate moves the output by an ulp.
On the CPU the public wrappers take the plain version and count no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import fused_site as jfs
from align3r_tpu_torch.ops import fused_site as tfs

torch.set_num_threads(2)

G, B, H, D = 2, 2, 4, 16
C = H * D
GH, GW = 4, 8
N = GH * GW
F = 4 * C


def _pos():
    ys, xs = np.meshgrid(np.arange(GH), np.arange(GW), indexing="ij")
    return np.stack([ys, xs], -1).reshape(N, 2).astype(np.int32)


def _site_inputs(seed, cross):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    x = f(G, B, N, C)
    kv = f(G, B, N, C) if cross else x
    ws = [f(G, C, C, sc=C ** -0.5) for _ in range(4)]
    bs = [f(G, C, sc=0.1) for _ in range(4)]
    lnq = (1 + f(G, C, sc=0.1), f(G, C, sc=0.1))
    lnkv = (1 + f(G, C, sc=0.1), f(G, C, sc=0.1))
    return x, kv, ws, bs, lnq, lnkv


def _variant(name, lnq, lnkv):
    """(ln_q, ln_kv, residual, cross) per named site variant."""
    return {"self_same_ln_residual": (lnq, "same", True, False),
            "self_plain": (None, None, False, False),
            "cross_ln_residual": (lnq, lnkv, True, True),
            "cross_no_kv_ln": (lnq, None, False, True)}[name]


VARIANTS = ["self_same_ln_residual", "self_plain", "cross_ln_residual", "cross_no_kv_ln"]


def _run_port(x, kv, ws, bs, ln_q, ln_kv, residual, dtype):
    t = lambda a: torch.from_numpy(np.array(a))
    ln = lambda p: None if p is None else (p if isinstance(p, str) else (t(p[0]), t(p[1])))
    before = tfs.attention_site.launches
    out = tfs.attention_site(t(x).to(dtype), t(kv).to(dtype),
                             *[t(w).to(dtype) for w in ws], *[t(b) for b in bs],
                             torch.from_numpy(_pos()), H, 100.0,
                             ln_q=ln(ln_q), ln_kv=ln(ln_kv), residual=residual)
    assert tfs.attention_site.launches == before   # CPU: plain version
    return out.float().numpy()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_site_plain_matches_site_xla(variant, dtype):
    x, kv, ws, bs, lnq, lnkv = _site_inputs(1, "cross" in variant)
    ln_q, ln_kv, residual, _ = _variant(variant, lnq, lnkv)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    cos, sin = jfs._rope_tables(jnp.asarray(_pos()), D, 100.0, jdt)
    pack = lambda p: (jnp.zeros((G, 2, C), jnp.float32) if p in (None, "same")
                      else jnp.stack([jnp.asarray(p[0]), jnp.asarray(p[1])], 1))
    ref = jfs._site_xla(jnp.asarray(x, jdt), jnp.asarray(kv, jdt),
                        *[jnp.asarray(w) for w in ws], *[jnp.asarray(b) for b in bs],
                        cos, sin, pack(ln_q), pack(ln_kv), H, ln_q is not None,
                        "same" if ln_kv == "same" else ln_kv is not None,
                        residual, D ** -0.5)
    ref = np.asarray(ref.astype(jnp.float32))
    got = _run_port(x, kv, ws, bs, ln_q, ln_kv, residual, tdt)
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 1.6e-2 * np.abs(ref).max()


@pytest.mark.parametrize("variant", ["self_same_ln_residual", "cross_ln_residual"])
def test_site_plain_matches_pallas_interpret(variant):
    x, kv, ws, bs, lnq, lnkv = _site_inputs(2, "cross" in variant)
    ln_q, ln_kv, residual, _ = _variant(variant, lnq, lnkv)
    jln = lambda p: p if p in (None, "same") else (jnp.asarray(p[0]), jnp.asarray(p[1]))
    ref = jfs.attention_site(jnp.asarray(x), jnp.asarray(kv),
                             *[jnp.asarray(w) for w in ws], *[jnp.asarray(b) for b in bs],
                             jnp.asarray(_pos()), H, 100.0, interpret=True,
                             ln_q=jln(ln_q), ln_kv=jln(ln_kv), residual=residual)
    got = _run_port(x, kv, ws, bs, ln_q, ln_kv, residual, torch.float32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_site_without_rope():
    x, kv, ws, bs, lnq, _ = _site_inputs(3, False)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfs.attention_site(t(x), t(x), *[t(w) for w in ws], *[t(b) for b in bs],
                             torch.from_numpy(_pos()), H, None)
    cos = jnp.ones((D, N))
    sin = jnp.zeros((D, N))
    z = jnp.zeros((G, 2, C))
    ref = jfs._site_xla(jnp.asarray(x), jnp.asarray(x), *[jnp.asarray(w) for w in ws],
                        *[jnp.asarray(b) for b in bs], cos, sin, z, z, H, False,
                        False, False, D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- K2

def _mlp_inputs(seed, n=N, c=C, f=F):
    r = np.random.default_rng(seed)
    g = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    return (g(G, B, n, c), g(G, c, f, sc=c ** -0.5), g(G, f, sc=0.1),
            g(G, f, c, sc=f ** -0.5), g(G, c, sc=0.1),
            (1 + g(G, c, sc=0.1), g(G, c, sc=0.1)))


def _mlp_port(x, w1, b1, w2, b2, ln, residual, dtype):
    t = lambda a: torch.from_numpy(np.array(a))
    before = tfs.mlp_site.launches
    out = tfs.mlp_site(t(x).to(dtype), t(w1).to(dtype), t(b1), t(w2).to(dtype), t(b2),
                       ln=None if ln is None else (t(ln[0]), t(ln[1])),
                       residual=residual)
    assert tfs.mlp_site.launches == before
    return out.float().numpy()


@pytest.mark.parametrize("ln_res", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_plain_matches_mlp_xla(ln_res, dtype):
    use_ln, residual = ln_res
    x, w1, b1, w2, b2, ln = _mlp_inputs(4)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    lnp = jnp.stack([jnp.asarray(ln[0]), jnp.asarray(ln[1])], 1)
    ref = jfs._mlp_xla(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                       jnp.asarray(w2), jnp.asarray(b2), lnp, use_ln, residual)
    ref = np.asarray(ref.astype(jnp.float32))
    got = _mlp_port(x, w1, b1, w2, b2, ln if use_ln else None, residual, tdt)
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 1.6e-2 * np.abs(ref).max()


@pytest.mark.parametrize("nf", [1, 2])
def test_mlp_plain_matches_pallas_interpret(nf, monkeypatch):
    """mlp_site in interpret mode, whole-F (nf=1) and F-blocked (nf=2, the
    encoder's form on the TPU, forced by lowering the VMEM gate)."""
    n, c, f = 32, 128, 512
    x, w1, b1, w2, b2, ln = _mlp_inputs(5, n, c, f)
    if nf == 2:
        monkeypatch.setattr(jfs, "_MLP_VMEM_GATE", jfs._mlp_working_set(n, c, f, 1) - 1)
    assert jfs.mlp_fblocks(jnp.zeros((G, B, n, c)), f) == nf
    ref = jfs.mlp_site(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                       jnp.asarray(w2), jnp.asarray(b2),
                       ln=(jnp.asarray(ln[0]), jnp.asarray(ln[1])), residual=True,
                       interpret=True)
    got = _mlp_port(x, w1, b1, w2, b2, ln, True, torch.float32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_site_attention_plain_is_k6_per_head(dtype):
    """K1's attention launch computes K6's function on each head: its plain
    version on (G, B, N, C) with the heads side by side equals K6's plain
    version on the heads laid out as (G B, H, N, D) bit for bit, and JAX's K6
    Pallas kernel in interpret mode (1e-5 in fp32, 2 bf16 ulps of the largest
    output in bf16, as above)."""
    from align3r_tpu.ops import small_attention as jsa
    from align3r_tpu_torch.ops import small_attention as tsa
    tdt, jdt = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal((G, B, N, C)).astype(np.float32) for _ in range(3))
    per_head = lambda a: a.reshape(G * B, N, H, D).swapaxes(1, 2)
    got = tfs.site_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), H)
    k6 = tsa.small_attention_plain(*(torch.from_numpy(np.ascontiguousarray(per_head(a))).to(tdt)
                                     for a in (q, k, v)))
    assert torch.equal(got.reshape(G * B, N, H, D).transpose(1, 2), k6)
    ref = np.asarray(jsa.small_attention(*(jnp.asarray(per_head(a), jdt) for a in (q, k, v)))
                     .astype(jnp.float32))
    got = per_head(got.float().numpy())
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 1.6e-2 * np.abs(ref).max()


def test_cuda_wrappers_refuse_unsupported_inputs():
    """The CUDA paths validate before they build or launch anything: an fp32
    tensor is refused (checked on the shape-validation helpers directly,
    since this machine has no card)."""
    x = torch.zeros(1, 1, 8, 64)
    w = torch.zeros(1, 64, 64)
    b = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        tfs._site_cuda(x, x, w, w, w, w, b, b, b, b, x[0, 0], x[0, 0], 1,
                       None, None, False)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        tfs._mlp_cuda(x, w, b, w, b, None, False)
