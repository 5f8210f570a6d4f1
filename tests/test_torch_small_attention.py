"""Port parity: K6 (align3r_tpu_torch.ops.small_attention), the attention
dispatch (ops/attention.py) and the differentiable K1/K2 sites
(fused_site.attention_site_diff / mlp_site_diff) against align3r_tpu.

Oracles: the Pallas small_attention kernel in interpret mode at one small
shape, its XLA twin `_xla_equiv`, `jax.vjp` of small_attention (whose
backward is the VJP of `_xla_equiv`), and `jax.vjp` of the JAX `_diff`
sites (Pallas forward in interpret mode, XLA-twin backward). Tolerances:
- fp32: 1e-5 of the largest magnitude (the same math, sums in another order);
- bf16: 2 bf16 ulps of the largest magnitude (1.6e-2 x max): both sides round
  P and the output to bf16 at the same points, and one flipped rounding of
  an intermediate moves the output by an ulp.
On the CPU every wrapper takes its plain version and counts no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import attention as jattn
from align3r_tpu.ops import fused_site as jfs
from align3r_tpu.ops import small_attention as jsa
from align3r_tpu_torch.ops import attention as tattn
from align3r_tpu_torch.ops import fused_site as tfs
from align3r_tpu_torch.ops import small_attention as tsa

torch.set_num_threads(2)

SHAPE = (1, 2, 32, 16)          # (B, H, N, D): one small interpret-mode shape
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _qkv(seed, shape=SHAPE, nk=None):
    r = np.random.default_rng(seed)
    B, H, N, D = shape
    kshape = (B, H, nk or N, D)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(kshape).astype(np.float32),
            r.standard_normal(kshape).astype(np.float32))


def _close(got, ref, rel):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_forward_matches_pallas_interpret(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(0)
    ref = jsa.small_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    before = tsa.small_attention.launches
    got = tsa.small_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert tsa.small_attention.launches == before and got.dtype == tdt
    _close(got.float().numpy(), _f32(ref), tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_and_twin_match_xla_equiv(dtype):
    """The plain forward (P rounded before the normalisation) and the
    backward twin (p / s rounded) both sit within tolerance of _xla_equiv;
    the twin is its exact counterpart."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(1, (2, 3, 48, 24), nk=80)
    ref = _f32(jsa._xla_equiv(*(jnp.asarray(a, jdt) for a in (q, k, v))))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    _close(tsa.small_attention_plain(tq, tk, tv).float().numpy(), ref, tol)
    _close(tsa.small_attention_twin(tq, tk, tv).float().numpy(), ref,
           1e-5 if dtype == "fp32" else 8e-3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gradient_matches_jax_vjp(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(2)
    g = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    _, vjp = jax.vjp(jsa.small_attention, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    refs = vjp(jnp.asarray(g, jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    tsa.small_attention(*ts).backward(torch.from_numpy(g).to(tdt))
    for t, r in zip(ts, refs):
        assert t.grad.dtype == tdt
        _close(t.grad.float().numpy(), _f32(r), tol)


def test_supported_matches_jax_predicate():
    shapes = [((4, 16, 576, 64), 576), ((4, 12, 672, 64), 672), ((2, 2, 64, 16), 64),
              ((1, 2, 128, 64), 128), ((1, 2, 576, 64), 40), ((1, 2, 576, 136), 576),
              ((1, 2, 576, 60), 576), ((1, 1, 4096, 128), 4096)]
    for dt in ("fp32", "bf16"):
        jdt, tdt, _ = DTYPES[dt]
        for qs, nk in shapes:
            ks = (*qs[:2], nk, qs[3])
            jargs = [jax.ShapeDtypeStruct(s, jdt) for s in (qs, ks, ks)]
            targs = [torch.empty(s, dtype=tdt, device="meta") for s in (qs, ks, ks)]
            assert tsa.supported(*targs) == jsa.supported(*jargs), (qs, nk, dt)


def test_dispatch_routes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, 2, 128, 64)))
    jref = _f32(jattn.xla_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v))))
    before = tsa.small_attention.launches
    # "auto" on a CPU tensor resolves as JAX does on the CPU: the XLA path
    _close(tattn.attention(q, k, v, "auto").numpy(), jref, 1e-5)
    _close(tattn.attention(q, k, v, "xla").numpy(), jref, 1e-5)
    np.testing.assert_array_equal(tattn.attention(q, k, v, "small").numpy(),
                                  tsa.small_attention_plain(q, k, v).numpy())
    assert tsa.small_attention.launches == before
    # "flash" off the card is the XLA path, as JAX's is off the TPU
    _close(tattn.attention(q, k, v, "flash").numpy(), jref, 1e-5)
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, "nope")
    # the route a CUDA tensor takes, decided on the shapes alone
    assert not tattn.flash_ok(q, k, v)


def test_cuda_wrapper_refuses_unsupported_inputs():
    x = torch.zeros(1, 1, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tsa._cuda(x, x, x)


# --------------------------------------------- differentiable K1 / K2 sites

G, B, H, D = 2, 1, 2, 16
C = H * D
GH, GW = 4, 4
N = GH * GW


def _pos():
    ys, xs = np.meshgrid(np.arange(GH), np.arange(GW), indexing="ij")
    return np.stack([ys, xs], -1).reshape(N, 2).astype(np.int32)


def _site_inputs(seed, cross):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    x = f(G, B, N, C)
    kv = f(G, B, N, C) if cross else x
    return (x, kv, [f(G, C, C, sc=C ** -0.5) for _ in range(4)],
            [f(G, C, sc=0.1) for _ in range(4)],
            (1 + f(G, C, sc=0.1), f(G, C, sc=0.1)),
            (1 + f(G, C, sc=0.1), f(G, C, sc=0.1)), f(G, B, N, C))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_site_diff_matches_jax(cross, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, kv, ws, bs, lnq, lnkv, g = _site_inputs(5, cross)
    ln_kv = lnkv if cross else "same"

    def jfn(x, kv, wq, wk, wv, wo, bq, bk, bv, bo, qs, qb, ks, kb):
        return jfs.attention_site_diff(
            x, kv if cross else x, wq, wk, wv, wo, bq, bk, bv, bo,
            jnp.asarray(_pos()), H, 100.0, ln_q=(qs, qb),
            ln_kv=(ks, kb) if cross else "same", residual=True)

    jin = [jnp.asarray(x, jdt), jnp.asarray(kv, jdt), *map(jnp.asarray, ws),
           *map(jnp.asarray, bs), *map(jnp.asarray, lnq), *map(jnp.asarray, lnkv)]
    jout, vjp = jax.vjp(jfn, *jin)
    jgrads = vjp(jnp.asarray(g, jdt))

    tin = [torch.from_numpy(x).to(tdt), torch.from_numpy(kv).to(tdt),
           *map(torch.from_numpy, ws), *map(torch.from_numpy, bs),
           *map(torch.from_numpy, lnq), *map(torch.from_numpy, lnkv)]
    tin = [t.clone().requires_grad_(True) for t in tin]
    xkv = tin[1] if cross else tin[0]
    before = tfs.attention_site.launches
    out = tfs.attention_site_diff(tin[0], xkv, *tin[2:10], torch.from_numpy(_pos()),
                                  H, 100.0, ln_q=(tin[10], tin[11]),
                                  ln_kv=(tin[12], tin[13]) if cross else "same",
                                  residual=True)
    out.backward(torch.from_numpy(g).to(tdt))
    assert tfs.attention_site.launches == before
    _close(out.detach().float().numpy(), _f32(jout), tol)
    for i, (t, r) in enumerate(zip(tin, jgrads)):
        if not cross and i in (1, 12, 13):
            continue                      # unused under ln_kv="same"
        _close(t.grad.float().numpy(), _f32(r), tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_site_diff_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    r = np.random.default_rng(6)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)
    F = 128
    arrs = [f(G, B, N, C), f(G, C, F, sc=C ** -0.5), f(G, F, sc=0.1),
            f(G, F, C, sc=F ** -0.5), f(G, C, sc=0.1), 1 + f(G, C, sc=0.1),
            f(G, C, sc=0.1)]
    g = f(G, B, N, C)

    def jfn(x, w1, b1, w2, b2, s, b):
        return jfs.mlp_site_diff(x, w1, b1, w2, b2, ln=(s, b), residual=True)

    jin = [jnp.asarray(arrs[0], jdt), *map(jnp.asarray, arrs[1:])]
    jout, vjp = jax.vjp(jfn, *jin)
    jgrads = vjp(jnp.asarray(g, jdt))
    tin = [torch.from_numpy(arrs[0]).to(tdt), *map(torch.from_numpy, arrs[1:])]
    tin = [t.clone().requires_grad_(True) for t in tin]
    before = tfs.mlp_site.launches
    out = tfs.mlp_site_diff(*tin[:5], ln=(tin[5], tin[6]), residual=True)
    out.backward(torch.from_numpy(g).to(tdt))
    assert tfs.mlp_site.launches == before
    _close(out.detach().float().numpy(), _f32(jout), tol)
    for t, ref in zip(tin, jgrads):
        _close(t.grad.float().numpy(), _f32(ref), tol)


def test_site_gates_match_jax():
    for shape, heads in (((2, 4, 576, 768), 12), ((1, 4, 576, 1024), 16),
                         ((2, 1, 20, 64), 4), ((2, 1, 16, 48), 4),
                         ((1, 2, 2304, 1024), 16)):
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        assert tfs.supported(t, heads) == jfs.supported(x, heads), shape
        for hidden in (4 * shape[-1], 192, 3072):
            assert tfs.mlp_supported(t, hidden) == jfs.mlp_supported(x, hidden), \
                (shape, hidden)
