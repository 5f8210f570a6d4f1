"""The blocked plain versions of K9's fp32 kernels
(flash_attention_f32_tiles_plain and flash_attention_bwd_f32_tiles_plain in
align3r_tpu_torch.ops.flash_attention): the kernels' walk over key tiles
(forward, dQ) and query tiles (dK/dV), one online-softmax pass, every
product as 3xTF32 split products (hi = tf32(x), lo = tf32(x - hi);
lo hi + hi lo + hi hi in fp32) with TF32 rounding emulated on the fp32 bits
as cvt.rna.tf32.f32 does it, and the products that reduce over queries or
keys taken in the transposed copies' 8-row order.

The walk is held to the plain versions flash_attention_plain /
flash_attention_bwd_plain at ragged lengths and D = 64, 128 and 256
(tolerance: 1e-5 of the largest value; 3xTF32 products are about 2^-21
relative, exp2 against exp, sums in another order), and to the JAX
package's stock flash attention (JAX's library Pallas kernels in interpret
mode) and its jax.vjp at one shape (2e-5, the stock kernel's own fp32
tolerance in tests/test_stock_flash.py, absolute on the forward and of the
largest gradient on the backward). Single-pass TF32 (hi hi alone) is at
least 10x further from a float64 reference than the split. The tile
constants are held to the ones written in csrc/flash_attention.cu and
csrc/sm90_attention_tf32.cuh.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from align3r_tpu.ops import attention as jattn
from align3r_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
CSRC = Path(tfa.__file__).resolve().parents[1] / "csrc"


def _arrays(seed, shape, n=4):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _reference64(q, k, v, g):
    """softmax(q k^T D^-1/2) v and its gradients (dq, dk, dv) for the
    cotangent g, in float64."""
    q, k, v, g = (np.asarray(a, np.float64) for a in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bhkd->bhqd", p, v)
    dv = np.einsum("bhqk,bhqd->bhkd", p, g)
    dp = np.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (o * g).sum(-1, keepdims=True)) * scale
    return o, (np.einsum("bhqk,bhkd->bhqd", ds, k), np.einsum("bhqk,bhqd->bhkd", ds, q), dv)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("n", [77, 130])
def test_tiles_walk_matches_plain(n, D):
    """Ragged lengths: a partial last key tile (forward, dQ), query tile
    (dK/dV) and 64-row block, and 8-row groups padded in the transposed
    order."""
    q, k, v, g = map(torch.from_numpy, _arrays(n + D, (1, 2, n, D)))
    o, lse = tfa.flash_attention_f32_tiles_plain(q, k, v)
    ro, rlse = tfa.flash_attention_plain(q, k, v)
    assert o.dtype == lse.dtype == torch.float32 and o.shape == q.shape
    _close(o, ro)
    _close(lse, rlse)
    grads = tfa.flash_attention_bwd_f32_tiles_plain(q, k, v, ro, rlse, g)
    for got, ref in zip(grads, tfa.flash_attention_bwd_plain(q, k, v, ro, rlse, g)):
        assert got.shape == ref.shape
        _close(got, ref)


def test_tiles_walk_matches_stock_flash_interpret():
    """The forward and the gradients of the walk against JAX's stock flash
    attention and its vjp in Pallas interpret mode, fp32."""
    q, k, v, g = _arrays(3, (1, 2, 130, 64))
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jattn.stock_flash_attention, *map(jnp.asarray, (q, k, v)))
        refs = vjp(jnp.asarray(g))
    ref = np.asarray(ref)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = tfa.flash_attention_f32_tiles_plain(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), ref, atol=2e-5)
    grads = tfa.flash_attention_bwd_f32_tiles_plain(tq, tk, tv, o, lse, tg)
    for got, r in zip(grads, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, atol=2e-5 * np.abs(r).max())


def test_single_pass_tf32_is_not_fp32():
    """At the training sequence length and head dim, one TF32 product per
    fp32 product is at least 10x further from the float64 reference than the
    3xTF32 split, forward and backward; the split stays within 1e-5 of the
    largest value."""
    q, k, v, g = _arrays(4, (1, 1, 1024, 64))
    ref_o, ref_g = _reference64(q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    for split in (True, False):
        o, lse = tfa.flash_attention_f32_tiles_plain(tq, tk, tv, split=split)
        grads = tfa.flash_attention_bwd_f32_tiles_plain(tq, tk, tv, o, lse, tg, split=split)
        errs = [np.abs(a.numpy().astype(np.float64) - r).max() / np.abs(r).max()
                for a, r in zip((o, *grads), (ref_o, *ref_g))]
        if split:
            fine = errs
            assert max(errs) <= 1e-5, errs
    assert all(c >= 10 * f for c, f in zip(errs, fine)), (errs, fine)


def test_tile_constants_are_the_kernels():
    """block_k(D, fp32), the forward walk's key tile, and f32_bwd_tiles(D),
    the backward walk's query and key tiles, are Tiles<float, D>'s BK, KV_Q
    and DQ_K in csrc/flash_attention.cu; the transposed copies' 8-row order is
    tf32_key_order in csrc/sm90_attention_tf32.cuh; the walk's 64-row blocks
    are the core's BQ."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = re.search(r"struct Tiles<float, D> \{(.*?)\};", src, re.S).group(1)

    def tile(name):
        d, at_d, other = map(int, re.search(
            r"\b%s = D == (\d+) \? (\d+) : (\d+);" % name, body).groups())
        return lambda D: at_d if D == d else other

    for D in tfa.HEAD_DIMS:
        assert tfa.block_k(D, torch.float32) == tile("BK")(D)
        assert tfa.f32_bwd_tiles(D) == (tile("KV_Q")(D), tile("DQ_K")(D))
    core = (CSRC / "sm90_attention.cuh").read_text()
    assert int(re.search(r"constexpr int BQ = (\d+);", core).group(1)) == tfa.F32_BQ
    tf32 = (CSRC / "sm90_attention_tf32.cuh").read_text()
    assert "return pos < 4 ? 2 * pos : 2 * (pos - 4) + 1;" in tf32
    assert tfa._tf32_order(16).tolist() == [0, 2, 4, 6, 1, 3, 5, 7,
                                            8, 10, 12, 14, 9, 11, 13, 15]
