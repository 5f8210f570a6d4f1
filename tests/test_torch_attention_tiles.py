"""The blocked plain version of K6's fp32 kernel
(small_attention_f32_tiles_plain in align3r_tpu_torch.ops.small_attention):
the kernel's walk over key tiles of F32_BK with one online-softmax pass, and
every product as 3xTF32 split products (hi = tf32(x), lo = tf32(x - hi);
lo hi + hi lo + hi hi in fp32), TF32 rounding emulated on the fp32 bits as
cvt.rna.tf32.f32 does it.

It is held to the plain version small_attention_plain and to the JAX
package's fp32 small_attention (its XLA twin `_xla_equiv`, and the Pallas
kernel in interpret mode at one small shape), at ragged key counts and head
dims padded by the kernel. Tolerance: 1e-5 of the largest value (3xTF32
products are about 2^-21 relative; exp2 against exp, and sums in another
order). Single-pass TF32 (hi hi alone) is at least 10x further from an
fp64 reference than the split at the training shape: that is why the
kernel splits. The tile constant is held to the one written in
csrc/sm90_attention_tf32.cuh.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import small_attention as jsa
from align3r_tpu_torch.ops import small_attention as tsa

torch.set_num_threads(2)
CSRC = Path(tsa.__file__).resolve().parents[1] / "csrc"


def _qkv(seed, shape, nk):
    r = np.random.default_rng(seed)
    B, H, _, D = shape
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, H, nk, D)).astype(np.float32),
            r.standard_normal((B, H, nk, D)).astype(np.float32))


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _reference64(q, k, v):
    """softmax(q k^T D^-1/2) v in float64."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p, v) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("D", [8, 40, 64, 128])
@pytest.mark.parametrize("nk", [33, 100])
def test_tiles_plain_matches_plain(nk, D):
    """Ragged key counts (a partial last tile of 32 keys) at every padded
    head dim of the kernel (32, 64, 128), Nq not a multiple of 64."""
    q, k, v = map(torch.from_numpy, _qkv(nk + D, (2, 3, 48, D), nk))
    got = tsa.small_attention_f32_tiles_plain(q, k, v)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got.numpy(), tsa.small_attention_plain(q, k, v).numpy())


@pytest.mark.parametrize("nk", [33, 80])
def test_tiles_plain_matches_xla_equiv(nk):
    q, k, v = _qkv(1, (2, 3, 48, 24), nk)
    ref = np.asarray(jsa._xla_equiv(*(jnp.asarray(a) for a in (q, k, v))))
    got = tsa.small_attention_f32_tiles_plain(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), ref)


def test_tiles_plain_matches_pallas_interpret():
    q, k, v = _qkv(0, (1, 2, 32, 16), 32)
    ref = np.asarray(jsa.small_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = tsa.small_attention_f32_tiles_plain(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), ref)


def test_single_pass_tf32_is_not_fp32():
    """At the training shape's sequence and head dim, one TF32 product per
    fp32 product is at least 10x further from the float64 reference than
    the 3xTF32 split, which stays within 1e-5 of the largest value."""
    q, k, v = _qkv(2, (1, 2, 576, 64), 576)
    ref = _reference64(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    err = {split: np.abs(tsa.small_attention_f32_tiles_plain(tq, tk, tv, split=split)
                         .numpy().astype(np.float64) - ref).max()
           for split in (True, False)}
    assert err[True] <= 1e-5 * np.abs(ref).max(), err
    assert err[False] >= 10 * err[True], err


def test_tf32_round_is_rna():
    """To nearest with ties away from zero, 10 mantissa bits, both signs;
    a carry into the exponent; TF32 values unchanged."""
    u = 2.0 ** -10   # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + 1.5 * u, -(1 + u / 2), 1 + u / 4, 2 - u / 4,
                      1 + u, -3.0, 0.0, 1 + u / 2 - 2.0 ** -23], dtype=torch.float32)
    want = [1 + u, 1 + 2 * u, -(1 + u), 1.0, 2.0, 1 + u, -3.0, 0.0, 1.0]
    assert tsa.tf32_round(x).tolist() == want
    bits = tsa.tf32_round(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_tile_constant_is_the_kernels():
    """F32_BK, the plain walk's key tile, is the fp32 kernel's stage width,
    and the kernel's V^T key order pairs an accumulator fragment's keys
    (2t, 2t + 1) with an A fragment's k = (t, t + 4)."""
    src = (CSRC / "sm90_attention_tf32.cuh").read_text()
    assert int(re.search(r"constexpr int F32_BK = (\d+);", src).group(1)) == tsa.F32_BK
    assert "return pos < 4 ? 2 * pos : 2 * (pos - 4) + 1;" in src
