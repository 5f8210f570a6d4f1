"""K7/K8's fp32 convolutions on the 3xTF32 tensor-core policy: the walk, the
operand layout and the launches composed, on the CPU.

The fp32 kernel (csrc/dpt_pipeline.cu, conv_tf32_sm90) walks the bf16
kernel's tiles and tap-shifted, zero-filled boxes with k-tiles of TF32_BK
fp32 channels, each product 3xTF32. ``conv_tiles_tf32_plain`` walks the same
tiles and k-tiles in PyTorch, one ``tf32_mm(split=True)`` per k-tile summed in
k-tile order. Held here, each in fp32 at 1e-5 of the largest value (the
3xTF32 product is within about 2^-21 of each term; sums in another order):
- to ``_conv_plain`` and to JAX's ``lax.conv_general_dilated`` (SAME,
  HIGHEST precision), at Cin 128 and 256, W 16 and 11, H 9;
- single-pass TF32 (split=False) at least 10x further off, the function the
  split exists to avoid;
- K7 composed as the wrapper launches it (conv 1 with the operand ReLU and
  EPI_RELU, conv 2 with EPI_RESID) to ``res_unit_plain`` and JAX's
  ``_xla_twin``, with and without a base, and to JAX's Pallas
  ``_res_unit_call`` in interpret mode at one small shape;
- K8 composed (conv 1, the upsample, conv 2 + the 1 x 1) to
  ``head_final_plain``.
The W operand's layout (``tf32_taps``: hi and lo K-major, each TF32_BK block
in TF32_K_ORDER) is held to the A fragments a thread reads, by emulating the
wgmma products slice by slice, and TF32_BK to csrc/dpt_pipeline.cu's TBK.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import dpt_pipeline as jdp
from align3r_tpu_torch.ops import dpt_pipeline as dp
from align3r_tpu_torch.ops.small_attention import tf32_round

torch.set_num_threads(2)
CSRC = Path(dp.__file__).resolve().parents[1] / "csrc"


def _inputs(seed, B, H, W, Cin, Cout):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, W, Cin)).astype(np.float32)
    taps = (r.standard_normal((9, Cin, Cout)) / (3 * np.sqrt(Cin))).astype(np.float32)
    bias = (0.1 * r.standard_normal(Cout)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(bias)


def _exact(x, taps, bias):
    """The conv in float64 (the ground truth the fp32 paths approximate)."""
    Cin, Cout = taps.shape[1:]
    w = taps.double().reshape(3, 3, Cin, Cout).permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1) + bias.double()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("B, H, W, Cin, Cout", [
    (1, 9, 16, 128, 128),    # the 9 x 16 level's width: BH = 8, the second tile row ragged
    (1, 9, 11, 128, 128),    # W = 11 in a 16-wide box
    (1, 9, 16, 256, 128),    # Cin 256: 72 k-tiles
    (1, 9, 11, 256, 256),    # two output-channel tiles
])
def test_tf32_walk_matches_conv_plain(B, H, W, Cin, Cout):
    x, taps, bias = _inputs(B * H * W + Cin + Cout, B, H, W, Cin, Cout)
    ref = dp._conv_plain(x, taps, bias)
    got = dp.conv_tiles_tf32_plain(x, taps, bias)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("Cin, W", [(128, 11), (256, 16)])
def test_tf32_walk_matches_jax_conv(Cin, W):
    x, taps, bias = _inputs(Cin + W, 1, 9, W, Cin, 128)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(taps.numpy().reshape(3, 3, Cin, 128)), (1, 1),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bias.numpy())
    assert _rel(dp.conv_tiles_tf32_plain(x, taps, bias), np.asarray(ref)) <= 1e-5


def test_single_pass_tf32_is_10x_further_off():
    """Against the float64 conv, one TF32 product per k-tile (hi hi alone)
    is at least 10x further off than the 3xTF32 walk."""
    x, taps, bias = _inputs(4, 1, 9, 11, 256, 128)
    exact = _exact(x, taps, bias)
    split = _rel(dp.conv_tiles_tf32_plain(x, taps, bias), exact)
    single = _rel(dp.conv_tiles_tf32_plain(x, taps, bias, split=False), exact)
    assert split <= 1e-5 and single >= 10 * split, (split, single)


def _k7_launches(v, w, b, base):
    """K7 as the wrapper launches it in fp32: conv 1 reads relu(v) and stores
    relu(a) (EPI_RELU), conv 2 adds v [and base] (EPI_RESID)."""
    a = torch.relu(dp.conv_tiles_tf32_plain(torch.relu(v), w[0], b[0]))
    out = v + dp.conv_tiles_tf32_plain(a, w[1], b[1])
    return out if base is None else out + base


@pytest.mark.parametrize("with_base", [False, True])
def test_k7_fp32_launches_match_res_unit_plain_and_jax_twin(with_base):
    r = np.random.default_rng(20)
    C = 128
    v = torch.from_numpy(r.standard_normal((1, 9, 11, C)).astype(np.float32))
    base = torch.from_numpy(r.standard_normal(v.shape).astype(np.float32)) if with_base else None
    w = torch.from_numpy((r.standard_normal((2, 9, C, C)) / (3 * np.sqrt(C))).astype(np.float32))
    b = torch.from_numpy((0.1 * r.standard_normal((2, C))).astype(np.float32))
    got = _k7_launches(v, w, b, base)
    assert _rel(got, dp.res_unit_plain(v, base, w, b)) <= 1e-5
    ref = jdp._xla_twin(jnp.asarray(v.numpy()), jnp.asarray((v if base is None else base).numpy()),
                        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()[:, None]), base is None)
    assert _rel(got, ref) <= 1e-5


def test_k7_fp32_launches_match_pallas_interpret():
    r = np.random.default_rng(21)
    C = 128
    v = r.standard_normal((1, 8, 16, C)).astype(np.float32)
    base = r.standard_normal(v.shape).astype(np.float32)
    w = (r.standard_normal((2, 9, C, C)) / (3 * np.sqrt(C))).astype(np.float32)
    b = (0.1 * r.standard_normal((2, C))).astype(np.float32)
    ref = jdp._res_unit_call(jnp.asarray(v), jnp.asarray(base), jnp.asarray(w),
                             jnp.asarray(b[:, None]), same_base=False, interpret=True, th=4)
    got = _k7_launches(*(torch.from_numpy(a) for a in (v, w, b, base)))
    assert _rel(got, ref) <= 1e-5


def test_k8_fp32_launches_match_head_final_plain():
    """K8 in fp32: conv 1 (EPI_ROUND, the identity rounding), the upsample,
    conv 2 with relu and the fp32 1 x 1 (EPI_HEAD)."""
    x, w1, b1 = _inputs(22, 1, 9, 11, 256, 128)
    _, w2, b2 = _inputs(23, 1, 1, 1, 128, 128)
    r = np.random.default_rng(24)
    w3 = torch.from_numpy((r.standard_normal((128, 4)) / 11).astype(np.float32))
    b3 = torch.from_numpy(r.standard_normal(4).astype(np.float32))
    h2 = dp.upsample2x_plain(dp.conv_tiles_tf32_plain(x, w1, b1))
    got = torch.relu(dp.conv_tiles_tf32_plain(h2, w2, b2)) @ w3 + b3
    assert h2.shape == (1, 18, 22, 128)
    assert _rel(got, dp.head_final_plain(x, w1, b1, w2, b2, w3, b3)) <= 1e-5


def test_tf32_taps_are_the_split_taps_in_k_order():
    """tf32_taps: (2, Cout, 9 Cin), k block kt's position i holds channel
    TF32_K_ORDER[i] of its 32; hi is TF32 (13 low bits clear), hi + lo is w
    to about 2^-21."""
    _, taps, _ = _inputs(25, 1, 1, 1, 64, 128)
    split = dp.tf32_taps(taps)
    assert split.shape == (2, 128, 9 * 64) and split.is_contiguous()
    assert sorted(dp.TF32_K_ORDER) == list(range(dp.TF32_BK))
    w = taps.reshape(9 * 64, 128).t()
    order = torch.tensor(dp.TF32_K_ORDER)
    for kt in range(9 * 64 // dp.TF32_BK):
        blk = w[:, kt * dp.TF32_BK:(kt + 1) * dp.TF32_BK][:, order]
        assert torch.equal(split[0, :, kt * dp.TF32_BK:(kt + 1) * dp.TF32_BK], tf32_round(blk))
    assert (split[0].view(torch.int32) & 0x1fff == 0).all()
    assert (split[1].view(torch.int32) & 0x1fff == 0).all()
    assert ((split[0] + split[1]) - w[:, _inverse_positions()]).abs().max() <= 2 ** -20 * w.abs().max()


def _inverse_positions():
    """Column index into the unpermuted (Cout, 9 Cin) taps of each position
    of the permuted layout (for a whole 9 x 64 k)."""
    order = np.array(dp.TF32_K_ORDER)
    return torch.from_numpy(np.concatenate([kt * dp.TF32_BK + order for kt in range(18)]))


def test_a_fragments_meet_w_in_k_order():
    """One k-tile as a warp's wgmmas see it: lane l (q = l % 4, rows r0 =
    l / 4 and r0 + 8) reads 16-byte chunk 2 q + pp of each row (channels
    8 q + 4 pp ..) and gives slices kk = 2 pp + j the fragment (r0, k=q) =
    channel 8 q + 4 pp + 2 j, (r0 + 8, k=q), (r0, k=q+4) = that channel + 1,
    (r0 + 8, k=q+4) (csrc tf32_frags); each slice multiplies W's positions
    8 kk .. 8 kk + 7. The products summed over the slices are X W; the eight
    lanes of a quarter-warp read eight distinct chunks through the 128-byte
    swizzle (no bank conflict)."""
    r = np.random.default_rng(26)
    X = r.standard_normal((16, dp.TF32_BK))
    Wt = r.standard_normal((dp.TF32_BK, 8))
    Bk = Wt[list(dp.TF32_K_ORDER)].T                    # (N, 32) K-major, in k order
    D = np.zeros((16, 8))
    for pp in range(2):
        for j in range(2):
            kk = 2 * pp + j
            A = np.zeros((16, 8))
            for lane in range(32):
                q, r0 = lane % 4, lane // 4
                ch = 8 * q + 4 * pp + 2 * j
                A[r0, q], A[r0 + 8, q] = X[r0, ch], X[r0 + 8, ch]
                A[r0, q + 4], A[r0 + 8, q + 4] = X[r0, ch + 1], X[r0 + 8, ch + 1]
            D += A @ Bk[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_allclose(D, X @ Wt, rtol=1e-12, atol=1e-12)
    for pp in range(2):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            chunks = {(2 * (l % 4) + pp) ^ ((l // 4) % 8) for l in lanes}
            assert len(chunks) == 8


def test_tf32_constants_are_the_kernels():
    """TF32_BK is csrc/dpt_pipeline.cu's TBK; tf32_frags takes a row's chunk
    components (x, y) for slice 2 pp and (z, w) for 2 pp + 1, rows r0 and
    r0 + 8 interleaved as the A fragment's a[0..3]; the consumer reads chunks
    2 q and 2 q + 1 through the swizzle; the FMA kernel is gone."""
    cu = (CSRC / "dpt_pipeline.cu").read_text()
    assert int(re.search(r"constexpr int TBK = (\d+);", cu).group(1)) == dp.TF32_BK
    assert "{{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}}" in cu
    assert "(((2 * q) ^ (r0 & 7)) << 4)" in cu and "(((2 * q + 1) ^ (r0 & 7)) << 4)" in cu
    assert "conv_tf32_sm90" in cu and "conv3x3_fp32" not in cu and "FmaLayout" not in cu
