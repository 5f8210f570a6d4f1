"""K7/K8's bf16 convolutions as implicit GEMMs on the Hopper GEMM core: the
box walk, the launches' epilogues and the gate's constants, on the CPU.

The kernel (csrc/dpt_pipeline.cu, ConvPolicy on csrc/gemm.cuh's core) tiles
each image into boxes of BW x BH = 128 pixels and reads each k-tile as the
box shifted by its tap, zero-filled outside the image. ``conv_tiles_plain``
walks the same tiles, k-tiles and boxes in PyTorch; it is held here to
``_conv_plain`` and to JAX's ``lax.conv_general_dilated`` (SAME) in fp32 at
1e-5 of the largest value (the same products, summed per k-tile). The
launches' plain versions (``conv3x3_plain``, ``upsample2x_plain``) composed
as the wrapper launches them are held to ``res_unit_plain`` bit for bit (K7:
conv 1's epilogue stores relu(a), conv 2 reads it without a ReLU) and to
``head_final_plain`` (K8: the same ops). The Python gate's constants are
read from the CUDA sources.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu_torch.ops import dpt_pipeline as dp

torch.set_num_threads(2)
CSRC = Path(dp.__file__).resolve().parents[1] / "csrc"


def _conv_inputs(seed, B, H, W, Cin, Cout, dtype=torch.float32):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, W, Cin)).astype(np.float32)
    taps = (r.standard_normal((9, Cin, Cout)) / (3 * np.sqrt(Cin))).astype(np.float32)
    bias = (0.1 * r.standard_normal(Cout)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(taps).to(dtype),
            torch.from_numpy(bias))


@pytest.mark.parametrize("W, box", [(128, (64, 2)), (64, (64, 2)), (32, (32, 4)),
                                    (16, (16, 8)), (11, (16, 8)), (20, (32, 4)),
                                    (256, (64, 2)), (512, (64, 2)), (100, (64, 2)),
                                    (5, (8, 16)), (1, (1, 128))])
def test_conv_box(W, box):
    bw, bh = dp.conv_box(W)
    assert (bw, bh) == box
    assert bw * bh == dp.CONV_BM and bw <= dp.CONV_BW and bw & (bw - 1) == 0
    assert bw >= min(W, dp.CONV_BW)


@pytest.mark.parametrize("shape", [(2, 9, 16, 2), (1, 72, 128, 1), (3, 5, 11, 2)])
def test_conv_walk_covers_each_pixel_once_n_fastest(shape):
    """Every (pixel, output channel) in exactly one tile; consecutive tiles
    step N first, then W, then H, then B."""
    B, H, W, nn = shape
    Cout = nn * dp.CONV_BN
    tiles = list(dp.conv_walk(B, H, W, Cout))
    bw, bh = dp.conv_box(W)
    assert len(tiles) == B * -(-H // bh) * -(-W // bw) * nn
    seen = np.zeros((B, H, W, nn), np.int32)
    for b, h0, w0, n0 in tiles:
        seen[b, h0:h0 + bh, w0:w0 + bw, n0 // dp.CONV_BN] += 1
    assert (seen == 1).all()
    keys = [(b, h0, w0, n0) for b, h0, w0, n0 in tiles]
    assert keys == sorted(keys)
    if nn > 1:
        assert tiles[1] == (0, 0, 0, dp.CONV_BN)


@pytest.mark.parametrize("B, H, W, Cin, Cout", [
    (1, 3, 128, 64, 128),    # the 72 x 128 level's width (BW = 64, two 64-pixel boxes a row)
    (1, 5, 64, 64, 128),     # 36 x 64
    (2, 5, 32, 64, 256),     # 18 x 32 (BW = 32), two output-channel tiles
    (1, 9, 16, 128, 128),    # 9 x 16: BH = 8, the second row of tiles ragged
    (1, 9, 11, 64, 128),     # W = 11 in a 16-wide box
    (1, 4, 100, 64, 128),    # W past one box, ragged
])
def test_box_walk_matches_conv_plain(B, H, W, Cin, Cout):
    x, taps, bias = _conv_inputs(B * H * W + Cin, B, H, W, Cin, Cout)
    ref = dp._conv_plain(x, taps, bias)
    got = dp.conv_tiles_plain(x, taps, bias)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_box_walk_matches_jax_conv():
    x, taps, bias = _conv_inputs(3, 2, 9, 11, 64, 128)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(taps.numpy().reshape(3, 3, 64, 128)), (1, 1),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bias.numpy())
    got = dp.conv_tiles_plain(x, taps, bias).numpy()
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_base", [False, True])
def test_res_unit_launches_are_res_unit_plain_bits(dtype, with_base):
    """K7's two launches: conv 1 with the operand ReLU and the EPI_RELU
    epilogue (a is stored relu'd), conv 2 with no operand ReLU and the
    residual epilogue, give res_unit_plain's bits, on inputs and
    intermediates with negative values."""
    C = 128
    v, w0, b0 = _conv_inputs(5, 2, 9, 16, C, C, dtype)
    _, w1, b1 = _conv_inputs(6, 1, 1, 1, C, C, dtype)
    base = torch.from_numpy(np.random.default_rng(7).standard_normal(v.shape)
                            .astype(np.float32)).to(dtype) if with_base else None
    a = dp.conv3x3_plain(v, w0, b0, dp.EPI_RELU, relu_in=True)
    out = dp.conv3x3_plain(a, w1, b1, dp.EPI_RESID, resid=v, base=base)
    ref = dp.res_unit_plain(v, base, torch.stack([w0, w1]), torch.stack([b0, b1]))
    raw = dp._conv_plain(torch.relu(v), w0, b0)
    assert (v < 0).any() and (raw < 0).any() and (a >= 0).all()
    assert out.dtype == dtype and torch.equal(out, ref)


def test_epilogues_rounding_order():
    """conv3x3_plain's epilogues, written out: round(y), round(relu(y)) =
    relu(round(y)), round(round(v + round(y)) + base), relu(y) w3 + b3."""
    x, taps, bias = _conv_inputs(8, 1, 6, 10, 64, 128, torch.bfloat16)
    y = dp._conv_plain(x, taps, bias)
    r = np.random.default_rng(9)
    v, base = (torch.from_numpy(r.standard_normal((1, 6, 10, 128)).astype(np.float32))
               .bfloat16() for _ in range(2))
    w3 = torch.from_numpy(r.standard_normal((128, 4)).astype(np.float32))
    b3 = torch.from_numpy(r.standard_normal(4).astype(np.float32))
    bf = torch.bfloat16
    assert torch.equal(dp.conv3x3_plain(x, taps, bias, dp.EPI_ROUND), y.to(bf))
    relu = dp.conv3x3_plain(x, taps, bias, dp.EPI_RELU)
    assert torch.equal(relu, torch.relu(y).to(bf)) and torch.equal(relu, torch.relu(y.to(bf)))
    assert torch.equal(dp.conv3x3_plain(x, taps, bias, dp.EPI_RESID, resid=v, base=base),
                       ((v.float() + y.to(bf).float()).to(bf).float() + base.float()).to(bf))
    assert torch.equal(dp.conv3x3_plain(x, taps, bias, dp.EPI_RESID, resid=v),
                       (v.float() + y.to(bf).float()).to(bf))
    assert torch.equal(dp.conv3x3_plain(x, taps, bias, dp.EPI_HEAD, w3=w3, b3=b3),
                       torch.relu(y) @ w3 + b3)
    assert torch.equal(dp.conv3x3_plain(x, taps, bias, dp.EPI_ROUND, relu_in=True),
                       dp._conv_plain(torch.relu(x), taps, bias).to(bf))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_launches_are_head_final_plain(dtype):
    """K8's three launches (conv 1, the upsample, conv 2 + the 1 x 1) give
    head_final_plain's output: the same ops in the same order."""
    x, w1, b1 = _conv_inputs(10, 1, 8, 16, 128, 128, dtype)
    _, w2, b2 = _conv_inputs(11, 1, 1, 1, 128, 128, dtype)
    r = np.random.default_rng(12)
    w3 = torch.from_numpy(r.standard_normal((128, 4)).astype(np.float32))
    b3 = torch.from_numpy(r.standard_normal(4).astype(np.float32))
    h1 = dp.conv3x3_plain(x, w1, b1, dp.EPI_ROUND)
    h2 = dp.upsample2x_plain(h1)
    out = dp.conv3x3_plain(h2, w2, b2, dp.EPI_HEAD, w3=w3, b3=b3)
    assert h2.shape == (1, 16, 32, 128) and h2.dtype == dtype
    assert torch.equal(out, dp.head_final_plain(x, w1, b1, w2, b2, w3, b3))


def test_gate_constants_are_the_kernels():
    """EPI_*, MAX_C3, CONV_BW and TF32_BK are csrc/dpt_pipeline.cu's enum Epi,
    MAX_C3, CONV_BW and TBK; CONV_BM, CONV_BN, CONV_BK are gemm.cuh's GBM,
    GBN, GBK; the C entry refuses what the gate refuses (Cin % GBK in bf16,
    Cin % TBK in fp32, Cout % GBN, C3 > MAX_C3), chooses the box as
    conv_box does, and the bf16 path keeps no WMMA kernel."""
    cu = (CSRC / "dpt_pipeline.cu").read_text()
    cuh = (CSRC / "gemm.cuh").read_text()
    const = lambda src, name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (dp.CONV_BM, dp.CONV_BN, dp.CONV_BK) == (const(cuh, "GBM"), const(cuh, "GBN"),
                                                    const(cuh, "GBK"))
    assert (dp.MAX_C3, dp.CONV_BW, dp.TF32_BK) == (const(cu, "MAX_C3"), const(cu, "CONV_BW"),
                                                   const(cu, "TBK"))
    enum = re.search(r"enum Epi : int \{([^}]*)\}", cu).group(1)
    assert {k: int(v) for k, v in re.findall(r"(EPI_\w+) = (\d+)", enum)} == {
        "EPI_ROUND": dp.EPI_ROUND, "EPI_RESID": dp.EPI_RESID, "EPI_HEAD": dp.EPI_HEAD,
        "EPI_RELU": dp.EPI_RELU}
    entry = cu[cu.index("A3R_EXPORT int a3r_conv3x3("):cu.index("A3R_EXPORT int a3r_upsample2x(")]
    for check in ("is_bf16 ? GBK : TBK", "Cin % bk", "Cout % GBN", "C3 > MAX_C3",
                  "conv_box_w(W)", "bh = GBM / bw"):
        assert check in entry, check
    box = cu[cu.index("inline int conv_box_w("):]
    assert "while (bw < W && bw < CONV_BW) bw <<= 1;" in box[:box.index("}")]
    assert "wmma" not in cu.lower().replace("wgmma", "") and "TileMma" not in cu
    assert "conv_sm90" in cu and "gemm_core(&ta, &tw, &tc, ConvPolicy<EPI>{p})" in cu
