"""The DPT head's fused convolution stages: kernels K7 and K8 beside their
plain PyTorch versions (port of align3r_tpu/ops/dpt_pipeline.py, the
``head_conv_impl="pipeline"`` heads).

K7 ``fused_res_unit`` replaces ``_res_unit_kernel`` (dpt_pipeline.py:101,
called through ``_res_unit_call`` :176): the refinenet residual conv unit
v + conv2(relu(conv1(relu(v)))) (+ base), NHWC, SAME zero padding, fp32
accumulation with the bias added in fp32 before each conv's rounding to the
storage dtype, the residual adds in the storage dtype. Its backward is
autograd of the plain version, as the JAX custom VJP differentiates
``_xla_twin`` (:238-258); no backward kernel is owed.

K8 ``fused_head_final`` replaces ``_head_trio_kernel`` (:319, through
``_head_trio_call`` :389): conv1 3x3 (rounded) -> 2x align_corners bilinear
upsample, columns first with the column weights in the storage dtype (as JAX
casts Aw to x's dtype, :473), rounded, then rows with fp32 weights, rounded
-> relu(conv2 3x3 + b2) kept in fp32 -> the fp32 1x1 conv3. Returns
(B, 2Hin, 2Win, Cout) fp32; the caller crops. No VJP, as in JAX.

The XLA head (models/dpt_head.py) rounds each conv's output before adding its
bias (nn.conv2d) and resizes rows first without the intermediate rounding, so
the pipeline and XLA heads differ by one bf16 rounding per stage, in both
packages.

The CUDA implementation is csrc/dpt_pipeline.cu: each 3x3 conv is one launch
of an implicit GEMM with an epilogue (``conv3x3_plain`` is one launch's plain
version), in bf16 on the Hopper GEMM core of csrc/gemm.cuh (each k-tile a
tap-shifted, zero-filled box of BW x BH pixels, ``conv_tiles_plain``), in fp32
on the same walk with 3xTF32 tensor-core products (``conv_tiles_tf32_plain``;
the wrapper splits the taps, ``tf32_taps``); the upsample is a two-tap
kernel. What bounds them and what the design does about it is written at the
top of that file.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernels (counted on ``fused_res_unit.launches`` and
``fused_head_final.launches``, once per call, and the fp32 calls, which
launch the 3xTF32 kernel, on ``launches_fp32`` as well) or raises for a
dtype or shape they do not take. There is no fallback.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from align3r_tpu_torch.models.nn import _interp_matrix
from align3r_tpu_torch.ops import _lib
from align3r_tpu_torch.ops.autograd import KernelWithTwin
from align3r_tpu_torch.ops.small_attention import tf32_mm, tf32_round

# the epilogues (csrc/dpt_pipeline.cu enum Epi) and the kernels' tiles:
# CONV_BM pixels x CONV_BN output channels (gemm.cuh's GBM, GBN), k-tiles of
# CONV_BK input channels in bf16 (GBK) and TF32_BK in fp32 (TBK), boxes at
# most CONV_BW pixels wide, at most MAX_C3 outputs of the 1x1 conv
EPI_ROUND, EPI_RESID, EPI_HEAD, EPI_RELU = 0, 1, 2, 3
CONV_BM, CONV_BN, CONV_BK, TF32_BK, CONV_BW = 128, 128, 64, 32, 64
MAX_C3 = 16
# the fp32 kernel's k order in each TF32_BK block of the taps: k8 slice kk's
# k = q and q + 4 are channels 8 q + 2 kk and 8 q + 2 kk + 1 (the A fragment
# a thread reads as one 16-byte chunk a row, csrc/dpt_pipeline.cu tf32_frags)
TF32_K_ORDER = tuple(8 * (k % 4) + 2 * kk + k // 4 for kk in range(4) for k in range(8))


def supported(x) -> bool:
    """The JAX gate of the fused residual unit (dpt_pipeline.py:86-88)."""
    B, H, W, C = x.shape
    return C % 128 == 0 and W >= 8 and H >= 2


def head_trio_supported(x, TH: int = 16) -> bool:
    """The JAX gate of the fused head tail (dpt_pipeline.py:455-458)."""
    B, Hin, Win, C1 = x.shape
    return C1 % 128 == 0 and Win % 8 == 0 and (2 * Hin) % TH == 0 and Hin >= 8


def _taps(w):
    """torch conv weight (out, in, 3, 3) -> (9, in, out), tap dh * 3 + dw."""
    return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])


def _unit_weights(unit, dtype):
    """((w1, b1), (w2, b2)) torch convs -> ((2, 9, Cin, C) taps in `dtype`,
    (2, C) fp32 biases), as JAX _unit_weights (:261-269)."""
    (w1, b1), (w2, b2) = unit
    return (torch.stack([_taps(w1), _taps(w2)]).to(dtype),
            torch.stack([b1, b2]).float())


def _conv_plain(x, taps, bias):
    """3x3 SAME conv of the storage-dtype operands with fp32 accumulation,
    plus the fp32 bias; returns fp32."""
    Cin, Cout = taps.shape[1:]
    w = taps.reshape(3, 3, Cin, Cout).permute(3, 2, 0, 1).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=1).permute(0, 2, 3, 1)
    return y + bias.float()


def conv3x3_plain(x, taps, bias, epi, relu_in=False, resid=None, base=None, w3=None,
                  b3=None):
    """Plain version of one conv launch (``a3r_conv3x3``), in its epilogue's
    rounding order, on conv(x) (conv(relu(x)) with relu_in) + bias in fp32:
      EPI_ROUND  round(y)
      EPI_RELU   round(relu(y))                       (= relu(round(y)))
      EPI_RESID  round(round(resid + round(y)) + base), base optional
      EPI_HEAD   relu(y) @ w3 + b3, fp32."""
    y = _conv_plain(torch.relu(x) if relu_in else x, taps, bias)
    if epi == EPI_HEAD:
        return torch.relu(y) @ w3 + b3
    y = (torch.relu(y) if epi == EPI_RELU else y).to(x.dtype)
    if epi == EPI_RESID:
        y = resid + y
        if base is not None:
            y = y + base
    return y


def conv_box(W: int) -> tuple[int, int]:
    """The bf16 kernel's box (BW, BH) at image width W: CONV_BW pixels of a
    row for W >= CONV_BW, else the power of two >= W, by CONV_BM / BW rows
    (csrc/dpt_pipeline.cu conv_box_w)."""
    bw = 1
    while bw < W and bw < CONV_BW:
        bw *= 2
    return bw, CONV_BM // bw


def conv_walk(B: int, H: int, W: int, Cout: int):
    """The bf16 kernel's tiles (b, h0, w0, n0) in its walk order: N fastest,
    then along W, H and B."""
    bw, bh = conv_box(W)
    for b in range(B):
        for h0 in range(0, H, bh):
            for w0 in range(0, W, bw):
                for n0 in range(0, Cout, CONV_BN):
                    yield b, h0, w0, n0


def conv_tiles_plain(x, taps, bias):
    """conv3x3(x) + bias in fp32, computed as the bf16 kernel walks it: for
    each tile, each k-tile kt (tap kt // (Cin / CONV_BK), channel block
    kt % (Cin / CONV_BK)) is the box of BW x BH pixels at (h0 + dh - 1,
    w0 + dw - 1), zero where it falls outside the image (the TMA's fill: the
    SAME padding), times rows kt * CONV_BK.. of the (9 Cin, Cout) taps; the
    tile's pixels past H or W are dropped (the store's clip)."""
    B, H, W, Cin = x.shape
    Cout = taps.shape[-1]
    bw, bh = conv_box(W)
    wk = taps.reshape(9 * Cin, Cout).float()
    xp = F.pad(x.float(), (0, 0, 1, bw + 1, 1, bh + 1))   # the zero frame around the image
    out = torch.empty(B, H, W, Cout)
    kc = Cin // CONV_BK
    for b, h0, w0, n0 in conv_walk(B, H, W, Cout):
        acc = torch.zeros(bh * bw, CONV_BN)
        for kt in range(9 * kc):
            tap, cb = divmod(kt, kc)
            dh, dw = divmod(tap, 3)
            box = xp[b, h0 + dh:h0 + dh + bh, w0 + dw:w0 + dw + bw,
                     cb * CONV_BK:(cb + 1) * CONV_BK]
            acc += box.reshape(bh * bw, CONV_BK) @ wk[kt * CONV_BK:(kt + 1) * CONV_BK,
                                                      n0:n0 + CONV_BN]
        tile = (acc + bias[n0:n0 + CONV_BN].float()).reshape(bh, bw, CONV_BN)
        hs, ws = min(bh, H - h0), min(bw, W - w0)
        out[b, h0:h0 + hs, w0:w0 + ws, n0:n0 + CONV_BN] = tile[:hs, :ws]
    return out


def conv_tiles_tf32_plain(x, taps, bias, split: bool = True):
    """conv3x3(x) + bias in fp32 as the fp32 kernel walks it: the bf16
    kernel's tiles and tap-shifted, zero-filled boxes (conv_tiles_plain) with
    k-tiles of TF32_BK channels, each k-tile's product one 3xTF32 product
    (small_attention.tf32_mm), summed in k-tile order. split=False runs
    single-pass TF32, the function the split exists to avoid."""
    B, H, W, Cin = x.shape
    Cout = taps.shape[-1]
    bw, bh = conv_box(W)
    wk = taps.reshape(9 * Cin, Cout).float()
    xp = F.pad(x.float(), (0, 0, 1, bw + 1, 1, bh + 1))
    out = torch.empty(B, H, W, Cout)
    kc = Cin // TF32_BK
    for b, h0, w0, n0 in conv_walk(B, H, W, Cout):
        acc = torch.zeros(bh * bw, CONV_BN)
        for kt in range(9 * kc):
            tap, cb = divmod(kt, kc)
            dh, dw = divmod(tap, 3)
            box = xp[b, h0 + dh:h0 + dh + bh, w0 + dw:w0 + dw + bw,
                     cb * TF32_BK:(cb + 1) * TF32_BK]
            acc += tf32_mm(box.reshape(bh * bw, TF32_BK),
                           wk[kt * TF32_BK:(kt + 1) * TF32_BK, n0:n0 + CONV_BN], split)
        tile = (acc + bias[n0:n0 + CONV_BN].float()).reshape(bh, bw, CONV_BN)
        hs, ws = min(bh, H - h0), min(bw, W - w0)
        out[b, h0:h0 + hs, w0:w0 + ws, n0:n0 + CONV_BN] = tile[:hs, :ws]
    return out


def tf32_taps(taps):
    """The fp32 kernel's W operand: (9, Cin, Cout) fp32 taps -> (2, Cout,
    9 Cin), their hi = tf32(w) and lo = tf32(w - hi) K-major (TF32 wgmma has
    no transpose bit), each TF32_BK block of k in TF32_K_ORDER."""
    Cin, Cout = taps.shape[1:]
    # channel 8 a + 2 kk + b of a block to position 8 kk + 4 b + a: views
    # only, so a CUDA graph can capture it
    w = taps.float().reshape(9 * Cin // TF32_BK, 4, 4, 2, Cout).permute(0, 2, 3, 1, 4)
    w = w.reshape(9 * Cin, Cout).t()
    hi = tf32_round(w)
    return torch.stack([hi, tf32_round(w - hi)]).contiguous()


def res_unit_plain(v, base, w, bias):
    """Plain version of K7, and the twin whose autograd is its backward (the
    JAX _xla_twin, :219-235). w (2, 9, C, C) taps, bias (2, C) fp32."""
    a = _conv_plain(torch.relu(v), w[0], bias[0]).to(v.dtype)
    a = _conv_plain(torch.relu(a), w[1], bias[1]).to(v.dtype)
    y = v + a
    return y if base is None else y + base


def _check_act(name, t, dtype=None):
    if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K7/K8 take bf16 or fp32 CUDA tensors; {name} is "
                         f"{t.dtype} on {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"K7/K8 need one storage dtype; {name} is {t.dtype}, not {dtype}")


def _conv(x, taps, bias, out, epi, relu, resid=None, base=None, w3=None, b3=None):
    """One launch of the implicit-GEMM 3x3 conv (csrc a3r_conv3x3: conv_sm90
    in bf16, conv_tf32_sm90 on the split taps in fp32); its plain version is
    conv3x3_plain."""
    B, H, W, Cin = x.shape
    Cout = taps.shape[-1]
    if x.dtype == torch.float32:
        taps = tf32_taps(taps)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _lib.check(_lib.library().a3r_conv3x3(
        x.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(), ptr(resid),
        ptr(base), ptr(w3), ptr(b3), B, H, W, Cin, Cout,
        0 if w3 is None else w3.shape[1], epi, int(relu),
        int(x.dtype == torch.bfloat16), _lib.stream()), "K7/K8 conv3x3")


def _res_unit_cuda(v, base, w, bias):
    B, H, W, C = v.shape
    _check_act("v", v)
    if base is not None:
        _check_act("base", base, v.dtype)
        if base.shape != v.shape:
            raise ValueError(f"K7 needs base of v's shape; got {tuple(base.shape)}, "
                             f"{tuple(v.shape)}")
    if C % 128 or tuple(w.shape) != (2, 9, C, C) or tuple(bias.shape) != (2, C):
        raise ValueError(f"K7 needs C % 128 == 0, taps (2, 9, C, C) and biases (2, C); "
                         f"got v {tuple(v.shape)}, w {tuple(w.shape)}, b {tuple(bias.shape)}")
    v = _lib.dense(v)
    base = None if base is None else _lib.dense(base)
    w = _lib.dense(w.to(v.dtype))
    bias = bias.float().contiguous()
    a = torch.empty_like(v)
    out = torch.empty_like(v)
    # conv 2's operand ReLU is conv 1's epilogue: a holds relu(a)
    _conv(v, w[0], bias[0], a, EPI_RELU, True)
    _conv(a, w[1], bias[1], out, EPI_RESID, False, resid=v, base=base)
    fused_res_unit.launches += 1
    fused_res_unit.launches_fp32 += v.dtype == torch.float32
    return out


def _res_unit_forward(v, base, w, bias):
    return _res_unit_cuda(v, base, w, bias) if v.is_cuda else res_unit_plain(v, base, w, bias)


def fused_res_unit(v, unit, base=None):
    """The DPT ResidualConvUnit v + conv2(relu(conv1(relu(v)))), plus `base`
    when given (the fusion block's x + res1(skip)), through K7. unit: the
    head's ((w1, b1), (w2, b2)) convs. Differentiable (autograd of the plain
    version)."""
    w, b = _unit_weights(unit, v.dtype)
    return KernelWithTwin.apply(_res_unit_forward, res_unit_plain, v, base, w, b)


def fused_fusion_pre(x, refinenet, skip=None):
    """The conv-heavy prefix of the fusion block: res2(x + res1(skip)), or
    res2(x) without a skip; the caller then resizes and applies out_conv."""
    if skip is not None:
        x = fused_res_unit(skip, refinenet["res1"], base=x)
    return fused_res_unit(x, refinenet["res2"])


@functools.lru_cache(maxsize=64)
def _interp_taps(n_in: int, n_out: int, round_bf16: bool):
    """Each output's two source indices and weights, read from the
    _interp_matrix row (its nonzeros; one index twice with weight 0 where
    the row has one). Weights rounded to bf16 when `round_bf16`.
    Returns (idx (n_out, 2) int32, wt (n_out, 2) fp32)."""
    A = _interp_matrix(n_in, n_out, True)
    if round_bf16:
        A = torch.from_numpy(A).to(torch.bfloat16).float().numpy()
    idx = np.zeros((n_out, 2), np.int32)
    wt = np.zeros((n_out, 2), np.float32)
    for o in range(n_out):
        nz = np.nonzero(A[o])[0]
        lo, hi = int(nz[0]), int(nz[-1])
        idx[o] = lo, hi
        wt[o] = A[o, lo], (A[o, hi] if hi != lo else 0.0)
    return idx, wt


@functools.lru_cache(maxsize=64)
def _interp_taps_on(n_in: int, n_out: int, round_bf16: bool, device: str):
    """_interp_taps as tensors on `device`, made once: a call on the card then
    copies nothing from the host (and can be captured in a CUDA graph)."""
    return tuple(torch.from_numpy(a).to(device) for a in _interp_taps(n_in, n_out, round_bf16))


def _head_weights(p1, p2, p3, dtype):
    (w1, b1), (w2, b2), (w3, b3) = p1, p2, p3
    return (_taps(w1).to(dtype), b1.float(), _taps(w2).to(dtype), b2.float(),
            w3[:, :, 0, 0].t().float(), b3.float())


def upsample2x_plain(h1):
    """Plain version of K8's upsample launch: 2x align_corners, columns first
    with the column weights in h1's dtype (rounded), then rows with fp32
    weights (rounded)."""
    B, Hin, Win, _ = h1.shape
    aw = torch.from_numpy(_interp_matrix(Win, 2 * Win, True)).to(h1.device)
    ah = torch.from_numpy(_interp_matrix(Hin, 2 * Hin, True)).to(h1.device)
    h1w = torch.einsum("ow,bhwc->bhoc", aw.to(h1.dtype).float(), h1.float()).to(h1.dtype)
    return torch.einsum("oh,bhwc->bowc", ah, h1w.float()).to(h1.dtype)


def head_final_plain(x, w1, b1, w2, b2, w3, b3):
    """Plain version of K8. w1 (9, C1, C2), w2 (9, C2, C2) taps in x's dtype;
    w3 (C2, Cout) fp32; biases fp32. Returns (B, 2Hin, 2Win, Cout) fp32."""
    h1 = _conv_plain(x, w1, b1).to(x.dtype)
    a2 = torch.relu(_conv_plain(upsample2x_plain(h1), w2, b2))
    return a2 @ w3 + b3


def _head_final_cuda(x, w1, b1, w2, b2, w3, b3):
    B, Hin, Win, C1 = x.shape
    C2, Cout = w1.shape[-1], w3.shape[-1]
    _check_act("x", x)
    bk = CONV_BK if x.dtype == torch.bfloat16 else TF32_BK
    if (C1 % bk or C2 != 128 or tuple(w1.shape) != (9, C1, C2)
            or tuple(w2.shape) != (9, C2, C2) or tuple(w3.shape) != (C2, Cout)
            or not 1 <= Cout <= MAX_C3):
        raise ValueError(f"K8 needs C1 % {bk} == 0 ({x.dtype}), 128 mid channels and 1..{MAX_C3} "
                         f"outputs; got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)}")
    dev, dt = x.device, x.dtype
    x = _lib.dense(x)
    w1, w2 = _lib.dense(w1.to(dt)), _lib.dense(w2.to(dt))
    b1, b2, w3, b3 = (t.float().contiguous() for t in (b1, b2, w3, b3))
    hidx, hwt = _interp_taps_on(Hin, 2 * Hin, False, str(dev))
    widx, wwt = _interp_taps_on(Win, 2 * Win, dt == torch.bfloat16, str(dev))
    h1 = torch.empty(B, Hin, Win, C2, device=dev, dtype=dt)
    _conv(x, w1, b1, h1, EPI_ROUND, False)
    h2 = torch.empty(B, 2 * Hin, 2 * Win, C2, device=dev, dtype=dt)
    _lib.check(_lib.library().a3r_upsample2x(
        h1.data_ptr(), h2.data_ptr(), hidx.data_ptr(), hwt.data_ptr(), widx.data_ptr(),
        wwt.data_ptr(), B, Hin, Win, C2, int(dt == torch.bfloat16), _lib.stream()),
        "K8 upsample")
    out = torch.empty(B, 2 * Hin, 2 * Win, Cout, device=dev, dtype=torch.float32)
    _conv(h2, w2, b2, out, EPI_HEAD, False, w3=w3, b3=b3)
    fused_head_final.launches += 1
    fused_head_final.launches_fp32 += dt == torch.float32
    return out


def fused_head_final(x, p1, p2, p3):
    """The head tail conv3x3(p1) -> 2x align_corners resize ->
    relu(conv3x3(p2)) -> fp32 conv1x1(p3) through K8. x (B, Hin, Win, C1);
    p1..p3 the head's (weight, bias) convs (p3 fp32). Returns
    (B, 2Hin, 2Win, Cout) fp32."""
    ws = _head_weights(p1, p2, p3, x.dtype)
    return _head_final_cuda(x, *ws) if x.is_cuda else head_final_plain(x, *ws)


fused_res_unit.launches = fused_res_unit.launches_fp32 = 0
fused_head_final.launches = fused_head_final.launches_fp32 = 0
