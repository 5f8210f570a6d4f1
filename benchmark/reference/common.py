"""Plain layer functions of the reference, and the precision they run in.

The reference computes in float32 with TF32 off. Its control computes the
same functions one precision step below what a configuration states for
each part (``Precision("control")``): the operands of every product of a
float32 part are rounded to TF32, those of a bf16 part to fp8 e4m3 with a
per-tensor scale, and the solve's bf16 pack to fp8, its fp32 polish to
TF32. ``Precision("stated")`` rounds them to the stated precision itself,
which gives each seed's own scale of rounding. Products accumulate in
float32 either way, as the tensor cores do.

Nothing here imports the program under test: these are plain torch
functions, frozen with the benchmark.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# what each part of a configuration is computed in ("precision" in the
# configuration file) and the step below it that the control takes
STEP_BELOW = {"fp32": "tf32", "bf16": "fp8", "fp8": "int4"}


def exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, round to nearest even), as float32."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x):
    """x through fp8 e4m3 with a per-tensor scale (amax to 448), as float32."""
    xf = x.float()
    amax = xf.abs().amax()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (xf / s).to(torch.float8_e4m3fn).float() * s


def round_bf16(x):
    return x.to(torch.bfloat16).float()


_ROUND = {"fp32": lambda x: x.float(), "tf32": round_tf32, "fp8": round_fp8,
          "bf16": round_bf16}


class Precision:
    """mode "reference": every part in float32. mode "stated": each part's
    operands rounded to the precision `stated` gives for it. mode "control":
    each part one step below that (STEP_BELOW)."""

    def __init__(self, mode: str = "reference", stated=None):
        if mode not in ("reference", "stated", "control"):
            raise ValueError(mode)
        self.mode = mode
        self.stated = dict(stated or {})
        self.flops = {}          # (part, "mm" | "attn") -> operations counted

    def count(self, part: str, kind: str, n: float):
        self.flops[(part, kind)] = self.flops.get((part, kind), 0.0) + float(n)

    def kind(self, part: str) -> str:
        if self.mode == "reference":
            return "fp32"
        if self.mode == "stated":
            return self.stated[part]
        return STEP_BELOW[self.stated[part]]

    def r(self, part: str, *ts):
        f = _ROUND[self.kind(part)]
        out = tuple(None if t is None else f(t) for t in ts)
        return out if len(out) > 1 else out[0]


def linear(P, part, x, w, b=None):
    """x @ w.T + b with torch's (out, in) weight."""
    P.count(part, "mm", 2.0 * x.numel() / x.shape[-1] * w.shape[0] * w.shape[1])
    x, w = P.r(part, x, w)
    return F.linear(x, w, None if b is None else b.float())


def conv2d(P, part, x, w, b=None, stride=1, padding=0):
    """NCHW convolution."""
    x, w = P.r(part, x, w)
    y = F.conv2d(x, w, None if b is None else b.float(), stride=stride, padding=padding)
    P.count(part, "mm", 2.0 * y.numel() * w[0].numel())
    return y


def conv_transpose2d(P, part, x, w, b=None, stride=1):
    P.count(part, "mm", 2.0 * x.numel() * w[0].numel())
    x, w = P.r(part, x, w)
    return F.conv_transpose2d(x, w, None if b is None else b.float(), stride=stride)


def attention(P, part, q, k, v):
    """Softmax attention, (B, H, N, D) each, scale D^-1/2, softmax in float32."""
    B, H, Nq, D = q.shape
    P.count(part, "attn", 4.0 * B * H * Nq * k.shape[2] * D)
    q, k = P.r(part, q, k)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1)
    p, v = P.r(part, p, v)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def layernorm(x, w, b, eps=1e-6):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def gelu(x):
    return F.gelu(x, approximate="none")


# ------------------------------------------------------- jax.image.resize

def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


def resize_weights(n_in: int, n_out: int, method: str, device):
    """(in, out) weights of jax.image.resize along one axis: half-pixel
    centres, the kernel widened by in / out when shrinking, columns summing
    to 1, columns sampling outside the input zeroed."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    ks = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / ks
    w = (_keys_cubic if method == "bicubic" else _triangle)(x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def jax_resize(x, out_h: int, out_w: int, method: str = "bilinear"):
    """jax.image.resize of an NHWC (or (B, H, W)) float32 tensor."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[..., None]
    H, W = x.shape[1:3]
    if out_h != H:
        x = torch.einsum("hH,bhwc->bHwc", resize_weights(H, out_h, method, x.device), x)
    if out_w != W:
        x = torch.einsum("wW,bhwc->bhWc", resize_weights(W, out_w, method, x.device), x)
    return x[..., 0] if squeeze else x


def interp(x, h, w, align_corners):
    """NCHW bilinear, torch's F.interpolate semantics."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=align_corners)


def seeded(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator for (seed, keys...): the benchmark's draws."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, *map(int, keys)])

