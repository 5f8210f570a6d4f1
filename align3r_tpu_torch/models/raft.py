"""SEA-RAFT (RAFT2) optical flow, inference only (port of
align3r_tpu/models/raft.py).

Config spring-M (resnet34 blocks, dims [64, 128, 256], dim 128, radius 4):
the Tartan-C-T432x960-M checkpoint the pipeline loads. The network is frozen,
so every BatchNorm is folded into a per-channel ``Affine`` (scale, bias) when
weights are loaded, as the JAX converter folds them.

The modules' tree mirrors the JAX parameter tree (``cnet.layer2.0.down_conv``
is ``params["cnet"]["layer2"][0]["down_conv"]``); a conv keeps torch's
(out, in, kh, kw) weight, a dense layer torch's (out, in). Activations are
NHWC, as in JAX, at every public function; a conv runs on the channels-last
view of its input. The correlation lookup is plain PyTorch in the one-hot
hat-function form (two batched products per level), as the JAX package
computes it in XLA.

Weights: ``raft_from_jax`` copies a JAX parameter tree (numpy leaves) one to
one; ``convert_raft2_state_dict`` folds a reference-format state dict the
way the JAX converter does; ``load_raft_checkpoint`` reads a reference
``.pth``; ``init_raft_`` draws seeded random weights from the JAX
``init_raft`` distributions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.nn import device_or_raise


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    dim: int = 128
    radius: int = 4
    corr_levels: int = 4
    initial_dim: int = 64
    block_dims: Tuple[int, ...] = (64, 128, 256)
    n_blocks: Tuple[int, ...] = (3, 4, 6)   # resnet34
    num_refine: int = 2                      # ConvNext blocks in the update
    iters: int = 20

    @property
    def corr_channel(self) -> int:
        return self.corr_levels * (2 * self.radius + 1) ** 2


SPRING_M = RAFTConfig()


# ------------------------------------------------------------- primitives

class Conv(nn.Module):
    """A 2-D convolution on NHWC activations (the JAX {kernel, bias} leaf).
    `padding` defaults to SAME for the odd kernels at stride 1.

    A conv whose output channels are not a multiple of 8 (the motion
    encoder's 126, the flow heads' 6 and 2) runs with its weight padded with
    zero filters to the next multiple and the extra channels dropped: cuDNN
    sends fp32 convolutions of 126 outputs to FFT kernels that took most of
    RAFT's time on the H100 (tools/profile_flow.py)."""

    def __init__(self, cin: int, cout: int, k, groups: int = 1, bias: bool = True):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.groups = groups

    def forward(self, x, stride: int = 1, padding=None):
        if padding is None:
            padding = (self.weight.shape[2] // 2, self.weight.shape[3] // 2)
        w, b = self.weight, self.bias
        cout = w.shape[0]
        extra = -cout % 8 if self.groups == 1 else 0
        if extra:
            w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, extra))
            b = None if b is None else F.pad(b, (0, extra))
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)[..., :cout]


class Affine(nn.Module):
    """Folded BatchNorm: per-channel scale and bias."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x * self.scale + self.bias


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return L.layernorm(x, self.scale, self.bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.conv2 = Conv(cin, cout, 3), Conv(cout, cout, 3)
        self.bn1, self.bn2 = Affine(cout), Affine(cout)
        if stride != 1 or cin != cout:
            self.down_conv, self.bn3 = Conv(cin, cout, 1), Affine(cout)

    def forward(self, x):
        # explicit (1, 1) padding: torch's symmetric stride-2 padding
        y = F.relu(self.bn1(self.conv1(x, self.stride, padding=1)))
        y = F.relu(self.bn2(self.conv2(y)))
        if hasattr(self, "down_conv"):
            x = self.bn3(self.down_conv(x, self.stride, padding=0))
        return F.relu(x + y)


class ResNetFPN(nn.Module):
    """The 1/8-resolution feature extractor (JAX resnet_fpn)."""

    def __init__(self, cfg: RAFTConfig, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(in_dim, cfg.initial_dim, 7), Affine(cfg.initial_dim)
        ip = cfg.initial_dim
        for li, (n, stride, dim) in enumerate(zip(cfg.n_blocks, (1, 2, 2), cfg.block_dims),
                                              start=1):
            setattr(self, f"layer{li}", nn.ModuleList(
                [BasicBlock(ip if bi == 0 else dim, dim, stride if bi == 0 else 1)
                 for bi in range(n)]))
            ip = dim
        self.n_layers = len(cfg.n_blocks)
        self.final_conv = Conv(cfg.block_dims[-1], out_dim, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x, 2, padding=3)))
        for li in range(1, self.n_layers + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
        return self.final_conv(x)


class ConvNextBlock(nn.Module):
    """ConvNeXt block with a final projection (JAX conv_next_block)."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1, self.pwconv2 = nn.Linear(dim, 4 * out), nn.Linear(4 * out, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))
        self.final = Conv(dim, out, 1)

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        y = self.pwconv2(L.gelu(self.pwconv1(y))) * self.gamma
        return self.final(x + y)


class MotionEncoder(nn.Module):
    """BasicMotionEncoder (convc1, convc2, convf1, convf2, conv)."""

    def __init__(self, corr_channel: int, c1: int, c2: int, f1: int, f2: int, out: int):
        super().__init__()
        self.convc1, self.convc2 = Conv(corr_channel, c1, 1), Conv(c1, c2, 3)
        self.convf1, self.convf2 = Conv(2, f1, 7), Conv(f1, f2, 3)
        self.conv = Conv(c2 + f2, out, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], -1)))
        return torch.cat([out, flow], -1)


class TwoConv(nn.Module):
    """conv2(relu(conv1(x))): the flow head and the upsample-weight head."""

    def __init__(self, cin: int, mid: int, cout: int, k2: int):
        super().__init__()
        self.conv1, self.conv2 = Conv(cin, mid, 3), Conv(mid, cout, k2)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        D = cfg.dim
        self.encoder = MotionEncoder(cfg.corr_channel, 2 * D, D + D // 2, D, D // 2, D - 2)
        self.refine = nn.ModuleList([ConvNextBlock(3 * D, D) for _ in range(cfg.num_refine)])

    def forward(self, net, context, corr, flow):
        inp = torch.cat([context, self.encoder(flow, corr)], -1)
        for block in self.refine:
            net = block(torch.cat([net, inp], -1))
        return net


class RAFT2(nn.Module):
    """SEA-RAFT, BatchNorms folded; frozen."""
    kind = "raft2"

    def __init__(self, cfg: RAFTConfig = SPRING_M):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        self.cnet = ResNetFPN(cfg, 6, 2 * D)
        self.fnet = ResNetFPN(cfg, 3, 2 * D)
        self.init_conv = Conv(2 * D, 2 * D, 3)
        self.flow_head = TwoConv(D, 2 * D, 6, 3)
        self.upsample_weight = TwoConv(D, 2 * D, 64 * 9, 1)
        self.update_block = UpdateBlock(cfg)
        self.requires_grad_(False)


# ------------------------------------------------------------- correlation

def build_corr_pyramid(fmap1, fmap2, cfg: RAFTConfig) -> List[torch.Tensor]:
    """All-pairs correlation at corr_levels scales of fmap2. fmap* (B, h, w, C).
    Returns a list of (B, h1*w1, h2_l, w2_l)."""
    B, h1, w1, C = fmap1.shape
    f1 = fmap1.reshape(B, h1 * w1, C)
    pyramid, f2 = [], fmap2
    for _ in range(cfg.corr_levels):
        _, h2, w2, _ = f2.shape
        c = torch.bmm(f1, f2.reshape(B, h2 * w2, C).transpose(1, 2)) / math.sqrt(C)
        pyramid.append(c.reshape(B, h1 * w1, h2, w2))
        f2 = L.bilinear_resize(f2, max(h2 // 2, 1), max(w2 // 2, 1), align_corners=False)
    return pyramid


def lookup_corr(pyramid, coords, cfg: RAFTConfig):
    """Bilinear samples of each level in a (2r+1)^2 window around
    coords / 2^level, zero outside. coords (B, h1, w1, 2) level-0 (x, y).
    Returns (B, h1, w1, corr_channel).

    Hat-function form: sample[i, j] = sum_hw Wx[i, w] corr[h, w] Wy[j, h],
    Wy[j, h] = relu(1 - |cy + d[j] - h|). Window channel (i, j) samples
    (x + d[i], y + d[j]): the reference's order, which its checkpoint's conv
    weights depend on."""
    r = cfg.radius
    B, h1, w1, _ = coords.shape
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    cx = coords[..., 0].reshape(B, h1 * w1)
    cy = coords[..., 1].reshape(B, h1 * w1)
    out = []
    for lvl, corr in enumerate(pyramid):
        _, _, h2, w2 = corr.shape
        hg = torch.arange(h2, dtype=torch.float32, device=coords.device)
        wg = torch.arange(w2, dtype=torch.float32, device=coords.device)
        wy = F.relu(1.0 - torch.abs((cy / 2 ** lvl)[:, :, None, None] + d[:, None] - hg))
        wx = F.relu(1.0 - torch.abs((cx / 2 ** lvl)[:, :, None, None] + d[:, None] - wg))
        tmp = torch.matmul(wy, corr)                          # (B, N, j, w2)
        smp = torch.matmul(wx, tmp.transpose(-1, -2))         # (B, N, i, j)
        out.append(smp.reshape(B, h1, w1, -1))
    return torch.cat(out, dim=-1)


# ----------------------------------------------------------------- forward

def coords_grid(B: int, h: int, w: int, device=None):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], -1)[None].expand(B, h, w, 2)


def unfold9(x):
    """3x3 patches with zero padding: (B, h, w, C) -> (B, h, w, 9, C)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                       dim=3)


def upsample_data(flow, info, mask):
    """Convex-combination 8x upsampling. flow (B, h, w, 2); info
    (B, h, w, C); mask (B, h, w, 576)."""
    B, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(B, h, w, 9, 8, 8), dim=3)
    f = torch.einsum("bhwkuv,bhwkc->bhuwvc", m, unfold9(8 * flow))
    i = torch.einsum("bhwkuv,bhwkc->bhuwvc", m, unfold9(info))
    return f.reshape(B, h * 8, w * 8, 2), i.reshape(B, h * 8, w * 8, info.shape[-1])


def pad_to_8(img):
    """Symmetric replicate pad of (B, H, W, C) to multiples of 8 (InputPadder
    'sintel'). Returns (padded, (top, bottom, left, right))."""
    H, W = img.shape[1:3]
    ph, pw = (-H) % 8, (-W) % 8
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    out = F.pad(img.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]),
                mode="replicate")
    return out.permute(0, 2, 3, 1), pads


def exact_fp32():
    """RAFT runs in fp32 (JAX compute_raft_flows resolves "auto" to fp32):
    no TF32 in cuDNN's convolutions or in matmuls on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@torch.no_grad()
def raft_forward(raft: RAFT2, image1, image2, iters: int | None = None):
    """image1/2 (B, H, W, 3) in [0, 255]. Returns the final flow
    (B, H, W, 2) at full resolution, fp32."""
    exact_fp32()
    cfg = raft.cfg
    iters = cfg.iters if iters is None else iters
    image1, pads = pad_to_8(2 * (image1.float() / 255.0) - 1.0)
    image2, _ = pad_to_8(2 * (image2.float() / 255.0) - 1.0)
    B, H, W, _ = image1.shape

    cnet = raft.init_conv(raft.cnet(torch.cat([image1, image2], -1)))
    net, context = torch.split(cnet, cfg.dim, dim=-1)
    fu = raft.flow_head(net)
    flow_8x = fu[..., :2]
    fmap1, fmap2 = torch.split(raft.fnet(torch.cat([image1, image2], 0)), B, dim=0)
    pyramid = build_corr_pyramid(fmap1, fmap2, cfg)
    grid = coords_grid(B, H // 8, W // 8, device=image1.device)
    for _ in range(iters):
        corr = lookup_corr(pyramid, grid + flow_8x, cfg)
        net = raft.update_block(net, context, corr, flow_8x)
        fu = raft.flow_head(net)
        flow_8x = flow_8x + fu[..., :2]
    wgt = 0.25 * raft.upsample_weight(net)
    flow_up, _ = upsample_data(flow_8x, fu[..., 2:], wgt)
    t, b, l, r = pads
    return flow_up[:, t:H - b, l:W - r]


# ---------------------------------------------------------------- weights

def load_jax_tree(module: nn.Module, tree) -> None:
    """Copy a JAX parameter tree (numpy leaves) into `module` one to one:
    a conv kernel HWIO -> (out, in, kh, kw), a dense kernel (in, out) ->
    (out, in), every other leaf as it is. Raises on a missing leaf, a
    leaf the module does not have, or a shape that differs."""
    leaves = {}

    def walk(t, pfx):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pfx}{k}.")
        elif isinstance(t, (list, tuple)):
            for k, v in enumerate(t):
                walk(v, f"{pfx}{k}.")
        elif np.asarray(t).dtype != bool:        # JAX's "downsample": True flags
            leaves[pfx[:-1]] = np.array(t, np.float32)

    walk(tree, "")
    mods = dict(module.named_modules())
    seen = set()
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner, leaf = name.rpartition(".")[::2]
            src = f"{owner}.kernel" if leaf == "weight" else name
            v = leaves[src]
            if isinstance(mods[owner], Conv) and leaf == "weight":
                v = v.transpose(3, 2, 0, 1)
            elif isinstance(mods[owner], nn.Linear) and leaf == "weight":
                v = v.T
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {v.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
            seen.add(src)
    extra = set(leaves) - seen
    if extra:
        raise ValueError(f"tree leaves the module does not have: {sorted(extra)[:5]}")


def raft_from_jax(params, cfg: RAFTConfig = SPRING_M) -> RAFT2:
    """A RAFT2 module from a JAX parameter tree of numpy arrays."""
    model = RAFT2(cfg)
    load_jax_tree(model, params)
    return model


def _bn_fold(sd, name, eps=1e-5):
    w, b = np.asarray(sd[f"{name}.weight"]), np.asarray(sd[f"{name}.bias"])
    mean = np.asarray(sd[f"{name}.running_mean"])
    var = np.asarray(sd[f"{name}.running_var"])
    scale = w / np.sqrt(var + eps)
    return {"scale": scale, "bias": b - mean * scale}


def _conv(sd, name):
    p = {"kernel": np.asarray(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def _strip_module(sd):
    return {k[7:] if k.startswith("module.") else k: np.asarray(v) for k, v in sd.items()}


def _raft2_tree(sd: Dict[str, np.ndarray], cfg: RAFTConfig) -> Dict:
    """The JAX converter's tree (align3r_tpu/models/raft.py:320-370)."""
    sd = _strip_module(sd)
    lin = lambda n: {"kernel": np.asarray(sd[f"{n}.weight"]).T,
                     "bias": np.asarray(sd[f"{n}.bias"])}

    def fpn(pfx):
        p = {"conv1": _conv(sd, f"{pfx}.conv1"), "bn1": _bn_fold(sd, f"{pfx}.bn1"),
             "final_conv": _conv(sd, f"{pfx}.final_conv")}
        for li, n in enumerate(cfg.n_blocks, start=1):
            blocks = []
            for bi in range(n):
                q = f"{pfx}.layer{li}.{bi}"
                b = {"conv1": _conv(sd, f"{q}.conv1"), "conv2": _conv(sd, f"{q}.conv2"),
                     "bn1": _bn_fold(sd, f"{q}.bn1"), "bn2": _bn_fold(sd, f"{q}.bn2")}
                if f"{q}.downsample.0.weight" in sd:
                    b["down_conv"] = _conv(sd, f"{q}.downsample.0")
                    b["bn3"] = _bn_fold(sd, f"{q}.bn3")
                blocks.append(b)
            p[f"layer{li}"] = blocks
        return p

    def convnext(pfx):
        return {"dwconv": _conv(sd, f"{pfx}.dwconv"),
                "norm": {"scale": sd[f"{pfx}.norm.weight"], "bias": sd[f"{pfx}.norm.bias"]},
                "pwconv1": lin(f"{pfx}.pwconv1"), "pwconv2": lin(f"{pfx}.pwconv2"),
                "gamma": sd[f"{pfx}.gamma"], "final": _conv(sd, f"{pfx}.final")}

    return {
        "cnet": fpn("cnet"), "fnet": fpn("fnet"), "init_conv": _conv(sd, "init_conv"),
        "flow_head": {"conv1": _conv(sd, "flow_head.0"), "conv2": _conv(sd, "flow_head.2")},
        "upsample_weight": {"conv1": _conv(sd, "upsample_weight.0"),
                            "conv2": _conv(sd, "upsample_weight.2")},
        "update_block": {
            "encoder": {k: _conv(sd, f"update_block.encoder.{k}")
                        for k in ("convc1", "convc2", "convf1", "convf2", "conv")},
            "refine": [convnext(f"update_block.refine.{i}") for i in range(cfg.num_refine)]},
    }


def convert_raft2_state_dict(sd: Dict[str, np.ndarray],
                             cfg: RAFTConfig = SPRING_M) -> RAFT2:
    """A reference-format RAFT2 state dict (numpy or torch values) -> RAFT2
    with its BatchNorms folded, on the CPU."""
    return raft_from_jax(_raft2_tree(sd, cfg), cfg)


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def load_raft_checkpoint(path: str, cfg: RAFTConfig = SPRING_M, device="cuda") -> RAFT2:
    """A reference SEA-RAFT .pth, on `device` (the card unless "cpu" is asked for)."""
    dev = device_or_raise(device)
    return convert_raft2_state_dict(read_state_dict(path), cfg).to(dev)


def init_raft_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights from the JAX init_raft distributions: convs
    U(+-1/sqrt(fan_in)) (depthwise N(0, 0.02)) with zero bias, dense layers
    Xavier-uniform with zero bias, affines and norms identity, ConvNeXt gamma
    1e-6. Drawn on the CPU and copied, so every device gets the same bits."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                w = m.weight
                if m.groups > 1:
                    v = torch.randn(w.shape, generator=g) * 0.02
                else:
                    b = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
                    v = (torch.rand(w.shape, generator=g) * 2 - 1) * b
                w.copy_(v)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                a = math.sqrt(6.0 / (m.in_features + m.out_features))
                m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * a)
                m.bias.zero_()
            elif isinstance(m, (Affine, LayerNorm)):
                m.scale.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ConvNextBlock):
                m.gamma.fill_(1e-6)
    return model
