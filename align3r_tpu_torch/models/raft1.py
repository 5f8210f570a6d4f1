"""Classic RAFT (RAFT1), inference only, and the loader that picks between
the two RAFTs (port of align3r_tpu/models/raft1.py).

fnet normalises with InstanceNorm (per-sample statistics, no parameters);
cnet's BatchNorms are folded into ``Affine`` scale / bias. The correlation
pyramid average-pools the level-0 volume; the update is the separable
(1x5 then 5x1) ConvGRU. The modules' tree mirrors the JAX parameter tree,
as in models/raft.py.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.raft import (
    Affine, Conv, MotionEncoder, RAFTConfig, TwoConv, _bn_fold, _conv, _strip_module,
    coords_grid, exact_fp32, load_jax_tree, load_raft_checkpoint, lookup_corr, pad_to_8,
    read_state_dict, unfold9)


@dataclasses.dataclass(frozen=True)
class RAFT1Config:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20

    @property
    def corr_channel(self):
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d without affine on NHWC: per sample and channel."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, batch_norm: bool):
        super().__init__()
        self.stride = stride
        self.conv1, self.conv2 = Conv(cin, cout, 3), Conv(cout, cout, 3)
        if batch_norm:
            self.norm1, self.norm2 = Affine(cout), Affine(cout)
        if stride != 1:
            self.down_conv = Conv(cin, cout, 1)
            if batch_norm:
                self.norm3 = Affine(cout)

    def _norm(self, name, x):
        return getattr(self, name)(x) if hasattr(self, name) else instance_norm(x)

    def forward(self, x):
        y = F.relu(self._norm("norm1", self.conv1(x, self.stride, padding=1)))
        y = F.relu(self._norm("norm2", self.conv2(y)))
        if hasattr(self, "down_conv"):
            x = self._norm("norm3", self.down_conv(x, self.stride, padding=0))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """conv7 s2 -> three stages (64, 96, 128) of two residual blocks ->
    conv1x1 to out_dim. batch_norm False: InstanceNorm (fnet)."""

    def __init__(self, out_dim: int, batch_norm: bool):
        super().__init__()
        self.conv1 = Conv(3, 64, 7)
        if batch_norm:
            self.norm1 = Affine(64)
        for li, (cin, cout, stride) in enumerate(((64, 64, 1), (64, 96, 2), (96, 128, 2)),
                                                 start=1):
            setattr(self, f"layer{li}", nn.ModuleList(
                [ResidualBlock(cin, cout, stride, batch_norm),
                 ResidualBlock(cout, cout, 1, batch_norm)]))
        self.conv2 = Conv(128, out_dim, 1)

    def forward(self, x):
        x = self.conv1(x, 2, padding=3)
        x = F.relu(self.norm1(x) if hasattr(self, "norm1") else instance_norm(x))
        for li in (1, 2, 3):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
        return self.conv2(x)


class SepConvGRU(nn.Module):
    """Horizontal (1x5) then vertical (5x1) ConvGRU."""

    def __init__(self, hidden: int, inp: int):
        super().__init__()
        for k, shape in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{k}", Conv(hidden + inp, hidden, shape))

    def forward(self, h, x):
        for k in "12":
            hx = torch.cat([h, x], -1)
            z = torch.sigmoid(getattr(self, f"convz{k}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{k}")(hx))
            q = torch.tanh(getattr(self, f"convq{k}")(torch.cat([r * h, x], -1)))
            h = (1 - z) * h + z * q
        return h


class UpdateBlock1(nn.Module):
    def __init__(self, cfg: RAFT1Config):
        super().__init__()
        self.encoder = MotionEncoder(cfg.corr_channel, 256, 192, 128, 64, 126)
        self.gru = SepConvGRU(cfg.hidden_dim, 128 + cfg.context_dim)
        self.flow_head = TwoConv(cfg.hidden_dim, 256, 2, 3)
        self.mask = TwoConv(cfg.hidden_dim, 256, 64 * 9, 1)


class RAFT1(nn.Module):
    """Classic RAFT, cnet BatchNorms folded; frozen."""
    kind = "raft1"

    def __init__(self, cfg: RAFT1Config = RAFT1Config()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, batch_norm=False)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, batch_norm=True)
        self.update_block = UpdateBlock1(cfg)
        self.requires_grad_(False)


def build_corr_pyramid_raft1(fmap1, fmap2, num_levels: int):
    """Level-0 all-pairs volume (B, h*w, h, w), then 2x2 average pools over
    the target dims (VALID: a level may come out empty, as in JAX)."""
    B, h, w, C = fmap1.shape
    c = torch.bmm(fmap1.reshape(B, h * w, C),
                  fmap2.reshape(B, h * w, C).transpose(1, 2)) / math.sqrt(C)
    pyramid = [c.reshape(B, h * w, h, w)]
    for _ in range(num_levels - 1):
        _, N, hh, ww = pyramid[-1].shape
        h2, w2 = hh // 2, ww // 2
        x = pyramid[-1][:, :, :2 * h2, :2 * w2].reshape(B, N, h2, 2, w2, 2)
        pyramid.append(x.sum(dim=(3, 5)) / 4)
    return pyramid


def upsample_flow(flow, mask):
    """Convex 8x upsampling. flow (B, h, w, 2); mask (B, h, w, 576)."""
    B, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(B, h, w, 9, 8, 8), dim=3)
    f = torch.einsum("bhwkuv,bhwkc->bhuwvc", m, unfold9(8 * flow))
    return f.reshape(B, h * 8, w * 8, 2)


@torch.no_grad()
def raft1_forward(raft: RAFT1, image1, image2, iters: int | None = None):
    """image1/2 (B, H, W, 3) in [0, 255]. Returns the final flow (B, H, W, 2)."""
    exact_fp32()
    cfg = raft.cfg
    iters = cfg.iters if iters is None else iters
    image1, pads = pad_to_8(2 * (image1.float() / 255.0) - 1.0)
    image2, _ = pad_to_8(2 * (image2.float() / 255.0) - 1.0)
    B, H, W, _ = image1.shape

    f1, f2 = torch.split(raft.fnet(torch.cat([image1, image2], 0)), B, dim=0)
    pyramid = build_corr_pyramid_raft1(f1, f2, cfg.corr_levels)
    net, inp = torch.split(raft.cnet(image1), [cfg.hidden_dim, cfg.context_dim], dim=-1)
    net, inp = torch.tanh(net), F.relu(inp)

    h, w = H // 8, W // 8
    grid = coords_grid(B, h, w, device=image1.device)
    lk_cfg = RAFTConfig(radius=cfg.corr_radius, corr_levels=cfg.corr_levels)
    ub = raft.update_block
    flow = torch.zeros((B, h, w, 2), device=image1.device)
    for _ in range(iters):
        corr = lookup_corr(pyramid, grid + flow, lk_cfg)
        x = torch.cat([inp, ub.encoder(flow, corr)], -1)
        net = ub.gru(net, x)
        flow = flow + ub.flow_head(net)
    flow_up = upsample_flow(flow, 0.25 * ub.mask(net))
    t, b, l, r = pads
    return flow_up[:, t:H - b, l:W - r]


# ---------------------------------------------------------------- weights

def raft1_from_jax(params, cfg: RAFT1Config = RAFT1Config()) -> RAFT1:
    """A RAFT1 module from a JAX parameter tree of numpy arrays."""
    model = RAFT1(cfg)
    load_jax_tree(model, params)
    return model


def _raft1_tree(sd: Dict[str, np.ndarray]) -> Dict:
    """The JAX converter's tree (align3r_tpu/models/raft1.py:207-247)."""
    sd = _strip_module(sd)

    def enc(pfx, batch):
        p = {"conv1": _conv(sd, f"{pfx}.conv1"), "conv2": _conv(sd, f"{pfx}.conv2")}
        if batch:
            p["norm1"] = _bn_fold(sd, f"{pfx}.norm1")
        for li in (1, 2, 3):
            blocks = []
            for bi in range(2):
                q = f"{pfx}.layer{li}.{bi}"
                b = {"conv1": _conv(sd, f"{q}.conv1"), "conv2": _conv(sd, f"{q}.conv2")}
                if batch:
                    b["norm1"], b["norm2"] = _bn_fold(sd, f"{q}.norm1"), _bn_fold(sd, f"{q}.norm2")
                if f"{q}.downsample.0.weight" in sd:
                    b["down_conv"] = _conv(sd, f"{q}.downsample.0")
                    if batch:
                        b["norm3"] = _bn_fold(sd, f"{q}.norm3")
                blocks.append(b)
            p[f"layer{li}"] = blocks
        return p

    ub = "update_block"
    return {
        "fnet": enc("fnet", False), "cnet": enc("cnet", True),
        "update_block": {
            "encoder": {k: _conv(sd, f"{ub}.encoder.{k}")
                        for k in ("convc1", "convc2", "convf1", "convf2", "conv")},
            "gru": {k: _conv(sd, f"{ub}.gru.{k}")
                    for k in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")},
            "flow_head": {"conv1": _conv(sd, f"{ub}.flow_head.conv1"),
                          "conv2": _conv(sd, f"{ub}.flow_head.conv2")},
            "mask": {"conv1": _conv(sd, f"{ub}.mask.0"), "conv2": _conv(sd, f"{ub}.mask.2")},
        },
    }


def convert_raft1_state_dict(sd: Dict[str, np.ndarray],
                             cfg: RAFT1Config = RAFT1Config()) -> RAFT1:
    """A reference-format RAFT1 state dict -> RAFT1, cnet BatchNorms folded,
    on the CPU."""
    return raft1_from_jax(_raft1_tree(sd), cfg)


def load_raft_auto(path: str, device="cuda"):
    """'M' in the file name -> SEA-RAFT, else classic RAFT1 (the reference's
    rule). Returns (module on `device`, "raft2" | "raft1"); `device` is the
    card unless "cpu" is asked for."""
    if "M" in os.path.basename(path):
        return load_raft_checkpoint(path, device=device), "raft2"
    dev = device_or_raise(device)
    return convert_raft1_state_dict(read_state_dict(path)).to(dev), "raft1"
