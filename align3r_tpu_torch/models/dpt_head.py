"""DPT regression head (port of align3r_tpu/models/dpt_head.py, the XLA conv
path only).

``DPTOutputAdapter`` carries the reference parameter names
(``act_postprocess``, ``scratch.layer{k}_rn`` with its ``scratch.layer_rn``
alias, ``scratch.refinenet{k}.resConfUnit{1,2}``, ``head.{0,2,4}``).
``apply_dpt_head`` runs on a dict of those weights: detached ones from
``prepare_dpt_head`` for inference, or the module's own from
``dpt_head_params`` for training (differentiable). The conv pyramid runs in
``dtype`` (bf16 by default in the engine, fp32 in training), the final
regression conv and the postprocess pinned to fp32 (engine.py:288-293,
dpt_head.py:147).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.postprocess import postprocess

LAYER_DIMS = (96, 192, 384, 768)
FEATURE_DIM = 256


class ResidualConvUnit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)


class FeatureFusionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1)


class Scratch(nn.Module):
    def __init__(self, layer_dims, f: int):
        super().__init__()
        for k, d in enumerate(layer_dims, 1):
            setattr(self, f"layer{k}_rn", nn.Conv2d(d, f, 3, padding=1, bias=False))
        # the reference registers the same convs a second time through a
        # ModuleList (croco/models/dpt_block.py:70-73); its state_dict has both
        self.layer_rn = nn.ModuleList(
            [getattr(self, f"layer{k}_rn") for k in range(1, len(layer_dims) + 1)])
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(f))


class DPTOutputAdapter(nn.Module):
    def __init__(self, dim_tokens, num_channels: int,
                 layer_dims=LAYER_DIMS, feature_dim: int = FEATURE_DIM,
                 last_dim: int = FEATURE_DIM // 2):
        super().__init__()
        ld = list(layer_dims)
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dim_tokens[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(dim_tokens[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(dim_tokens[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(dim_tokens[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = Scratch(ld, feature_dim)
        self.head = nn.Sequential(
            nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1),
            nn.Identity(),                 # 2x align_corners upsample
            nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(last_dim, num_channels, 1))


class DPTHead(nn.Module):
    """``downstream_head{k}``: the reference wraps the adapter as ``.dpt``."""

    def __init__(self, dim_tokens, num_channels: int):
        super().__init__()
        self.dpt = DPTOutputAdapter(dim_tokens, num_channels)


def dpt_head_params(head: DPTHead, dtype):
    """Weights of one head in the JAX package's naming, (weight, bias) per
    conv, cast to `dtype` from the module's own parameters (so gradients
    reach them); head_conv3 stays fp32 (the pinned final conv)."""
    d = head.dpt

    def wb(m, dt=dtype):
        return m.weight.to(dt), None if m.bias is None else m.bias.to(dt)

    ap, sc = d.act_postprocess, d.scratch
    p = {"act1_conv": wb(ap[0][0]), "act1_up": wb(ap[0][1]),
         "act2_conv": wb(ap[1][0]), "act2_up": wb(ap[1][1]),
         "act3_conv": wb(ap[2][0]), "act4_conv": wb(ap[3][0]),
         "act4_down": wb(ap[3][1]),
         "head_conv1": wb(d.head[0]), "head_conv2": wb(d.head[2]),
         "head_conv3": wb(d.head[4], torch.float32)}
    for k in range(1, 5):
        p[f"layer{k}_rn"] = wb(getattr(sc, f"layer{k}_rn"))
        rn = getattr(sc, f"refinenet{k}")
        p[f"refinenet{k}"] = {
            "res1": (wb(rn.resConfUnit1.conv1), wb(rn.resConfUnit1.conv2)),
            "res2": (wb(rn.resConfUnit2.conv1), wb(rn.resConfUnit2.conv2)),
            "out_conv": wb(rn.out_conv)}
    return p


def prepare_dpt_head(head: DPTHead, dtype):
    """dpt_head_params, detached: the inference weights."""
    def detach(t):
        if isinstance(t, dict):
            return {k: detach(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(detach(v) for v in t)
        return None if t is None else t.detach()
    return detach(dpt_head_params(head, dtype))


def _residual_conv_unit(p, x):
    (w1, b1), (w2, b2) = p
    out = L.conv2d(torch.relu(x), w1, b1, padding=1)
    out = L.conv2d(torch.relu(out), w2, b2, padding=1)
    return out + x


def _fusion(p, x, skip=None):
    if skip is not None:
        x = x + _residual_conv_unit(p["res1"], skip)
    x = _residual_conv_unit(p["res2"], x)
    B, H, W, C = x.shape
    x = L.bilinear_resize(x, H * 2, W * 2, align_corners=True)
    return L.conv2d(x, *p["out_conv"])


def apply_dpt_head(p, hook_tokens: List[torch.Tensor], grid_hw, img_hw,
                   depth_mode=None, conf_mode=None, dtype=torch.float32):
    """hook_tokens: 4 tensors (B, N, C_hook); grid_hw (nh, nw); img_hw (H, W).
    Returns {'pts3d' (B, H, W, 3), 'conf' (B, H, W)} in fp32."""
    nh, nw = grid_hw
    H, W = img_hw
    maps = [t.to(dtype).reshape(t.shape[0], nh, nw, t.shape[-1])
            for t in hook_tokens]
    l1 = L.conv_transpose2d(L.conv2d(maps[0], *p["act1_conv"]), *p["act1_up"])
    l2 = L.conv_transpose2d(L.conv2d(maps[1], *p["act2_conv"]), *p["act2_up"])
    l3 = L.conv2d(maps[2], *p["act3_conv"])
    l4 = L.conv2d(L.conv2d(maps[3], *p["act4_conv"]), *p["act4_down"],
                  stride=2, padding=1)
    l1 = L.conv2d(l1, *p["layer1_rn"], padding=1)
    l2 = L.conv2d(l2, *p["layer2_rn"], padding=1)
    l3 = L.conv2d(l3, *p["layer3_rn"], padding=1)
    l4 = L.conv2d(l4, *p["layer4_rn"], padding=1)

    path4 = _fusion(p["refinenet4"], l4)[:, :l3.shape[1], :l3.shape[2], :]
    path3 = _fusion(p["refinenet3"], path4, l3)
    path2 = _fusion(p["refinenet2"], path3, l2)
    path1 = _fusion(p["refinenet1"], path2, l1)

    x = L.conv2d(path1, *p["head_conv1"], padding=1)
    x = L.bilinear_resize(x, x.shape[1] * 2, x.shape[2] * 2, align_corners=True)
    x = torch.relu(L.conv2d(x, *p["head_conv2"], padding=1))
    out = L.conv2d(x.float(), *p["head_conv3"])
    out = out[:, :H, :W, :]
    if depth_mode is None:
        return out
    return postprocess(out, depth_mode, conf_mode)
