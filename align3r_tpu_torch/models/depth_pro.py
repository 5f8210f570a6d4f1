"""Apple Depth Pro, the metric 'depthpro' prior with its focal estimate
(port of align3r_tpu/models/depth_pro.py).

A multi-scale DINOv2 patch encoder over overlapping 384-pixel crops of the
image at ratios (0.25, 0.5, 1), a global DINOv2 image encoder, an
upsampling neck, DPT-style fusion, a depth head, and a field-of-view branch
(focal_px = 0.5 W / tan(0.5 fov)). Submodules are named after the Hugging
Face DepthProForDepthEstimation state-dict keys, so a checkpoint read by
`utils.hf_weights` loads with `load_state_dict(strict=True)`.

The patch encoder runs once on the crops of all three scales together
(35 crops a frame at the published geometry), as transformers does; the
JAX package runs it once a scale. Each crop is encoded on its own, so the
two agree but for the order of floating-point sums.

Geometry: `DepthProConfig()` keeps the JAX default (ViT patch 14 at 384,
so a 27x27 grid and exp = int(log2(1536 / 27)) = 5). The published model
is ml-depth-pro's dinov2l16_384 preset (patch 16 at 384: a 24x24 grid, 577
tokens, exp = 6); `PUBLISHED_HF_CONFIG` holds the config.json fields
`config_from_hf_depth_pro` reads for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models.depth_anything import (
    Dinov2Model, PreActResidual, _box, _c2d, _ct2d, _lin, conv3x3,
    load_numpy_state_dict, materialize, vit_state_dict)
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.utils import hf_weights


@dataclasses.dataclass(frozen=True)
class ViTCfg:
    hidden_size: int
    num_layers: int
    num_heads: int
    patch_size: int
    image_size: int
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    patch_model: ViTCfg = ViTCfg(1024, 24, 16, 14, 384)
    image_model: ViTCfg = ViTCfg(1024, 24, 16, 14, 384)
    fov_model: ViTCfg = ViTCfg(1024, 24, 16, 14, 384)
    patch_size: int = 384                      # crop size fed to the patch ViT
    scaled_images_ratios: Tuple[float, ...] = (0.25, 0.5, 1.0)
    scaled_images_overlap_ratios: Tuple[float, ...] = (0.0, 0.5, 0.25)
    scaled_images_feature_dims: Tuple[int, ...] = (1024, 1024, 512)
    intermediate_hook_ids: Tuple[int, ...] = (11, 5)
    intermediate_feature_dims: Tuple[int, ...] = (256, 256)
    fusion_hidden_size: int = 256
    merge_padding_value: int = 3
    num_fov_head_layers: int = 2
    use_fov_model: bool = True
    image_size: int = 1536                     # full input resolution


_VIT_L16 = {"model_type": "dinov2", "hidden_size": 1024, "num_hidden_layers": 24,
            "num_attention_heads": 16, "patch_size": 16, "image_size": 384}
# the published geometry (ml-depth-pro's dinov2l16_384 preset): ViT-L,
# patch 16 at 384, at the HF DepthProConfig defaults otherwise
PUBLISHED_HF_CONFIG = {
    "model_type": "depth_pro", "patch_model_config": dict(_VIT_L16),
    "image_model_config": dict(_VIT_L16), "fov_model_config": dict(_VIT_L16),
    "patch_size": 384, "image_size": 1536,
    "scaled_images_ratios": [0.25, 0.5, 1.0],
    "scaled_images_overlap_ratios": [0.0, 0.5, 0.25],
    "scaled_images_feature_dims": [1024, 1024, 512],
    "intermediate_hook_ids": [11, 5], "intermediate_feature_dims": [256, 256],
    "fusion_hidden_size": 256, "merge_padding_value": 3, "num_fov_head_layers": 2,
    "use_fov_model": True}


def _vit(v: ViTCfg) -> Dinov2Model:
    return Dinov2Model(v.hidden_size, v.num_layers, v.num_heads, v.patch_size, v.image_size,
                       eps=v.layer_norm_eps)


def split_to_patches(x, patch: int, overlap: float):
    """(B, C, S, S) -> (nP B, C, patch, patch), window-major then batch."""
    H, W = x.shape[2:]
    if H == W == patch:
        return x
    stride = int(patch * (1 - overlap))
    return torch.cat([x[:, :, i:i + patch, j:j + patch]
                      for i in range(0, H - patch + 1, stride)
                      for j in range(0, W - patch + 1, stride)], dim=0)


def _reshape_features(hs):
    """(nB, L, C) -> (nB, C, s, s), dropping the leading special tokens."""
    nB, n, C = hs.shape
    s = math.isqrt(n)
    return hs[:, -(s * s):].transpose(1, 2).reshape(nB, C, s, s)


def merge_patches(patches, batch_size: int, padding: int):
    """(nP B, C, s, s) window-major -> (B, C, S, S), each crop's overlap cut."""
    nB, _, s, _ = patches.shape
    npb = nB // batch_size
    side = math.isqrt(npb)
    if nB == batch_size:
        return patches
    if npb < 4:
        padding = 0
    padding = min(s // 4, padding)
    rows, i = [], 0
    for h in range(side):
        cols = []
        for w in range(side):
            box = patches[batch_size * i: batch_size * (i + 1)]
            top = padding if h != 0 else 0
            bottom = padding if h != side - 1 else 0
            left = padding if w != 0 else 0
            right = padding if w != side - 1 else 0
            cols.append(box[:, :, top: s - bottom, left: s - right])
            i += 1
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2)


def _resize(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def _reconstruct(hs, batch_size, padding, out_hw):
    return _resize(merge_patches(_reshape_features(hs), batch_size, padding), *out_hw)


def _upsample_block(cin: int, mid: int, cout: int, n_up: int, proj: bool, bias: bool):
    layers = [nn.Conv2d(cin, mid, 1, bias=bias)] if proj else []
    layers += [nn.ConvTranspose2d(mid if i == 0 else cout, cout, 2, stride=2, bias=bias)
               for i in range(n_up)]
    return _box(layers=nn.ModuleList(layers))


def _run(block, x):
    for layer in block.layers:
        x = layer(x)
    return x


class DepthProFusionLayer(nn.Module):
    def __init__(self, C: int, deconv: bool):
        super().__init__()
        self.residual_layer1, self.residual_layer2 = PreActResidual(C), PreActResidual(C)
        if deconv:
            self.deconv = nn.ConvTranspose2d(C, C, 2, stride=2, bias=False)
        self.projection = nn.Conv2d(C, C, 1)

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.projection(x)


def _out_size(cfg: DepthProConfig) -> int:
    return cfg.image_model.image_size // cfg.image_model.patch_size


def _base_hw(cfg: DepthProConfig, H: int, W: int):
    exp = int(math.log2(W / _out_size(cfg)))
    return H // 2 ** exp, W // 2 ** exp


class DepthPro(nn.Module):
    """DepthProForDepthEstimation. forward: (B, S, S, 3) normalised
    ((x - 0.5) / 0.5) -> (predicted inverse depth (B, S, S), fov in degrees
    (B,) or None)."""

    def __init__(self, cfg: DepthProConfig = DepthProConfig()):
        super().__init__()
        self.cfg, self.attn_impl = cfg, "auto"
        pm, im = cfg.patch_model, cfg.image_model
        fh = cfg.fusion_hidden_size
        sd, idims = cfg.scaled_images_feature_dims, cfg.intermediate_feature_dims
        combined = list(sd) + list(idims)
        self.depth_pro = _box(
            encoder=_box(patch_encoder=_box(model=_vit(pm)),
                         image_encoder=_box(model=_vit(im))),
            neck=_box(
                feature_upsample=_box(
                    image_block=_upsample_block(im.hidden_size, im.hidden_size, sd[0], 1,
                                                proj=False, bias=True),
                    scaled_images=nn.ModuleList(
                        _upsample_block(pm.hidden_size, d, d, 1, True, False) for d in sd),
                    intermediate=nn.ModuleList(
                        _upsample_block(pm.hidden_size, fh if i == 0 else d, d, 2 + i, True,
                                        False) for i, d in enumerate(idims))),
                fuse_image_with_low_res=nn.Conv2d(2 * sd[0], sd[0], 1),
                feature_projection=_box(projections=nn.ModuleList(
                    nn.Identity() if i == len(combined) - 1 and c == fh
                    else conv3x3(c, fh, bias=False) for i, c in enumerate(combined)))))
        self.fusion_stage = _box(
            intermediate=nn.ModuleList(DepthProFusionLayer(fh, True)
                                       for _ in range(len(combined) - 1)),
            final=DepthProFusionLayer(fh, False))
        self.head = _box(layers=nn.ModuleList([
            conv3x3(fh, fh // 2), nn.ConvTranspose2d(fh // 2, fh // 2, 2, stride=2),
            conv3x3(fh // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU()]))
        if cfg.use_fov_model:
            fv, n = cfg.fov_model, cfg.num_fov_head_layers
            head = []
            for i in range(n):
                head += [conv3x3(math.ceil(fh / 2 ** (i + 1)), math.ceil(fh / 2 ** (i + 2)),
                                 stride=2), nn.ReLU()]
            k = int((_out_size(cfg) - 1) / 2 ** n + 1)
            head.append(nn.Conv2d(math.ceil(fh / 2 ** (n + 1)), 1, k))
            self.fov_model = _box(
                fov_encoder=_box(model=_vit(fv), neck=nn.Linear(fv.hidden_size, fh // 2)),
                conv=conv3x3(fh, fh // 2, stride=2),
                head=_box(layers=nn.ModuleList(head)))

    # -------------------------------------------------------------- encoder
    def _vit_last(self, vit: Dinov2Model, x, extra=()):
        n = len(vit.encoder.layer)
        hs, _ = vit.hidden_states(x, [n, *extra], self.attn_impl)
        return vit.layernorm(hs[n]), hs

    def encode(self, x):
        """Patch and image encoder features (DepthProEncoder): [image,
        scale 0, 1, 2, intermediate hooks...], each NCHW."""
        cfg = self.cfg
        B, _, H, W = x.shape
        base_h, base_w = _base_hw(cfg, H, W)
        ratios = cfg.scaled_images_ratios
        crops = [split_to_patches(_resize(x, int(H * r), int(W * r)), cfg.patch_size,
                                  cfg.scaled_images_overlap_ratios[i])
                 for i, r in enumerate(ratios)]
        counts = [c.shape[0] for c in crops]
        hooks = [h + 1 for h in cfg.intermediate_hook_ids]
        last, hs = self._vit_last(self.depth_pro.encoder.patch_encoder.model,
                                  torch.cat(crops), hooks)
        scaled, inter, off = [], [], 0
        for i, (r, n) in enumerate(zip(ratios, counts)):
            pad = int(cfg.merge_padding_value * (1 / r))
            size = (base_h * 2 ** i, base_w * 2 ** i)
            scaled.append(_reconstruct(last[off:off + n], B, pad, size))
            if i == len(ratios) - 1:
                inter = [_reconstruct(hs[h][off:off + n], B, pad, size) for h in hooks]
            off += n
        im = cfg.image_model
        last, _ = self._vit_last(self.depth_pro.encoder.image_encoder.model,
                                 _resize(x, im.image_size, im.image_size))
        return [_reconstruct(last, B, 0, (base_h, base_w)), *scaled, *inter]

    def neck(self, feats):
        cfg = self.cfg
        up = self.depth_pro.neck.feature_upsample
        n = len(cfg.scaled_images_ratios)
        feats = list(feats)
        feats[0] = _run(up.image_block, feats[0])
        for i in range(n):
            feats[i + 1] = _run(up.scaled_images[i], feats[i + 1])
        for i in range(len(cfg.intermediate_feature_dims)):
            feats[n + i + 1] = _run(up.intermediate[i], feats[n + i + 1])
        glob = self.depth_pro.neck.fuse_image_with_low_res(torch.cat([feats[1], feats[0]], 1))
        projs = self.depth_pro.neck.feature_projection.projections
        return [p(f) for p, f in zip(projs, [glob, *feats[2:]])]

    def fuse(self, feats):
        fused = None
        for layer, f in zip(self.fusion_stage.intermediate, feats[:-1]):
            fused = layer(f) if fused is None else layer(fused, f)
        return self.fusion_stage.final(fused, feats[-1])

    def fov(self, x, global_features):
        cfg = self.cfg
        B, _, H, W = x.shape
        fv = self.fov_model
        s = cfg.fov_model.image_size
        last, _ = self._vit_last(fv.fov_encoder.model, _resize(x, s, s))
        feats = _reconstruct(fv.fov_encoder.neck(last), B, 0, _base_hw(cfg, H, W))
        h = feats + F.relu(fv.conv(global_features))
        h = _resize(h, _out_size(cfg), _out_size(cfg))
        for layer in fv.head.layers:
            h = layer(h)
        return h.reshape(B)

    def output_convs(self):
        """(conv, bias) of the depth head's last conv (relu'd depth stays
        positive at bias 1) and the FOV head's (60 degrees), for
        `depth_anything.init_prior_`."""
        out = [(self.head.layers[4], 1.0)]
        if self.cfg.use_fov_model:
            out.append((self.fov_model.head.layers[-1], 60.0))
        return out

    def forward(self, pixel_values):
        x = pixel_values.permute(0, 3, 1, 2)
        feats = self.neck(self.encode(x))
        fused = self.fuse(feats)
        hl = self.head.layers
        h = F.relu(hl[2](hl[1](hl[0](fused))))
        depth = F.relu(hl[4](h))[:, 0]
        fov = self.fov(x, feats[0]) if self.cfg.use_fov_model else None
        return depth, fov


def fov_to_focal_px(fov_deg, width):
    return 0.5 * width / torch.tan(0.5 * torch.deg2rad(torch.as_tensor(fov_deg)))


def postprocess_depth(predicted_depth, fov_deg, width):
    """HF post_process_depth_estimation: metric depth W / (2 tan(fov / 2)
    inverse depth), and the focal in pixels beside it."""
    inv = torch.clamp(predicted_depth, 1e-4, 1e4)
    if fov_deg is None:
        return 1.0 / inv, None
    t = torch.tan(0.5 * torch.deg2rad(fov_deg))[:, None, None]
    return width / (2.0 * t * inv), fov_to_focal_px(fov_deg, width)


# ------------------------------------------------------------------ config

def _vit_cfg(c: dict) -> ViTCfg:
    return ViTCfg(c.get("hidden_size", 768), c.get("num_hidden_layers", 12),
                  c.get("num_attention_heads", 12), c.get("patch_size", 14),
                  c.get("image_size", 384))


def config_from_hf_depth_pro(config: dict) -> DepthProConfig:
    """DepthProConfig from a DepthPro config.json dict."""
    d = DepthProConfig()
    g = lambda k, default: tuple(config[k]) if k in config else default  # noqa: E731
    return DepthProConfig(
        patch_model=_vit_cfg(config.get("patch_model_config") or {}),
        image_model=_vit_cfg(config.get("image_model_config") or {}),
        fov_model=_vit_cfg(config.get("fov_model_config") or {}),
        patch_size=config.get("patch_size", 384),
        scaled_images_ratios=g("scaled_images_ratios", d.scaled_images_ratios),
        scaled_images_overlap_ratios=g("scaled_images_overlap_ratios",
                                       d.scaled_images_overlap_ratios),
        scaled_images_feature_dims=g("scaled_images_feature_dims",
                                     d.scaled_images_feature_dims),
        intermediate_hook_ids=g("intermediate_hook_ids", d.intermediate_hook_ids),
        intermediate_feature_dims=g("intermediate_feature_dims", d.intermediate_feature_dims),
        fusion_hidden_size=config.get("fusion_hidden_size", 256),
        merge_padding_value=config.get("merge_padding_value", 3),
        num_fov_head_layers=config.get("num_fov_head_layers", 2),
        use_fov_model=config.get("use_fov_model", False),
        image_size=config.get("image_size") or 1536)


# ----------------------------------------------------------------- weights

def load_depth_pro(name_or_path: str, device="cuda"):
    """(model, cfg) from a local HF folder or cached hub name, on `device`.
    The FOV branch is built where the checkpoint has it."""
    dev = device_or_raise(device)
    config, sd = hf_weights.load(name_or_path)
    cfg = dataclasses.replace(config_from_hf_depth_pro(config),
                              use_fov_model="fov_model.conv.weight" in sd)
    if not cfg.use_fov_model:
        sd = {k: v for k, v in sd.items() if not k.startswith("fov_model.")}
    return materialize(lambda: DepthPro(cfg), sd, dev), cfg


def _ups(p, pfx, n_up, proj):
    sd, li = {}, 0
    if proj:
        sd.update(_c2d(p["proj"], f"{pfx}.layers.0"))
        li = 1
    for i in range(n_up):
        sd.update(_ct2d(p[f"up{i}"], f"{pfx}.layers.{li + i}"))
    return sd


def depth_pro_state_dict(params, cfg: DepthProConfig) -> Dict[str, np.ndarray]:
    """The JAX Depth Pro tree (convert_hf_depth_pro's) under HF keys."""
    enc, neck = params["encoder"], params["neck"]
    sd = {**vit_state_dict(enc["patch_encoder"], "depth_pro.encoder.patch_encoder.model"),
          **vit_state_dict(enc["image_encoder"], "depth_pro.encoder.image_encoder.model")}
    npx = "depth_pro.neck"
    sd.update(_ups(neck["image_block"], f"{npx}.feature_upsample.image_block", 1, False))
    for i, p in enumerate(neck["scaled"]):
        sd.update(_ups(p, f"{npx}.feature_upsample.scaled_images.{i}", 1, True))
    for i, p in enumerate(neck["intermediate"]):
        sd.update(_ups(p, f"{npx}.feature_upsample.intermediate.{i}", 2 + i, True))
    sd.update(_c2d(neck["fuse_image_with_low_res"], f"{npx}.fuse_image_with_low_res"))
    for i, p in enumerate(neck["projection"]):
        if p is not None:
            sd.update(_c2d(p, f"{npx}.feature_projection.projections.{i}"))
    n = len(params["fusion"])
    for i, fl in enumerate(params["fusion"]):
        pfx = f"fusion_stage.intermediate.{i}" if i < n - 1 else "fusion_stage.final"
        for r in (1, 2):
            for c in (1, 2):
                sd.update(_c2d(fl[f"res{r}"][f"conv{c}"],
                               f"{pfx}.residual_layer{r}.convolution{c}"))
        sd.update(_c2d(fl["projection"], f"{pfx}.projection"))
        if "deconv" in fl:
            sd.update(_ct2d(fl["deconv"], f"{pfx}.deconv"))
    h = params["head"]
    sd.update({**_c2d(h["conv1"], "head.layers.0"), **_ct2d(h["up"], "head.layers.1"),
               **_c2d(h["conv2"], "head.layers.2"), **_c2d(h["conv3"], "head.layers.4")})
    if "fov" in params:
        fov = params["fov"]
        sd.update(vit_state_dict(fov["encoder"], "fov_model.fov_encoder.model"))
        sd.update(_lin(fov["neck"], "fov_model.fov_encoder.neck"))
        sd.update(_c2d(fov["conv"], "fov_model.conv"))
        for i, p in enumerate(fov["head"]):
            sd.update(_c2d(p, f"fov_model.head.layers.{2 * i}"))
    return sd


def load_jax_params(model: DepthPro, params) -> DepthPro:
    """Copy a JAX Depth Pro parameter tree (numpy leaves) into `model`."""
    return load_numpy_state_dict(model, depth_pro_state_dict(params, model.cfg))
