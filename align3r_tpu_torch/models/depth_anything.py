"""Depth Anything V2 (DINOv2 ViT + DPT decoder), the 'depthanything'
monocular prior (port of align3r_tpu/models/depth_anything.py).

The submodules are named after the Hugging Face state-dict keys
(DepthAnythingForDepthEstimation: `backbone.encoder.layer.3.attention.
attention.query.weight`, `neck.fusion_stage.layers.0.residual_layer1.
convolution1.bias`, `head.conv3.weight`, ...), so a checkpoint read by
`utils.hf_weights` loads with `load_state_dict(strict=True)`. The DINOv2
trunk, `Dinov2Model`, is shared with Depth Pro and PromptDA.

Numerics follow the JAX package, not transformers, where the two differ:
- the patch position embeddings are resized with jax.image.resize's bicubic
  (Keys a = -0.5, antialiased when it shrinks; `models.nn.resize`), where
  HF's Dinov2 takes torch's bicubic (a = -0.75);
- `preprocess` resizes with jax.image.resize's antialiased bilinear.
Every attention goes through `ops.attention.attention(q, k, v, attn_impl)`,
with the model's `attn_impl` attribute ("auto" unless a caller sets it):
"auto" is `xla_attention` (the plain version) on CPU tensors and a
hand-written kernel on the card (K9's fp32 forward at the priors' token
counts), where the JAX package calls xla_attention directly. The
projections, MLPs and convolutions are fp32 F.linear / cuDNN; callers run
them with TF32 off (`raft.exact_fp32`), the JAX "auto" precision.

Weights: `load_depth_anything` (a local HF folder or cached hub name),
`load_jax_params` (the JAX parameter tree, numpy leaves) and
`init_prior_` (seeded random weights at any width).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.ops.attention import attention
from align3r_tpu_torch.utils import hf_weights


@dataclasses.dataclass(frozen=True)
class DAConfig:
    # backbone (DINOv2)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    out_indices: Tuple[int, ...] = (5, 12, 18, 24)  # hidden_states indices (1-based layers)
    # neck / head (DepthAnything)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256
    head_hidden_size: int = 32
    max_depth: float = 1.0
    depth_estimation_type: str = "relative"
    # the trunk's pretraining size, which sets the position-embedding grid
    # (the JAX config reads it off the parameters' shapes)
    image_size: int = 518


DA_V2_LARGE = DAConfig()

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------- backbone

class _Param(nn.Module):
    """A module holding one parameter under a given name (HF's
    `layer_scale1.lambda1`)."""

    def __init__(self, name: str, *shape):
        super().__init__()
        self.register_parameter(name, nn.Parameter(torch.ones(*shape)))


def _box(**mods) -> nn.Module:
    m = nn.Module()
    for k, v in mods.items():
        setattr(m, k, v)
    return m


class Dinov2Layer(nn.Module):
    def __init__(self, C: int, heads: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(C, eps=eps)
        self.attention = _box(attention=_box(query=nn.Linear(C, C), key=nn.Linear(C, C),
                                             value=nn.Linear(C, C)),
                              output=_box(dense=nn.Linear(C, C)))
        self.layer_scale1 = _Param("lambda1", C)
        self.norm2 = nn.LayerNorm(C, eps=eps)
        hid = int(C * mlp_ratio)
        self.mlp = _box(fc1=nn.Linear(C, hid), fc2=nn.Linear(hid, C))
        self.layer_scale2 = _Param("lambda1", C)

    def forward(self, x, attn_impl: str):
        B, N, C = x.shape
        D = C // self.heads
        a = self.attention.attention
        h = self.norm1(x)

        def heads(lin):
            return lin(h).reshape(B, N, self.heads, D).permute(0, 2, 1, 3)

        att = attention(heads(a.query), heads(a.key), heads(a.value), attn_impl)
        att = self.attention.output.dense(att.permute(0, 2, 1, 3).reshape(B, N, C))
        x = x + att * self.layer_scale1.lambda1
        h = self.mlp.fc2(L.gelu(self.mlp.fc1(self.norm2(x))))
        return x + h * self.layer_scale2.lambda1


class Dinov2Model(nn.Module):
    """The DINOv2 trunk (HF Dinov2Model's keys: embeddings, encoder.layer,
    layernorm). `mask_token` is carried for the checkpoint and unused."""

    def __init__(self, hidden: int, layers: int, heads: int, patch: int, image_size: int,
                 mlp_ratio: float = 4.0, eps: float = 1e-6):
        super().__init__()
        g = image_size // patch
        self.embeddings = _box(
            cls_token=nn.Parameter(torch.zeros(1, 1, hidden)),
            mask_token=nn.Parameter(torch.zeros(1, hidden)),
            position_embeddings=nn.Parameter(torch.zeros(1, g * g + 1, hidden)),
            patch_embeddings=_box(projection=nn.Conv2d(3, hidden, patch, stride=patch)))
        self.encoder = _box(layer=nn.ModuleList(
            Dinov2Layer(hidden, heads, mlp_ratio, eps) for _ in range(layers)))
        self.layernorm = nn.LayerNorm(hidden, eps=eps)

    def _pos_embed(self, h: int, w: int):
        """Position embeddings for an (h, w) patch grid (JAX _interp_pos_embed)."""
        pos = self.embeddings.position_embeddings
        g0 = int(round((pos.shape[1] - 1) ** 0.5))
        if (h, w) == (g0, g0):
            return pos
        grid = L.resize(pos[:, 1:].reshape(1, g0, g0, -1), h, w, "bicubic")
        return torch.cat([pos[:, :1], grid.reshape(1, h * w, -1)], dim=1)

    def hidden_states(self, pixel_values, collect: Optional[Sequence[int]] = None,
                      attn_impl: str = "auto"):
        """pixel_values (B, 3, H, W) normalised. Returns ({index: (B, 1+N, C)},
        (ph, pw)): index 0 the embeddings, index l the output of layer l, none
        with the final layernorm (HF's hidden_states). `collect` limits the
        indices kept (None: all)."""
        B = pixel_values.shape[0]
        x = self.embeddings.patch_embeddings.projection(pixel_values)
        ph, pw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        cls = self.embeddings.cls_token.expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self._pos_embed(ph, pw)
        n = len(self.encoder.layer)
        keep = set(range(n + 1)) if collect is None else set(collect)
        out = {0: x} if 0 in keep else {}
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, attn_impl)
            if i + 1 in keep:
                out[i + 1] = x
        return out, (ph, pw)


# -------------------------------------------------------------------- neck

def conv3x3(cin: int, cout: int, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class PreActResidual(nn.Module):
    """conv2(relu(conv1(relu(x)))) + x."""

    def __init__(self, C: int):
        super().__init__()
        self.convolution1, self.convolution2 = conv3x3(C, C), conv3x3(C, C)

    def forward(self, x):
        return self.convolution2(F.relu(self.convolution1(F.relu(x)))) + x


class PromptLayer(nn.Module):
    """PromptDA's prompt encoder in a fusion layer: three 3x3 convs."""

    def __init__(self, C: int):
        super().__init__()
        self.convolution1 = conv3x3(1, C)
        self.convolution2, self.convolution3 = conv3x3(C, C), conv3x3(C, C)

    def forward(self, prompt):
        h = F.relu(self.convolution1(prompt))
        return self.convolution3(F.relu(self.convolution2(h)))


class FusionLayer(nn.Module):
    def __init__(self, C: int, prompt: bool = False):
        super().__init__()
        self.projection = nn.Conv2d(C, C, 1)
        self.residual_layer1, self.residual_layer2 = PreActResidual(C), PreActResidual(C)
        if prompt:
            self.prompt_depth_layer = PromptLayer(C)

    def forward(self, x, residual=None, size=None, prompt=None):
        if residual is not None:
            if residual.shape[2:] != x.shape[2:]:
                residual = F.interpolate(residual, size=x.shape[2:], mode="bilinear",
                                         align_corners=False)
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if prompt is not None:
            pr = F.interpolate(prompt, size=x.shape[2:], mode="bilinear", align_corners=False)
            x = x + self.prompt_depth_layer(pr)
        size = (x.shape[2] * 2, x.shape[3] * 2) if size is None else size
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.projection(x)


def _reassemble_layer(C: int, ch: int, f: float) -> nn.Module:
    layer = _box(projection=nn.Conv2d(C, ch, 1))
    if f > 1:
        layer.resize = nn.ConvTranspose2d(ch, ch, int(f), stride=int(f))
    elif f < 1:
        layer.resize = conv3x3(ch, ch, stride=int(1 / f))
    return layer


class DepthAnything(nn.Module):
    """DepthAnythingForDepthEstimation (prompt=True: PromptDepthAnything's
    fusion layers, each with a prompt encoder)."""

    def __init__(self, cfg: DAConfig = DA_V2_LARGE, prompt: bool = False):
        super().__init__()
        self.cfg, self.attn_impl = cfg, "auto"
        self.backbone = Dinov2Model(cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                                    cfg.patch_size, cfg.image_size, cfg.mlp_ratio,
                                    cfg.layer_norm_eps)
        fh = cfg.fusion_hidden_size
        self.neck = _box(
            reassemble_stage=_box(layers=nn.ModuleList(
                _reassemble_layer(cfg.hidden_size, ch, f)
                for ch, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors))),
            convs=nn.ModuleList(conv3x3(ch, fh, bias=False) for ch in cfg.neck_hidden_sizes),
            fusion_stage=_box(layers=nn.ModuleList(
                FusionLayer(fh, prompt) for _ in cfg.neck_hidden_sizes)))
        self.head = _box(conv1=conv3x3(fh, fh // 2),
                         conv2=conv3x3(fh // 2, cfg.head_hidden_size),
                         conv3=nn.Conv2d(cfg.head_hidden_size, 1, 1))

    def features(self, x):
        """NCHW normalised input -> the neck's per-level features and the
        patch grid (ph, pw)."""
        cfg = self.cfg
        hs, (ph, pw) = self.backbone.hidden_states(x, cfg.out_indices, self.attn_impl)
        feats = []
        for i, idx in enumerate(cfg.out_indices):
            t = self.backbone.layernorm(hs[idx])[:, 1:]
            t = t.transpose(1, 2).reshape(t.shape[0], -1, ph, pw)
            rl = self.neck.reassemble_stage.layers[i]
            t = rl.projection(t)
            if hasattr(rl, "resize"):
                t = rl.resize(t)
            feats.append(self.neck.convs[i](t))
        return feats, (ph, pw)

    def decode(self, feats, ph: int, pw: int, prompt=None):
        """Fusion (coarse to fine) and the head: (B, H, W) depth."""
        cfg = self.cfg
        rev = feats[::-1]
        fused = None
        for idx, (f, layer) in enumerate(zip(rev, self.neck.fusion_stage.layers)):
            size = rev[idx + 1].shape[2:] if idx != len(rev) - 1 else None
            fused = (layer(f, None, size, prompt) if fused is None
                     else layer(fused, f, size, prompt))
        h = self.head
        x = F.interpolate(h.conv1(fused), size=(ph * cfg.patch_size, pw * cfg.patch_size),
                          mode="bilinear", align_corners=True)
        x = h.conv3(F.relu(h.conv2(x)))
        x = F.relu(x) if cfg.depth_estimation_type == "relative" else torch.sigmoid(x)
        return (x * cfg.max_depth)[:, 0]

    def output_convs(self):
        """(conv, bias) of each output conv, for `init_prior_`."""
        return [(self.head.conv3, 1.0)]

    def forward(self, pixel_values):
        """pixel_values (B, H, W, 3) normalised (`preprocess`). Returns the
        predicted relative depth (B, H', W'), H' = (H // 14) 14."""
        feats, (ph, pw) = self.features(pixel_values.permute(0, 3, 1, 2))
        return self.decode(feats, ph, pw)


def preprocess(images_01, cfg: DAConfig = DA_V2_LARGE, target: int = 518):
    """[0, 1] RGB (B, H, W, 3) -> short side near `target`, both sides
    multiples of the patch, imagenet-normalised (jax.image.resize bilinear,
    antialiased when it shrinks)."""
    x = torch.as_tensor(images_01, dtype=torch.float32)
    B, H, W, _ = x.shape
    s = target / min(H, W)
    nh = int(round(H * s / cfg.patch_size)) * cfg.patch_size
    nw = int(round(W * s / cfg.patch_size)) * cfg.patch_size
    x = L.resize(x, nh, nw, "bilinear")
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


# ------------------------------------------------------------------ config

def _out_indices(bc: dict) -> Tuple[int, ...]:
    if bc.get("out_features"):
        return tuple(int(s.replace("stage", "")) for s in bc["out_features"])
    if bc.get("out_indices"):
        return tuple(int(i) for i in bc["out_indices"])
    return (bc.get("num_hidden_layers", 12),)


def config_from_hf(config: dict) -> DAConfig:
    """DAConfig from a DepthAnything / PromptDepthAnything config.json dict
    (the JAX config_from_hf reads the same fields off the HF object; a key
    missing from the file takes transformers' default)."""
    bc = config.get("backbone_config") or {}
    return DAConfig(
        hidden_size=bc.get("hidden_size", 384), num_layers=bc.get("num_hidden_layers", 12),
        num_heads=bc.get("num_attention_heads", 6), mlp_ratio=bc.get("mlp_ratio", 4.0),
        patch_size=config.get("patch_size", 14), out_indices=_out_indices(bc),
        reassemble_factors=tuple(config.get("reassemble_factors", (4, 2, 1, 0.5))),
        neck_hidden_sizes=tuple(config.get("neck_hidden_sizes", (48, 96, 192, 384))),
        fusion_hidden_size=config.get("fusion_hidden_size", 64),
        head_hidden_size=config.get("head_hidden_size", 32),
        max_depth=config.get("max_depth") or 1.0,
        depth_estimation_type=config.get("depth_estimation_type", "relative"),
        image_size=bc.get("image_size", 518))


def hf_config(cfg: DAConfig, model_type: str = "depth_anything") -> dict:
    """The config.json fields config_from_hf reads, for `cfg` (what
    `hf_weights.save_pretrained` writes beside seeded weights)."""
    stages = [f"stage{i}" for i in range(1, cfg.num_layers + 1)]
    return {
        "model_type": model_type,
        "backbone_config": {
            "model_type": "dinov2", "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "mlp_ratio": cfg.mlp_ratio, "patch_size": cfg.patch_size,
            "image_size": cfg.image_size, "layer_norm_eps": cfg.layer_norm_eps,
            "out_features": [stages[i - 1] for i in cfg.out_indices],
            "out_indices": list(cfg.out_indices), "stage_names": ["stem"] + stages,
            "reshape_hidden_states": False, "apply_layernorm": True},
        "patch_size": cfg.patch_size,
        "reassemble_factors": list(cfg.reassemble_factors),
        "neck_hidden_sizes": list(cfg.neck_hidden_sizes),
        "reassemble_hidden_size": cfg.hidden_size,
        "fusion_hidden_size": cfg.fusion_hidden_size,
        "head_hidden_size": cfg.head_hidden_size,
        "max_depth": cfg.max_depth,
        "depth_estimation_type": cfg.depth_estimation_type}


# ----------------------------------------------------------------- weights

def materialize(make, state_dict: Dict[str, torch.Tensor], device) -> nn.Module:
    """make() built without memory, filled strictly from `state_dict` (cast
    to fp32), on `device`."""
    with torch.device("meta"):
        model = make()
    sd = {k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval()


def load_depth_anything(name_or_path: str, device="cuda"):
    """(model, cfg) from a local HF folder or cached hub name, on `device`
    (the card unless "cpu" is asked for)."""
    dev = device_or_raise(device)
    config, sd = hf_weights.load(name_or_path)
    cfg = config_from_hf(config)
    return materialize(lambda: DepthAnything(cfg), sd, dev), cfg


@torch.no_grad()
def init_prior_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights for a prior model at any width, drawn on the
    parameters' device: linear and conv weights N(0, 1 / fan_in), biases 0,
    layernorms identity, tokens and position embeddings N(0, 0.02), layer
    scales 0.1 (a stable residual stream through 24 layers), then
    each of `model.output_convs()` scaled by 0.1 with its bias set, so that
    the outputs lie in the range a real checkpoint's do (positive depth, a
    plausible field of view)."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lambda1":
            p.fill_(0.1)
        elif leaf in ("cls_token", "mask_token", "position_embeddings"):
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 1:          # layernorm scale
            p.fill_(1.0)
        else:
            fan_in = p[0].numel() if p.dim() != 4 or not _is_transposed(model, name) \
                else p.shape[0]
            p.copy_(torch.randn(p.shape, generator=g, device=dev) / math.sqrt(fan_in))
    for conv, b in model.output_convs():
        conv.weight.mul_(0.1)
        conv.bias.fill_(b)
    return model


def _is_transposed(model, name) -> bool:
    return isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.ConvTranspose2d)


def _c2d(p, name):
    out = {f"{name}.weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


def _ct2d(p, name):
    out = {f"{name}.weight": np.asarray(p["kernel"]).transpose(0, 3, 1, 2)}
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


def _lin(p, name):
    return {f"{name}.weight": np.asarray(p["kernel"]).T, f"{name}.bias": np.asarray(p["bias"])}


def _ln(p, name):
    return {f"{name}.weight": np.asarray(p["scale"]), f"{name}.bias": np.asarray(p["bias"])}


def vit_state_dict(p, pfx: str) -> Dict[str, np.ndarray]:
    """The JAX DINOv2 tree (layers stacked on a leading axis) under HF keys."""
    sd = {f"{pfx}.embeddings.cls_token": np.asarray(p["cls_token"])[None],
          f"{pfx}.embeddings.position_embeddings": np.asarray(p["pos_embed"]),
          **_c2d(p["patch_embed"], f"{pfx}.embeddings.patch_embeddings.projection"),
          **_ln(p["final_norm"], f"{pfx}.layernorm")}
    lay = p["layers"]
    for i in range(np.asarray(lay["ls1"]).shape[0]):
        q = f"{pfx}.encoder.layer.{i}"
        li = {k: ({kk: np.asarray(vv)[i] for kk, vv in v.items()} if isinstance(v, dict)
                  else np.asarray(v)[i]) for k, v in lay.items()}
        sd.update({**_ln(li["norm1"], f"{q}.norm1"), **_ln(li["norm2"], f"{q}.norm2"),
                   **_lin(li["q"], f"{q}.attention.attention.query"),
                   **_lin(li["k"], f"{q}.attention.attention.key"),
                   **_lin(li["v"], f"{q}.attention.attention.value"),
                   **_lin(li["attn_out"], f"{q}.attention.output.dense"),
                   **_lin(li["fc1"], f"{q}.mlp.fc1"), **_lin(li["fc2"], f"{q}.mlp.fc2"),
                   f"{q}.layer_scale1.lambda1": li["ls1"],
                   f"{q}.layer_scale2.lambda1": li["ls2"]})
    return sd


def da_state_dict(params, cfg: DAConfig) -> Dict[str, np.ndarray]:
    """The JAX Depth Anything tree (convert_hf_depth_anything's, with
    PromptDA's `prompt` convs where present) under HF keys."""
    sd = vit_state_dict(params["backbone"], "backbone")
    neck = params["neck"]
    for i, f in enumerate(cfg.reassemble_factors):
        rl, pfx = neck["reassemble"][i], f"neck.reassemble_stage.layers.{i}"
        sd.update(_c2d(rl["projection"], f"{pfx}.projection"))
        if f > 1:
            sd.update(_ct2d(rl["resize"], f"{pfx}.resize"))
        elif f < 1:
            sd.update(_c2d(rl["resize"], f"{pfx}.resize"))
        sd.update(_c2d(neck["convs"][i], f"neck.convs.{i}"))
    for i, fl in enumerate(neck["fusion"]):
        pfx = f"neck.fusion_stage.layers.{i}"
        sd.update(_c2d(fl["projection"], f"{pfx}.projection"))
        for r in (1, 2):
            for c in (1, 2):
                sd.update(_c2d(fl[f"res{r}"][f"conv{c}"],
                               f"{pfx}.residual_layer{r}.convolution{c}"))
        if "prompt" in fl:
            for c in (1, 2, 3):
                sd.update(_c2d(fl["prompt"][f"conv{c}"],
                               f"{pfx}.prompt_depth_layer.convolution{c}"))
    for c in (1, 2, 3):
        sd.update(_c2d(params["head"][f"conv{c}"], f"head.conv{c}"))
    return sd


def load_numpy_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    """Load a numpy state dict strictly; the checkpoint entries the JAX tree
    does not carry (DINOv2's unused mask tokens) keep the module's values."""
    own = model.state_dict()
    full = {k: v for k, v in own.items() if k.endswith("mask_token")}
    full.update({k: torch.from_numpy(np.array(v, np.float32)).to(own[k].device)
                 for k, v in sd.items()})
    model.load_state_dict(full, strict=True)
    return model


def load_jax_params(model: DepthAnything, params) -> DepthAnything:
    """Copy a JAX Depth Anything / PromptDA parameter tree (numpy leaves)
    into `model`; raises on a missing or extra leaf or a shape that differs."""
    return load_numpy_state_dict(model, da_state_dict(params, model.cfg))
