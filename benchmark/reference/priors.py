"""Plain float32 references of the two monocular priors: Depth Anything V2
(DINOv2 trunk, DPT neck and head) and Apple Depth Pro (a multi-scale
DINOv2 patch encoder over overlapping 384-pixel crops, an image encoder, an
upsampling neck, fusion, a depth head and a field-of-view branch).

Parameter names follow the Hugging Face checkpoints
(DepthAnythingForDepthEstimation, DepthProForDepthEstimation), so one
state dict made by the benchmark loads into both this module and the
program's. Published widths come from the configuration file. Every product
goes through `common` under a `Precision` (part "prior"); the position
embeddings are resized with jax.image.resize's bicubic, the Depth Pro input
with its bilinear, as the published JAX tooling of this repository does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import common as C

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _box(**mods) -> nn.Module:
    m = nn.Module()
    for k, v in mods.items():
        setattr(m, k, v)
    return m


class _Param(nn.Module):
    def __init__(self, name, *shape):
        super().__init__()
        self.register_parameter(name, nn.Parameter(torch.ones(*shape)))


def conv3x3(cin, cout, bias=True, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


# ------------------------------------------------------------------ DINOv2

class Dinov2Layer(nn.Module):
    def __init__(self, C_: int, heads: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.heads, self.eps = heads, eps
        self.norm1 = nn.LayerNorm(C_, eps=eps)
        self.attention = _box(attention=_box(query=nn.Linear(C_, C_), key=nn.Linear(C_, C_),
                                             value=nn.Linear(C_, C_)),
                              output=_box(dense=nn.Linear(C_, C_)))
        self.layer_scale1 = _Param("lambda1", C_)
        self.norm2 = nn.LayerNorm(C_, eps=eps)
        hid = int(C_ * mlp_ratio)
        self.mlp = _box(fc1=nn.Linear(C_, hid), fc2=nn.Linear(hid, C_))
        self.layer_scale2 = _Param("lambda1", C_)

    def run(self, P, x):
        B, N, Cx = x.shape
        a = self.attention.attention
        h = C.layernorm(x, self.norm1.weight, self.norm1.bias, self.eps)

        def heads(lin):
            return C.linear(P, "prior", h, lin.weight, lin.bias).reshape(
                B, N, self.heads, -1).permute(0, 2, 1, 3)

        att = C.attention(P, "prior", heads(a.query), heads(a.key), heads(a.value))
        o = self.attention.output.dense
        att = C.linear(P, "prior", att.permute(0, 2, 1, 3).reshape(B, N, Cx), o.weight, o.bias)
        x = x + att * self.layer_scale1.lambda1
        h = C.layernorm(x, self.norm2.weight, self.norm2.bias, self.eps)
        h = C.gelu(C.linear(P, "prior", h, self.mlp.fc1.weight, self.mlp.fc1.bias))
        h = C.linear(P, "prior", h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        return x + h * self.layer_scale2.lambda1


class Dinov2(nn.Module):
    def __init__(self, hidden, layers, heads, patch, image_size, mlp_ratio=4.0, eps=1e-6):
        super().__init__()
        g = image_size // patch
        self.eps = eps
        self.embeddings = _box(
            cls_token=nn.Parameter(torch.zeros(1, 1, hidden)),
            mask_token=nn.Parameter(torch.zeros(1, hidden)),
            position_embeddings=nn.Parameter(torch.zeros(1, g * g + 1, hidden)),
            patch_embeddings=_box(projection=nn.Conv2d(3, hidden, patch, stride=patch)))
        self.encoder = _box(layer=nn.ModuleList(
            Dinov2Layer(hidden, heads, mlp_ratio, eps) for _ in range(layers)))
        self.layernorm = nn.LayerNorm(hidden, eps=eps)

    def final_norm(self, x):
        return C.layernorm(x, self.layernorm.weight, self.layernorm.bias, self.eps)

    def hidden_states(self, P, x, keep):
        """x (B, 3, H, W) -> ({layer index: (B, 1 + N, C)}, (ph, pw))."""
        pe = self.embeddings.patch_embeddings.projection
        t = C.conv2d(P, "prior", x, pe.weight, pe.bias, stride=pe.stride[0])
        ph, pw = t.shape[2:]
        t = t.flatten(2).transpose(1, 2)
        pos = self.embeddings.position_embeddings.float()
        g0 = int(round((pos.shape[1] - 1) ** 0.5))
        if (ph, pw) != (g0, g0):
            grid = C.jax_resize(pos[:, 1:].reshape(1, g0, g0, -1), ph, pw, "bicubic")
            pos = torch.cat([pos[:, :1], grid.reshape(1, ph * pw, -1)], dim=1)
        cls = self.embeddings.cls_token.float().expand(t.shape[0], 1, -1)
        t = torch.cat([cls, t], dim=1) + pos
        out = {0: t} if 0 in keep else {}
        for i, layer in enumerate(self.encoder.layer):
            t = layer.run(P, t)
            if i + 1 in keep:
                out[i + 1] = t
        return out, (ph, pw)


class PreActResidual(nn.Module):
    def __init__(self, C_):
        super().__init__()
        self.convolution1, self.convolution2 = conv3x3(C_, C_), conv3x3(C_, C_)

    def run(self, P, x):
        h = conv(P, self.convolution1, F.relu(x))
        return conv(P, self.convolution2, F.relu(h)) + x


def conv(P, m, x):
    """An nn.Conv2d / ConvTranspose2d of the module tree through `common`."""
    if isinstance(m, nn.ConvTranspose2d):
        return C.conv_transpose2d(P, "prior", x, m.weight, m.bias, stride=m.stride[0])
    return C.conv2d(P, "prior", x, m.weight, m.bias, stride=m.stride[0], padding=m.padding[0])


# --------------------------------------------------------- Depth Anything V2

class FusionLayer(nn.Module):
    def __init__(self, C_):
        super().__init__()
        self.projection = nn.Conv2d(C_, C_, 1)
        self.residual_layer1, self.residual_layer2 = PreActResidual(C_), PreActResidual(C_)

    def run(self, P, x, residual=None, size=None):
        if residual is not None:
            if residual.shape[2:] != x.shape[2:]:
                residual = C.interp(residual, *x.shape[2:], align_corners=False)
            x = x + self.residual_layer1.run(P, residual)
        x = self.residual_layer2.run(P, x)
        size = (x.shape[2] * 2, x.shape[3] * 2) if size is None else size
        x = C.interp(x, *size, align_corners=True)
        return conv(P, self.projection, x)


class DepthAnything(nn.Module):
    """cfg: the configuration file's "prior" group."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        b = cfg["backbone_config"]
        self.backbone = Dinov2(b["hidden_size"], b["num_hidden_layers"],
                               b["num_attention_heads"], b["patch_size"], b["image_size"],
                               b["mlp_ratio"], b["layer_norm_eps"])
        fh = cfg["fusion_hidden_size"]
        layers = []
        for ch, f in zip(cfg["neck_hidden_sizes"], cfg["reassemble_factors"]):
            layer = _box(projection=nn.Conv2d(b["hidden_size"], ch, 1))
            if f > 1:
                layer.resize = nn.ConvTranspose2d(ch, ch, int(f), stride=int(f))
            elif f < 1:
                layer.resize = conv3x3(ch, ch, stride=int(1 / f))
            layers.append(layer)
        self.neck = _box(
            reassemble_stage=_box(layers=nn.ModuleList(layers)),
            convs=nn.ModuleList(conv3x3(ch, fh, bias=False) for ch in cfg["neck_hidden_sizes"]),
            fusion_stage=_box(layers=nn.ModuleList(
                FusionLayer(fh) for _ in cfg["neck_hidden_sizes"])))
        self.head = _box(conv1=conv3x3(fh, fh // 2), conv2=conv3x3(fh // 2, cfg["head_hidden_size"]),
                         conv3=nn.Conv2d(cfg["head_hidden_size"], 1, 1))

    def output_convs_names(self):
        """{output conv: its bias} for the seeded weights."""
        return {"head.conv3": 1.0}

    def preprocess(self, images01, target):
        """[0, 1] (B, H, W, 3) -> short side near `target`, multiples of the
        patch, imagenet-normalised (jax.image.resize's antialiased bilinear)."""
        p = self.cfg["patch_size"]
        B, H, W, _ = images01.shape
        s = target / min(H, W)
        nh, nw = int(round(H * s / p)) * p, int(round(W * s / p)) * p
        x = C.jax_resize(images01.float(), nh, nw, "bilinear")
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return (x - mean) / std

    def depth(self, P, images01):
        """Relative depth (B, H', W') of [0, 1] frames (B, H, W, 3)."""
        cfg = self.cfg
        x = self.preprocess(images01, cfg["input_short_side"]).permute(0, 3, 1, 2)
        idx = cfg["backbone_config"]["out_indices"]
        hs, (ph, pw) = self.backbone.hidden_states(P, x, set(idx))
        feats = []
        for i, k in enumerate(idx):
            t = self.backbone.final_norm(hs[k])[:, 1:]
            t = t.transpose(1, 2).reshape(t.shape[0], -1, ph, pw)
            rl = self.neck.reassemble_stage.layers[i]
            t = conv(P, rl.projection, t)
            if hasattr(rl, "resize"):
                t = conv(P, rl.resize, t)
            feats.append(conv(P, self.neck.convs[i], t))
        rev = feats[::-1]
        fused = None
        for i, (f, layer) in enumerate(zip(rev, self.neck.fusion_stage.layers)):
            size = rev[i + 1].shape[2:] if i != len(rev) - 1 else None
            fused = layer.run(P, f, None, size) if fused is None else layer.run(P, fused, f, size)
        p = cfg["patch_size"]
        h = C.interp(conv(P, self.head.conv1, fused), ph * p, pw * p, align_corners=True)
        h = conv(P, self.head.conv3, F.relu(conv(P, self.head.conv2, h)))
        return (F.relu(h) * cfg["max_depth"])[:, 0]


# ---------------------------------------------------------------- Depth Pro

def _split(x, patch, overlap):
    H, W = x.shape[2:]
    if H == W == patch:
        return x
    stride = int(patch * (1 - overlap))
    return torch.cat([x[:, :, i:i + patch, j:j + patch]
                      for i in range(0, H - patch + 1, stride)
                      for j in range(0, W - patch + 1, stride)], dim=0)


def _tokens_to_map(hs):
    nB, n, Cx = hs.shape
    s = math.isqrt(n)
    return hs[:, -(s * s):].transpose(1, 2).reshape(nB, Cx, s, s)


def _merge(patches, batch, padding):
    nB, _, s, _ = patches.shape
    per = nB // batch
    side = math.isqrt(per)
    if nB == batch:
        return patches
    if per < 4:
        padding = 0
    padding = min(s // 4, padding)
    rows, i = [], 0
    for h in range(side):
        cols = []
        for w in range(side):
            box = patches[batch * i: batch * (i + 1)]
            top = padding if h != 0 else 0
            bottom = padding if h != side - 1 else 0
            left = padding if w != 0 else 0
            right = padding if w != side - 1 else 0
            cols.append(box[:, :, top: s - bottom, left: s - right])
            i += 1
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2)


def _reconstruct(hs, batch, padding, size):
    return C.interp(_merge(_tokens_to_map(hs), batch, padding), *size, align_corners=False)


def _ups(cin, mid, cout, n_up, proj, bias):
    layers = [nn.Conv2d(cin, mid, 1, bias=bias)] if proj else []
    layers += [nn.ConvTranspose2d(mid if i == 0 else cout, cout, 2, stride=2, bias=bias)
               for i in range(n_up)]
    return _box(layers=nn.ModuleList(layers))


def _run_layers(P, block, x):
    for layer in block.layers:
        x = F.relu(x) if isinstance(layer, nn.ReLU) else conv(P, layer, x)
    return x


class DepthProFusion(nn.Module):
    def __init__(self, C_, deconv):
        super().__init__()
        self.residual_layer1, self.residual_layer2 = PreActResidual(C_), PreActResidual(C_)
        if deconv:
            self.deconv = nn.ConvTranspose2d(C_, C_, 2, stride=2, bias=False)
        self.projection = nn.Conv2d(C_, C_, 1)

    def run(self, P, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1.run(P, residual)
        x = self.residual_layer2.run(P, x)
        if hasattr(self, "deconv"):
            x = conv(P, self.deconv, x)
        return conv(P, self.projection, x)


def _vit(v):
    return Dinov2(v["hidden_size"], v["num_hidden_layers"], v["num_attention_heads"],
                  v["patch_size"], v["image_size"])


class DepthPro(nn.Module):
    """cfg: the configuration file's "prior" group (the published HF
    DepthProConfig fields)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        pm, im, fv = cfg["patch_model_config"], cfg["image_model_config"], cfg["fov_model_config"]
        fh = cfg["fusion_hidden_size"]
        sd, idims = cfg["scaled_images_feature_dims"], cfg["intermediate_feature_dims"]
        combined = list(sd) + list(idims)
        ph = pm["hidden_size"]
        self.depth_pro = _box(
            encoder=_box(patch_encoder=_box(model=_vit(pm)), image_encoder=_box(model=_vit(im))),
            neck=_box(
                feature_upsample=_box(
                    image_block=_ups(im["hidden_size"], im["hidden_size"], sd[0], 1, False, True),
                    scaled_images=nn.ModuleList(_ups(ph, d, d, 1, True, False) for d in sd),
                    intermediate=nn.ModuleList(_ups(ph, fh if i == 0 else d, d, 2 + i, True, False)
                                               for i, d in enumerate(idims))),
                fuse_image_with_low_res=nn.Conv2d(2 * sd[0], sd[0], 1),
                feature_projection=_box(projections=nn.ModuleList(
                    nn.Identity() if i == len(combined) - 1 and c == fh
                    else conv3x3(c, fh, bias=False) for i, c in enumerate(combined)))))
        self.fusion_stage = _box(
            intermediate=nn.ModuleList(DepthProFusion(fh, True) for _ in range(len(combined) - 1)),
            final=DepthProFusion(fh, False))
        self.head = _box(layers=nn.ModuleList([
            conv3x3(fh, fh // 2), nn.ConvTranspose2d(fh // 2, fh // 2, 2, stride=2),
            conv3x3(fh // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU()]))
        n = cfg["num_fov_head_layers"]
        head = []
        for i in range(n):
            head += [conv3x3(math.ceil(fh / 2 ** (i + 1)), math.ceil(fh / 2 ** (i + 2)), stride=2),
                     nn.ReLU()]
        k = int((self._out() - 1) / 2 ** n + 1)
        head.append(nn.Conv2d(math.ceil(fh / 2 ** (n + 1)), 1, k))
        self.fov_model = _box(
            fov_encoder=_box(model=_vit(fv), neck=nn.Linear(fv["hidden_size"], fh // 2)),
            conv=conv3x3(fh, fh // 2, stride=2), head=_box(layers=nn.ModuleList(head)))

    def output_convs_names(self):
        n = len(self.fov_model.head.layers) - 1
        return {"head.layers.4": 1.0, f"fov_model.head.layers.{n}": 60.0}

    def _out(self):
        im = self.cfg["image_model_config"]
        return im["image_size"] // im["patch_size"]

    def _base(self, H, W):
        e = int(math.log2(W / self._out()))
        return H // 2 ** e, W // 2 ** e

    def _last(self, P, vit, x, extra=()):
        n = len(vit.encoder.layer)
        hs, _ = vit.hidden_states(P, x, {n, *extra})
        return vit.final_norm(hs[n]), hs

    def inverse_depth_fov(self, P, x):
        """x (B, 3, S, S) normalised -> (inverse depth (B, S, S), fov deg (B,))."""
        cfg = self.cfg
        B, _, H, W = x.shape
        bh, bw = self._base(H, W)
        ratios = cfg["scaled_images_ratios"]
        crops = [_split(C.interp(x, int(H * r), int(W * r), align_corners=False),
                        cfg["patch_size"], cfg["scaled_images_overlap_ratios"][i])
                 for i, r in enumerate(ratios)]
        counts = [c.shape[0] for c in crops]
        hooks = [h + 1 for h in cfg["intermediate_hook_ids"]]
        last, hs = self._last(P, self.depth_pro.encoder.patch_encoder.model,
                              torch.cat(crops), hooks)
        scaled, inter, off = [], [], 0
        for i, (r, n) in enumerate(zip(ratios, counts)):
            pad = int(cfg["merge_padding_value"] * (1 / r))
            size = (bh * 2 ** i, bw * 2 ** i)
            scaled.append(_reconstruct(last[off:off + n], B, pad, size))
            if i == len(ratios) - 1:
                inter = [_reconstruct(hs[h][off:off + n], B, pad, size) for h in hooks]
            off += n
        s = cfg["image_model_config"]["image_size"]
        last, _ = self._last(P, self.depth_pro.encoder.image_encoder.model,
                             C.interp(x, s, s, align_corners=False))
        feats = [_reconstruct(last, B, 0, (bh, bw)), *scaled, *inter]
        up = self.depth_pro.neck.feature_upsample
        nr = len(ratios)
        feats[0] = _run_layers(P, up.image_block, feats[0])
        for i in range(nr):
            feats[i + 1] = _run_layers(P, up.scaled_images[i], feats[i + 1])
        for i in range(len(cfg["intermediate_feature_dims"])):
            feats[nr + i + 1] = _run_layers(P, up.intermediate[i], feats[nr + i + 1])
        glob = conv(P, self.depth_pro.neck.fuse_image_with_low_res,
                    torch.cat([feats[1], feats[0]], 1))
        projs = self.depth_pro.neck.feature_projection.projections
        feats = [f if isinstance(p, nn.Identity) else conv(P, p, f)
                 for p, f in zip(projs, [glob, *feats[2:]])]
        fused = None
        for layer, f in zip(self.fusion_stage.intermediate, feats[:-1]):
            fused = layer.run(P, f) if fused is None else layer.run(P, fused, f)
        fused = self.fusion_stage.final.run(P, fused, feats[-1])
        hl = self.head.layers
        h = F.relu(conv(P, hl[2], conv(P, hl[1], conv(P, hl[0], fused))))
        inv = F.relu(conv(P, hl[4], h))[:, 0]
        # field of view
        fv = self.fov_model
        s = cfg["fov_model_config"]["image_size"]
        last, _ = self._last(P, fv.fov_encoder.model, C.interp(x, s, s, align_corners=False))
        neck = C.linear(P, "prior", last, fv.fov_encoder.neck.weight, fv.fov_encoder.neck.bias)
        g = _reconstruct(neck, B, 0, (bh, bw)) + F.relu(conv(P, fv.conv, feats[0]))
        g = C.interp(g, self._out(), self._out(), align_corners=False)
        fov = _run_layers(P, fv.head, g).reshape(B)
        return inv, fov

    def depth_focal(self, P, images01):
        """Metric depth (B, S, S) and focal in pixels of the S-wide input,
        from [0, 1] frames (B, H, W, 3): the input resized to S x S
        (jax.image.resize bilinear), normalised to [-1, 1]."""
        S = self.cfg["image_size"]
        x = (C.jax_resize(images01.float(), S, S, "bilinear") - 0.5) / 0.5
        inv, fov = self.inverse_depth_fov(P, x.permute(0, 3, 1, 2))
        inv = torch.clamp(inv, 1e-4, 1e4)
        t = torch.tan(0.5 * torch.deg2rad(fov))
        return S / (2.0 * t[:, None, None] * inv), 0.5 * S / t


def build(cfg_prior, device="meta"):
    """The reference module of a configuration's prior, on `device`."""
    with torch.device(device):
        if cfg_prior["kind"] == "depthpro":
            return DepthPro(cfg_prior).eval()
        return DepthAnything(cfg_prior).eval()
