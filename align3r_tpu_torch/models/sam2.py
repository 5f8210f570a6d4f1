"""SAM2 image model: Hiera trunk, FPN neck, prompt encoder and mask decoder
(port of align3r_tpu/models/sam2.py).

The submodules are named after the Hugging Face state-dict keys (Sam2Model:
`vision_encoder.backbone.blocks.3.attn.qkv.weight`, `mask_decoder.
transformer.layers.0.cross_attn_token_to_image.q_proj.bias`,
`prompt_encoder.mask_embed.conv1.weight`, ...), so a checkpoint read by
`utils.hf_weights` loads with `load_state_dict(strict=True)`; the video
model (`models.sam2_video.SAM2Video`) adds the memory modules under
Sam2VideoModel's keys. Activations are NHWC, as in the JAX package, and the
functions below follow its functions one for one:
- `hiera_forward` (window partition and unpartition, 2x2 max pool,
  multi-scale attention with query pooling, the stage-boundary projection,
  the bicubic background position embedding and the tiled window one);
- `vision_neck` and `sine_pos_embedding`;
- the prompt encoder (`gaussian_pos_encode`, point, box and mask prompts);
- `mask_decoder` (the two-way transformer, upscaling with s0 / s1,
  hypernetwork heads, IoU and object-score heads, the dynamic multimask
  chosen by stability);
- `sam2_encode_image`, `sam2_decode_heads` and `sam2_image_forward`.

Numerics follow the JAX package, not transformers, where the two differ:
the background position embedding is resized with jax.image.resize's
bicubic (Keys a = -0.5; `models.nn.resize`), where HF takes torch's (a =
-0.75). The Hiera trunk's attentions go through `ops.attention.attention(q,
k, v, model.attn_impl)` ("auto" unless a caller sets it): `xla_attention`
on CPU tensors, and on the card a hand-written kernel where the dispatch
routes one (K6's fp32 forward at Hiera-L's 16x16 windows of stage 3, D =
72); the JAX package calls xla_attention there. The mask decoder's
attentions are xla_attention, as in JAX. Projections, MLPs and convolutions
are fp32; callers run them with TF32 off (`raft.exact_fp32`).

Weights: `load_hf_sam2` (a local HF folder or cached hub name),
`load_jax_params` (the JAX parameter tree, numpy leaves) and `init_sam2_`
(seeded random weights at any width).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.depth_anything import _box, materialize
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.ops.attention import attention, xla_attention
from align3r_tpu_torch.utils import hf_weights


# ------------------------------------------------------------------ config

@dataclasses.dataclass(frozen=True)
class HieraConfig:
    hidden_size: int = 96
    num_heads_per_stage: Tuple[int, ...] = (1, 2, 4, 8)
    blocks_per_stage: Tuple[int, ...] = (1, 2, 7, 2)
    embed_dim_per_stage: Tuple[int, ...] = (96, 192, 384, 768)
    window_size_per_stage: Tuple[int, ...] = (8, 4, 14, 7)
    global_attention_blocks: Tuple[int, ...] = (5, 7, 9)
    query_stride: Tuple[int, int] = (2, 2)
    num_query_pool_stages: int = 3
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    window_pos_bg_size: Tuple[int, int] = (14, 14)
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = HieraConfig()
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    fpn_hidden_size: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    num_feature_levels: int = 3
    image_size: int = 1024
    patch_size: int = 16                      # prompt-encoder grid divisor
    prompt_hidden_size: int = 256
    mask_input_channels: int = 16
    decoder_hidden_size: int = 256
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    decoder_layers: int = 2
    decoder_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_hidden_dim: int = 256
    iou_head_depth: int = 3
    stability_delta: float = 0.05
    stability_thresh: float = 0.98
    layer_norm_eps: float = 1e-6


# ---------------------------------------------------------------- helpers

def _lin(m: nn.Linear, x):
    return F.linear(x, m.weight, m.bias)


def _conv(m: nn.Conv2d, x):
    """An NCHW-weighted Conv2d on an NHWC tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), m.weight, m.bias, m.stride, m.padding,
                 groups=m.groups)
    return y.permute(0, 2, 3, 1)


def _conv_t(m: nn.ConvTranspose2d, x):
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), m.weight, m.bias, m.stride)
    return y.permute(0, 2, 3, 1)


def _ln(m: nn.LayerNorm, x, eps: float):
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, eps)


def _ffn(m, x, sigmoid_output: bool = False, act=F.relu):
    """Sam2FeedForward (proj_in, layers, proj_out); relu between layers."""
    x = act(_lin(m.proj_in, x))
    for lp in getattr(m, "layers", ()):
        x = act(_lin(lp, x))
    x = _lin(m.proj_out, x)
    return torch.sigmoid(x) if sigmoid_output else x


def _feed_forward(cin: int, hidden: int, cout: int, n_layers: int) -> nn.Module:
    m = _box(proj_in=nn.Linear(cin, hidden), proj_out=nn.Linear(hidden, cout))
    if n_layers > 2:
        m.layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(n_layers - 2))
    return m


# ------------------------------------------------------------- Hiera trunk

def _window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(win, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // ws // ws)
    x = win.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def _max_pool(x, stride: int):
    """reduce_window max, VALID, window = stride (NHWC)."""
    B, H, W, C = x.shape
    h, w = H // stride, W // stride
    x = x[:, :h * stride, :w * stride]
    return x.reshape(B, h, stride, w, stride, C).amax(dim=(2, 4))


class HieraBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = _box(qkv=nn.Linear(dim, 3 * dim_out), proj=nn.Linear(dim_out, dim_out))
        self.layer_norm2 = nn.LayerNorm(dim_out, eps=eps)
        hid = int(dim_out * mlp_ratio)
        self.mlp = _box(proj_in=nn.Linear(dim_out, hid), proj_out=nn.Linear(hid, dim_out))
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)


def block_plan(cfg: HieraConfig) -> List[Tuple[int, int, int, int, Optional[int]]]:
    """Per block: (dim_in, dim_out, heads, window size (0: global), query
    stride or None), as hiera_forward walks them."""
    plan, total, dim = [], 0, cfg.hidden_size
    for stage, n_blocks in enumerate(cfg.blocks_per_stage):
        for b in range(n_blocks):
            dim_out = cfg.embed_dim_per_stage[stage]
            ws = (cfg.window_size_per_stage[stage - 1] if stage > 0 and b == 0
                  else cfg.window_size_per_stage[stage])
            if total in cfg.global_attention_blocks:
                ws = 0
            qs = (cfg.query_stride[0]
                  if 0 < stage <= cfg.num_query_pool_stages and b == 0 else None)
            plan.append((dim, dim_out, cfg.num_heads_per_stage[stage], ws, qs))
            dim = dim_out
            total += 1
    return plan


class Hiera(nn.Module):
    """Sam2HieraDetModel's keys: patch_embed.projection, pos_embed,
    pos_embed_window, blocks."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.patch_embed = _box(projection=nn.Conv2d(
            3, C, cfg.patch_kernel, stride=cfg.patch_stride, padding=cfg.patch_padding))
        self.pos_embed = nn.Parameter(torch.zeros(1, C, *cfg.window_pos_bg_size))
        w0 = cfg.window_size_per_stage[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, C, w0, w0))
        self.plan = block_plan(cfg)
        self.blocks = nn.ModuleList(HieraBlock(din, dout, cfg.mlp_ratio, cfg.layer_norm_eps)
                                    for din, dout, _, _, _ in self.plan)


def _ms_attention(attn, x, num_heads: int, query_stride, impl: str):
    B, H, W, _ = x.shape
    qkv = _lin(attn.qkv, x.reshape(B, H * W, -1))
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    if query_stride is not None:
        q = _max_pool(q.reshape(B, H, W, -1), query_stride)
        H, W = q.shape[1:3]
        q = q.reshape(B, H * W, -1)
    D = q.shape[-1] // num_heads

    def heads(t):
        return t.reshape(B, -1, num_heads, D).permute(0, 2, 1, 3)

    out = attention(heads(q), heads(k), heads(v), impl)
    out = out.permute(0, 2, 1, 3).reshape(B, H, W, num_heads * D)
    return _lin(attn.proj, out)


def hiera_forward(trunk: Hiera, pixel_values, impl: str = "auto"):
    """pixel_values (B, H, W, 3). Returns the per-stage outputs (B, h, w, C)."""
    cfg = trunk.cfg
    x = _conv(trunk.patch_embed.projection, pixel_values)
    h, w = x.shape[1:3]
    bg = L.resize(trunk.pos_embed.permute(0, 2, 3, 1), h, w, "bicubic")
    win = trunk.pos_embed_window.permute(0, 2, 3, 1)
    x = x + bg + win.repeat(1, h // win.shape[1], w // win.shape[2], 1)

    stage_ends = {int(e) for e in np.cumsum(cfg.blocks_per_stage) - 1}
    outputs = []
    for total, (bp, (_, _, heads_n, ws, qs)) in enumerate(zip(trunk.blocks, trunk.plan)):
        residual = x
        hid = _ln(bp.layer_norm1, x, cfg.layer_norm_eps)
        if hasattr(bp, "proj"):  # dim change at the stage boundary
            residual = _lin(bp.proj, hid)
            if qs is not None:
                residual = _max_pool(residual, qs)
        H0, W0 = hid.shape[1:3]
        if ws > 0:
            hid, pad_hw = _window_partition(hid, ws)
        att = _ms_attention(bp.attn, hid, heads_n, qs, impl)
        ws_out = ws
        if qs is not None:
            ws_out = ws // qs if ws > 0 else 0
            Hr, Wr = residual.shape[1:3]
            pad_hw = (Hr + (-Hr) % ws_out if ws_out else Hr,
                      Wr + (-Wr) % ws_out if ws_out else Wr)
            H0, W0 = Hr, Wr
        if ws > 0:
            att = _window_unpartition(att, ws_out, pad_hw, (H0, W0))
        x = residual + att
        hid = _ln(bp.layer_norm2, x, cfg.layer_norm_eps)
        hid = _lin(bp.mlp.proj_out, L.gelu(_lin(bp.mlp.proj_in, hid)))
        x = x + hid
        if total in stage_ends:
            outputs.append(x)
    return outputs


def hiera_attention_shapes(cfg: HieraConfig, image_size: int, batch: int = 1):
    """(B*windows, heads, Nq, Nk, D) of each Hiera block's attention for
    `batch` square images of `image_size` pixels, as hiera_forward forms
    them (the windows padded up to whole windows)."""
    out = []
    H = W = (image_size + 2 * cfg.patch_padding - cfg.patch_kernel) // cfg.patch_stride + 1
    for _, dout, heads, ws, qs in block_plan(cfg):
        if ws > 0:
            n = batch * -(-H // ws) * -(-W // ws)
            sh, sw = ws, ws
        else:
            n, sh, sw = batch, H, W
        qh, qw = (sh // qs, sw // qs) if qs else (sh, sw)
        out.append((n, heads, qh * qw, sh * sw, dout // heads))
        if qs:
            H, W = H // qs, W // qs
    return out


# -------------------------------------------------------------------- neck

def sine_pos_embedding(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0,
                       scale: Optional[float] = None, device=None):
    """Normalised sine embedding (h, w, 2 num_pos_feats), fp32."""
    scale = 2 * math.pi if scale is None else scale
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None] / (h + 1e-6) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :] / (w + 1e-6) * scale
    y, x = y.expand(h, w), x.expand(h, w)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t

    def interleave(v):
        return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                           dim=-1).reshape(v.shape[:-1] + (-1,))

    return torch.cat([interleave(py), interleave(px)], dim=-1)


def _nearest(x, h: int, w: int):
    """jax.image.resize "nearest" (NHWC): source index floor((i + .5) in / out)."""
    H, W = x.shape[1:3]
    iy = ((torch.arange(h, device=x.device) + 0.5) * (H / h)).floor().long()
    ix = ((torch.arange(w, device=x.device) + 0.5) * (W / w)).floor().long()
    return x[:, iy][:, :, ix]


def vision_neck(neck, stage_outputs, cfg: SAM2Config):
    """FPN over the reversed stage list. Returns (feats, pos), coarse to fine."""
    n = len(neck.convs) - 1
    feats, poss = [], []
    prev = None
    for i in range(n, -1, -1):
        lat = _conv(neck.convs[n - i], stage_outputs[i])
        if i in cfg.fpn_top_down_levels and i != n and prev is not None:
            prev = lat + _nearest(prev, lat.shape[1], lat.shape[2])
        else:
            prev = lat
        pos = sine_pos_embedding(prev.shape[1], prev.shape[2], cfg.fpn_hidden_size // 2,
                                 device=prev.device)
        feats.append(prev)
        poss.append(pos[None].expand(prev.shape[:3] + (cfg.fpn_hidden_size,)))
    return feats, poss


# ----------------------------------------------------------- prompt encoder

def gaussian_pos_encode(coords01, pe_matrix):
    """coords in [0, 1] -> (..., 2F) (Sam2PositionalEmbedding)."""
    c = (2 * coords01 - 1) @ pe_matrix
    c = 2 * np.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def embed_point_prompts(model, points, labels, image_size: int, pad: bool = True):
    """Sparse point-prompt tokens. points (B, P, N, 2) pixel (x, y); labels
    (B, P, N): 1 positive, 0 negative, -1 padding. Returns (B, P, N(+1), C)."""
    pe = model.shared_image_embedding.positional_embedding
    pts = torch.as_tensor(points, dtype=torch.float32, device=pe.device) + 0.5
    lab = torch.as_tensor(labels, device=pe.device).long()
    if pad:  # trailing not-a-point slot (omitted when boxes accompany)
        pts = F.pad(pts, (0, 0, 0, 1))
        lab = F.pad(lab, (0, 1), value=-1)
    emb = gaussian_pos_encode(pts / image_size, pe)
    pr = model.prompt_encoder
    emb = torch.where(lab[..., None] == -1, pr.not_a_point_embed.weight, emb)
    return emb + pr.point_embed.weight[lab.clamp(min=0)] * (lab >= 0)[..., None]


def embed_box_prompts(model, boxes, image_size: int):
    """Box corners as sparse tokens. boxes (B, n, 4) pixel (x1, y1, x2, y2)
    -> (B, n, 3, C)."""
    pe = model.shared_image_embedding.positional_embedding
    b = torch.as_tensor(boxes, dtype=torch.float32, device=pe.device) + 0.5
    coords = F.pad(b.reshape(b.shape[0], b.shape[1], 2, 2), (0, 0, 0, 1))
    emb = gaussian_pos_encode(coords / image_size, pe)
    pt = model.prompt_encoder.point_embed.weight
    return torch.stack([emb[:, :, 0] + pt[2], emb[:, :, 1] + pt[3],
                        model.prompt_encoder.not_a_point_embed.weight[0].expand_as(emb[:, :, 2])],
                       dim=2)


def embed_mask_prompt(me, masks, eps: float = 1e-6):
    """masks (B, H, W, 1) at the mask input size -> dense embeddings."""
    x = L.gelu(_ln(me.layer_norm1, _conv(me.conv1, masks), eps))
    x = L.gelu(_ln(me.layer_norm2, _conv(me.conv2, x), eps))
    return _conv(me.conv3, x)


# -------------------------------------------------------------- mask decoder

def _attention_module(C: int, internal: int) -> nn.Module:
    return _box(q_proj=nn.Linear(C, internal), k_proj=nn.Linear(C, internal),
                v_proj=nn.Linear(C, internal), o_proj=nn.Linear(internal, C))


def _attn(m, q, k, v, num_heads: int):
    """Sam2Attention: q / k / v projections to the internal dim, o_proj out.
    q / k / v (B, P, N, C); xla_attention, as the JAX package calls it."""
    B, P = q.shape[:2]
    qq, kk, vv = _lin(m.q_proj, q), _lin(m.k_proj, k), _lin(m.v_proj, v)
    D = qq.shape[-1] // num_heads

    def heads(t):
        return t.reshape(B * P, -1, num_heads, D).permute(0, 2, 1, 3)

    out = xla_attention(heads(qq), heads(kk), heads(vv))
    out = out.permute(0, 2, 1, 3).reshape(B, P, -1, num_heads * D)
    return _lin(m.o_proj, out)


def two_way_transformer(t, tokens, image_emb, image_pe, cfg: SAM2Config):
    """tokens (B, P, T, C); image_emb / pe (B, N, C) flattened."""
    queries = tokens
    keys = image_emb[:, None]
    pe = image_pe[:, None]
    H = cfg.decoder_num_heads
    for i, lp in enumerate(t.layers):
        if i == 0:
            queries = _attn(lp.self_attn, queries, queries, queries, H)
        else:
            q_in = queries + tokens
            queries = queries + _attn(lp.self_attn, q_in, q_in, queries, H)
        queries = _ln(lp.layer_norm1, queries, 1e-5)
        q_in, k_in = queries + tokens, keys + pe
        queries = queries + _attn(lp.cross_attn_token_to_image, q_in, k_in, keys, H)
        queries = _ln(lp.layer_norm2, queries, 1e-5)
        queries = queries + _ffn(lp.mlp, queries)
        queries = _ln(lp.layer_norm3, queries, 1e-5)
        q_in, k_in = queries + tokens, keys + pe
        keys = keys + _attn(lp.cross_attn_image_to_token, k_in, q_in, queries, H)
        keys = _ln(lp.layer_norm4, keys, 1e-5)
    q_in, k_in = queries + tokens, keys + pe
    queries = queries + _attn(t.final_attn_token_to_image, q_in, k_in, keys, H)
    queries = _ln(t.layer_norm_final_attn, queries, 1e-5)
    return queries, keys


def _stability(mask_logits, delta: float):
    flat = mask_logits.reshape(mask_logits.shape[:-2] + (-1,))
    ai = (flat > delta).sum(-1).float()
    au = (flat > -delta).sum(-1).float()
    return torch.where(au > 0, ai / au, torch.ones_like(ai))


def _take(x, idx):
    """x (B, P, M, ...) at index idx (B, P) of M, keeping the axis."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 2, idx.reshape(shape).expand(idx.shape + (1,) + x.shape[3:]))


def _dynamic_multimask(all_masks, all_iou, cfg: SAM2Config):
    """Single-mask output with the stability-based fallback to the best
    multimask; ties in the IoU go to the first index, as jnp.argmax."""
    multi, multi_iou = all_masks[:, :, 1:], all_iou[:, :, 1:]
    best = torch.argmax(multi_iou, dim=-1)
    bm, bi = _take(multi, best), _take(multi_iou, best)
    single, single_iou = all_masks[:, :, 0:1], all_iou[:, :, 0:1]
    stable = _stability(single[:, :, 0], cfg.stability_delta) >= cfg.stability_thresh
    masks = torch.where(stable[..., None, None, None], single, bm)
    iou = torch.where(stable[..., None], single_iou, bi)
    return masks, iou


def mask_decoder(dec, image_emb, image_pe, sparse, dense, hires, cfg: SAM2Config,
                 multimask_output: bool = False):
    """image_emb (B, h, w, C); sparse (B, P, S, C); dense (B, h, w, C);
    hires [s0 (B, 4h, 4w, C/8), s1 (B, 2h, 2w, C/4)]. Returns (masks (B, P,
    M, 4h, 4w), iou, obj_logits, sam_tokens (B, P, M', C)): the mask-token
    slice HF's Sam2MaskDecoder returns (multimask: tokens 1:, else token 0)."""
    B, h, w, C = image_emb.shape
    P = sparse.shape[1]
    n_mask_tokens = cfg.num_multimask_outputs + 1
    out_tokens = torch.cat([dec.obj_score_token.weight, dec.iou_token.weight,
                            dec.mask_tokens.weight], dim=0)
    out_tokens = out_tokens[None, None].expand(B, P, out_tokens.shape[0], C)
    tokens = torch.cat([out_tokens, sparse], dim=2)

    # (batch, point batch) flattened to the leading axis, point dim 1 (HF)
    emb = torch.repeat_interleave((image_emb + dense).reshape(B, h * w, C), P, dim=0)
    pe = torch.repeat_interleave(image_pe.reshape(B, h * w, C), P, dim=0)

    queries, keys = two_way_transformer(
        dec.transformer, tokens.reshape(B * P, 1, tokens.shape[2], C), emb, pe, cfg)
    queries = queries.reshape(B, P, -1, C)
    keys = keys.reshape(B, P, h * w, C)

    iou_tok = queries[:, :, 1]
    mask_toks = queries[:, :, 2:2 + n_mask_tokens]

    src = keys.reshape(B * P, h, w, C)
    s0 = torch.repeat_interleave(hires[0], P, dim=0)
    s1 = torch.repeat_interleave(hires[1], P, dim=0)
    up = _conv_t(dec.upscale_conv1, src) + s1
    up = L.gelu(_ln(dec.upscale_layer_norm, up, 1e-6))
    up = L.gelu(_conv_t(dec.upscale_conv2, up) + s0)

    hyper = torch.stack([_ffn(dec.output_hypernetworks_mlps[i], mask_toks[:, :, i])
                         for i in range(n_mask_tokens)], dim=2)  # (B, P, M, C/8)
    hh, ww = up.shape[1:3]
    upf = up.reshape(B, P, hh * ww, -1)
    masks = torch.einsum("bpmc,bpnc->bpmn", hyper, upf).reshape(B, P, -1, hh, ww)
    iou = _ffn(dec.iou_prediction_head, iou_tok, sigmoid_output=True)
    obj = _ffn(dec.pred_obj_score_head, queries[:, :, 0])

    if multimask_output:
        return masks[:, :, 1:], iou[:, :, 1:], obj, mask_toks[:, :, 1:]
    masks, iou = _dynamic_multimask(masks, iou, cfg)
    return masks, iou, obj, mask_toks[:, :, 0:1]


# ------------------------------------------------------------------ model

class SAM2Image(nn.Module):
    """Sam2Model (the image model): vision_encoder (backbone, neck),
    prompt_encoder, mask_decoder, shared_image_embedding and
    no_memory_embedding."""

    def __init__(self, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        self.cfg, self.attn_impl = cfg, "auto"
        fpn, C = cfg.fpn_hidden_size, cfg.decoder_hidden_size
        self.vision_encoder = _box(
            backbone=Hiera(cfg.hiera),
            neck=_box(convs=nn.ModuleList(nn.Conv2d(ch, fpn, 1)
                                          for ch in cfg.backbone_channel_list)))
        Cp, mic = cfg.prompt_hidden_size, cfg.mask_input_channels
        self.prompt_encoder = _box(
            mask_embed=_box(conv1=nn.Conv2d(1, mic // 4, 2, stride=2),
                            conv2=nn.Conv2d(mic // 4, mic, 2, stride=2),
                            conv3=nn.Conv2d(mic, Cp, 1),
                            layer_norm1=nn.LayerNorm(mic // 4), layer_norm2=nn.LayerNorm(mic)),
            no_mask_embed=nn.Embedding(1, Cp), point_embed=nn.Embedding(4, Cp),
            not_a_point_embed=nn.Embedding(1, Cp))
        ds = C // cfg.decoder_downsample_rate
        layer = lambda: _box(
            self_attn=_attention_module(C, C), layer_norm1=nn.LayerNorm(C),
            cross_attn_token_to_image=_attention_module(C, ds), layer_norm2=nn.LayerNorm(C),
            mlp=_feed_forward(C, cfg.decoder_mlp_dim, C, 2), layer_norm3=nn.LayerNorm(C),
            layer_norm4=nn.LayerNorm(C), cross_attn_image_to_token=_attention_module(C, ds))
        n_mask_tokens = cfg.num_multimask_outputs + 1
        self.mask_decoder = _box(
            iou_token=nn.Embedding(1, C), mask_tokens=nn.Embedding(n_mask_tokens, C),
            obj_score_token=nn.Embedding(1, C),
            transformer=_box(layers=nn.ModuleList(layer() for _ in range(cfg.decoder_layers)),
                             final_attn_token_to_image=_attention_module(C, ds),
                             layer_norm_final_attn=nn.LayerNorm(C)),
            upscale_conv1=nn.ConvTranspose2d(C, C // 4, 2, stride=2),
            upscale_conv2=nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2),
            upscale_layer_norm=nn.LayerNorm(C // 4),
            output_hypernetworks_mlps=nn.ModuleList(
                _feed_forward(C, C, C // 8, 3) for _ in range(n_mask_tokens)),
            iou_prediction_head=_feed_forward(C, cfg.iou_head_hidden_dim, n_mask_tokens,
                                              cfg.iou_head_depth),
            conv_s0=nn.Conv2d(C, C // 8, 1), conv_s1=nn.Conv2d(C, C // 4, 1),
            pred_obj_score_head=_feed_forward(C, C, 1, 3))
        self.shared_image_embedding = _box(
            positional_embedding=nn.Parameter(torch.zeros(2, Cp // 2)))
        self.no_memory_embedding = nn.Parameter(torch.zeros(1, 1, C))


def sam2_encode_image(model: SAM2Image, pixel_values):
    """Vision trunk + neck + skip projections. Returns (s0, s1, top, top_pos)
    with `top` raw: the no-memory embedding is not added (the video model
    conditions `top` on memory instead; sam2_image_forward adds it)."""
    cfg = model.cfg
    stage_outputs = hiera_forward(model.vision_encoder.backbone, pixel_values, model.attn_impl)
    feats, poss = vision_neck(model.vision_encoder.neck, stage_outputs, cfg)
    feats = feats[-cfg.num_feature_levels:][::-1]  # fine -> coarse
    poss = poss[-cfg.num_feature_levels:][::-1]
    s0 = _conv(model.mask_decoder.conv_s0, feats[0])
    s1 = _conv(model.mask_decoder.conv_s1, feats[1])
    return s0, s1, feats[2], poss[2]


def sam2_decode_heads(model: SAM2Image, top, s0, s1, input_masks=None,
                      multimask_output: bool = False, input_points=None, input_labels=None,
                      input_boxes=None):
    """Prompt encoder + mask decoder on already-conditioned top-level features
    `top` (B, g, g, C). Prompts: points (B, P, N, 2) with labels, boxes (B, n,
    4), mask logits; with no sparse prompt one not-a-point token stands in.
    Returns (masks, iou, obj_logits, sam_tokens)."""
    cfg = model.cfg
    B, g = top.shape[0], top.shape[1]
    pe = model.shared_image_embedding.positional_embedding
    ys = (torch.arange(g, dtype=torch.float32, device=top.device) + 0.5) / g
    grid = torch.stack(torch.meshgrid(ys, ys, indexing="ij"), -1).flip(-1)  # (x, y)
    img_pe = gaussian_pos_encode(grid, pe)
    img_pe = img_pe[None].expand(B, g, g, img_pe.shape[-1])

    sparse = None
    if input_points is not None:
        sparse = embed_point_prompts(model, input_points, input_labels, cfg.image_size,
                                     pad=input_boxes is None)
    if input_boxes is not None:
        box_emb = embed_box_prompts(model, input_boxes, cfg.image_size)
        sparse = box_emb if sparse is None else torch.cat([sparse, box_emb], dim=2)
    if sparse is None:
        sparse = model.prompt_encoder.not_a_point_embed.weight[None, None].expand(
            B, 1, 1, cfg.prompt_hidden_size)
    if input_masks is not None:
        dense = embed_mask_prompt(model.prompt_encoder.mask_embed, input_masks,
                                  cfg.layer_norm_eps)
    else:
        dense = model.prompt_encoder.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(top.shape)
    return mask_decoder(model.mask_decoder, top, img_pe, sparse, dense, [s0, s1], cfg,
                        multimask_output)


def sam2_image_forward(model: SAM2Image, pixel_values, input_masks=None,
                       multimask_output: bool = False, input_points=None, input_labels=None,
                       input_boxes=None):
    """pixel_values (B, S, S, 3) processor-normalised; input_masks optional
    (B, 4g, 4g, 1) logits at the mask input size; input_points (B, P, N, 2)
    pixel xy with input_labels (B, P, N); input_boxes (B, n, 4). Returns
    (low-res mask logits (B, P, M, 4g, 4g), iou, obj_logits)."""
    s0, s1, top, _pos = sam2_encode_image(model, pixel_values)
    top = top + model.no_memory_embedding.reshape(1, 1, 1, -1)
    masks, iou, obj, _tokens = sam2_decode_heads(
        model, top, s0, s1, input_masks, multimask_output, input_points=input_points,
        input_labels=input_labels, input_boxes=input_boxes)
    return masks, iou, obj


# ------------------------------------------------------------------ config

def _dflt(d: dict, key, default):
    v = d.get(key)
    return default if v is None else v


def config_from_hf_sam2(config: dict) -> SAM2Config:
    """SAM2Config from a Sam2Model / Sam2VideoModel config.json dict (the
    JAX config_from_hf_sam2 reads the same fields off the HF object; a key
    missing from the file takes transformers' default)."""
    v = config.get("vision_config") or {}
    b = v.get("backbone_config") or {}
    pe = config.get("prompt_encoder_config") or {}
    md = config.get("mask_decoder_config") or {}
    H, S = HieraConfig(), SAM2Config()
    hiera = HieraConfig(
        hidden_size=_dflt(b, "hidden_size", H.hidden_size),
        num_heads_per_stage=tuple(_dflt(b, "num_attention_heads_per_stage",
                                        H.num_heads_per_stage)),
        blocks_per_stage=tuple(_dflt(b, "blocks_per_stage", H.blocks_per_stage)),
        embed_dim_per_stage=tuple(_dflt(b, "embed_dim_per_stage", H.embed_dim_per_stage)),
        window_size_per_stage=tuple(_dflt(b, "window_size_per_stage",
                                          H.window_size_per_stage)),
        global_attention_blocks=tuple(_dflt(b, "global_attention_blocks",
                                            H.global_attention_blocks)),
        query_stride=tuple(_dflt(b, "query_stride", H.query_stride)),
        num_query_pool_stages=_dflt(b, "num_query_pool_stages", H.num_query_pool_stages),
        patch_kernel=_dflt(b, "patch_kernel_size", H.patch_kernel),
        patch_stride=_dflt(b, "patch_stride", H.patch_stride),
        patch_padding=_dflt(b, "patch_padding", H.patch_padding),
        window_pos_bg_size=tuple(_dflt(b, "window_positional_embedding_background_size",
                                       H.window_pos_bg_size)),
        mlp_ratio=_dflt(b, "mlp_ratio", H.mlp_ratio),
        layer_norm_eps=_dflt(b, "layer_norm_eps", H.layer_norm_eps))
    return SAM2Config(
        hiera=hiera,
        backbone_channel_list=tuple(_dflt(v, "backbone_channel_list", S.backbone_channel_list)),
        fpn_hidden_size=_dflt(v, "fpn_hidden_size", S.fpn_hidden_size),
        fpn_top_down_levels=tuple(_dflt(v, "fpn_top_down_levels", S.fpn_top_down_levels)),
        num_feature_levels=_dflt(v, "num_feature_levels", S.num_feature_levels),
        image_size=_dflt(pe, "image_size", S.image_size),
        patch_size=_dflt(pe, "patch_size", S.patch_size),
        prompt_hidden_size=_dflt(pe, "hidden_size", S.prompt_hidden_size),
        mask_input_channels=_dflt(pe, "mask_input_channels", S.mask_input_channels),
        decoder_hidden_size=_dflt(md, "hidden_size", S.decoder_hidden_size),
        decoder_num_heads=_dflt(md, "num_attention_heads", S.decoder_num_heads),
        decoder_mlp_dim=_dflt(md, "mlp_dim", S.decoder_mlp_dim),
        decoder_layers=_dflt(md, "num_hidden_layers", S.decoder_layers),
        decoder_downsample_rate=_dflt(md, "attention_downsample_rate",
                                      S.decoder_downsample_rate),
        num_multimask_outputs=_dflt(md, "num_multimask_outputs", S.num_multimask_outputs),
        iou_head_hidden_dim=_dflt(md, "iou_head_hidden_dim", S.iou_head_hidden_dim),
        iou_head_depth=_dflt(md, "iou_head_depth", S.iou_head_depth),
        stability_delta=_dflt(md, "dynamic_multimask_stability_delta", S.stability_delta),
        stability_thresh=_dflt(md, "dynamic_multimask_stability_thresh", S.stability_thresh))


# ----------------------------------------------------------------- weights

def load_hf_sam2(name_or_path: str, device="cuda"):
    """(SAM2Image, cfg) from a local HF Sam2Model folder or cached hub name,
    on `device` (the card unless "cpu" is asked for)."""
    dev = device_or_raise(device)
    config, sd = hf_weights.load(name_or_path)
    cfg = config_from_hf_sam2(config)
    return materialize(lambda: SAM2Image(cfg), sd, dev), cfg


# parameters HF initialises to zero (or a constant), seeded by init_sam2_ so
# that every route does work: the learned embeddings N(0, 0.1), the Hiera
# position embeddings N(0, 0.02), the Gaussian position matrix N(0, 1)
_EMBEDDINGS = ("no_memory_embedding", "no_memory_positional_encoding", "no_object_pointer",
               "memory_temporal_positional_encoding", "occlusion_spatial_embedding_parameter")
_POS = ("pos_embed", "pos_embed_window")


@torch.no_grad()
def init_sam2_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights for a SAM2 image or video model at any width,
    drawn on the parameters' device: linear and conv weights N(0, 1 /
    fan_in), biases 0, layernorms identity, token and prompt embeddings and
    the embeddings in _EMBEDDINGS N(0, 0.1), the Hiera position embeddings
    N(0, 0.02), the Gaussian position matrix N(0, 1), the memory fuser's
    layer scales 0.1; then the object-score head's last layer scaled by 0.1
    with its bias 1, so that the object counts as present (as a real
    checkpoint judges a tracked object) and tracked frames add mask pixels."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda p, s: p.copy_(torch.randn(p.shape, generator=g, device=dev) * s)
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(owner) if owner else model
        if leaf in _EMBEDDINGS or isinstance(mod, nn.Embedding):
            rnd(p, 0.1)
        elif leaf in _POS:
            rnd(p, 0.02)
        elif leaf == "positional_embedding":
            rnd(p, 1.0)
        elif leaf == "scale":
            p.fill_(0.1)
        elif leaf == "bias":
            p.zero_()
        elif isinstance(mod, nn.LayerNorm):
            p.fill_(1.0)
        else:
            fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
            rnd(p, 1.0 / math.sqrt(fan_in))
    head = model.mask_decoder.pred_obj_score_head.proj_out
    head.weight.mul_(0.1)
    head.bias.fill_(1.0)
    return model


def _c2d(p, name):
    out = {f"{name}.weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])
    return out


def _ct2d(p, name):
    return {f"{name}.weight": np.asarray(p["kernel"]).transpose(0, 3, 1, 2),
            f"{name}.bias": np.asarray(p["bias"])}


def _lin_sd(p, name):
    return {f"{name}.weight": np.asarray(p["kernel"]).T, f"{name}.bias": np.asarray(p["bias"])}


def _ln_sd(p, name):
    return {f"{name}.weight": np.asarray(p["scale"]), f"{name}.bias": np.asarray(p["bias"])}


def _attn_sd(p, pfx):
    return {**_lin_sd(p["q"], f"{pfx}.q_proj"), **_lin_sd(p["k"], f"{pfx}.k_proj"),
            **_lin_sd(p["v"], f"{pfx}.v_proj"), **_lin_sd(p["o"], f"{pfx}.o_proj")}


def _ffn_sd(p, pfx):
    sd = {**_lin_sd(p["in"], f"{pfx}.proj_in"), **_lin_sd(p["out"], f"{pfx}.proj_out")}
    for i, lp in enumerate(p.get("mid", [])):
        sd.update(_lin_sd(lp, f"{pfx}.layers.{i}"))
    return sd


def sam2_state_dict(params) -> Dict[str, np.ndarray]:
    """The JAX SAM2 image tree (convert_hf_sam2's) under HF keys."""
    bb = "vision_encoder.backbone"
    h = params["hiera"]
    sd = {**_c2d(h["patch_embed"], f"{bb}.patch_embed.projection"),
          f"{bb}.pos_embed": np.asarray(h["pos_embed"]).transpose(0, 3, 1, 2),
          f"{bb}.pos_embed_window": np.asarray(h["pos_embed_window"]).transpose(0, 3, 1, 2)}
    for i, b in enumerate(h["blocks"]):
        q = f"{bb}.blocks.{i}"
        sd.update({**_ln_sd(b["norm1"], f"{q}.layer_norm1"),
                   **_ln_sd(b["norm2"], f"{q}.layer_norm2"),
                   **_lin_sd(b["attn"]["qkv"], f"{q}.attn.qkv"),
                   **_lin_sd(b["attn"]["proj"], f"{q}.attn.proj"),
                   **_lin_sd(b["mlp_in"], f"{q}.mlp.proj_in"),
                   **_lin_sd(b["mlp_out"], f"{q}.mlp.proj_out")})
        if "proj" in b:
            sd.update(_lin_sd(b["proj"], f"{q}.proj"))
    for i, c in enumerate(params["neck"]["convs"]):
        sd.update(_c2d(c, f"vision_encoder.neck.convs.{i}"))
    d, md = params["decoder"], "mask_decoder"
    t = d["transformer"]
    for i, lp in enumerate(t["layers"]):
        q = f"{md}.transformer.layers.{i}"
        sd.update({**_attn_sd(lp["self_attn"], f"{q}.self_attn"),
                   **_attn_sd(lp["cross_t2i"], f"{q}.cross_attn_token_to_image"),
                   **_attn_sd(lp["cross_i2t"], f"{q}.cross_attn_image_to_token"),
                   **_ffn_sd(lp["mlp"], f"{q}.mlp"),
                   **{k: v for n in (1, 2, 3, 4)
                      for k, v in _ln_sd(lp[f"ln{n}"], f"{q}.layer_norm{n}").items()}})
    sd.update({**_attn_sd(t["final_attn"], f"{md}.transformer.final_attn_token_to_image"),
               **_ln_sd(t["ln_final"], f"{md}.transformer.layer_norm_final_attn"),
               f"{md}.obj_score_token.weight": np.asarray(d["obj_score_token"]),
               f"{md}.iou_token.weight": np.asarray(d["iou_token"]),
               f"{md}.mask_tokens.weight": np.asarray(d["mask_tokens"]),
               **_ct2d(d["upscale_conv1"], f"{md}.upscale_conv1"),
               **_ct2d(d["upscale_conv2"], f"{md}.upscale_conv2"),
               **_ln_sd(d["upscale_ln"], f"{md}.upscale_layer_norm"),
               **_ffn_sd(d["iou_head"], f"{md}.iou_prediction_head"),
               **_ffn_sd(d["obj_head"], f"{md}.pred_obj_score_head"),
               **_c2d(params["conv_s0"], f"{md}.conv_s0"),
               **_c2d(params["conv_s1"], f"{md}.conv_s1")})
    for i, hp in enumerate(d["hyper_mlps"]):
        sd.update(_ffn_sd(hp, f"{md}.output_hypernetworks_mlps.{i}"))
    pe = "prompt_encoder"
    me = params["mask_embed"]
    sd.update({"shared_image_embedding.positional_embedding": np.asarray(params["pe_matrix"]),
               "no_memory_embedding": np.asarray(params["no_memory_embedding"]),
               f"{pe}.no_mask_embed.weight": np.asarray(params["no_mask_embed"]),
               f"{pe}.not_a_point_embed.weight": np.asarray(params["not_a_point_embed"]),
               f"{pe}.point_embed.weight": np.asarray(params["point_embed"]),
               **{k: v for n in (1, 2, 3)
                  for k, v in _c2d(me[f"conv{n}"], f"{pe}.mask_embed.conv{n}").items()},
               **_ln_sd(me["ln1"], f"{pe}.mask_embed.layer_norm1"),
               **_ln_sd(me["ln2"], f"{pe}.mask_embed.layer_norm2")})
    return sd


def load_numpy_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    """Load a numpy state dict strictly; the checkpoint entries the JAX tree
    does not carry (the video model's unused no-memory position encoding)
    keep the module's values."""
    own = model.state_dict()
    full = {k: v for k, v in own.items() if k not in sd}
    full.update({k: torch.from_numpy(np.array(v, np.float32)).to(own[k].device)
                 for k, v in sd.items()})
    model.load_state_dict(full, strict=True)
    return model


def load_jax_params(model: SAM2Image, params) -> SAM2Image:
    """The JAX parameter tree (convert_hf_sam2's) into the port's module."""
    return load_numpy_state_dict(model, sam2_state_dict(params))
