"""SAM2 video model: memory attention, memory encoder and the tracking loop
(port of align3r_tpu/models/sam2_video.py).

`SAM2Video` holds the image model's modules (models/sam2.py) and the memory
modules under the Hugging Face Sam2VideoModel keys (`memory_attention.
layers.0.cross_attn_image.k_proj.weight`, `memory_encoder.memory_fuser.
layers.1.depthwise_conv.weight`, `object_pointer_proj.proj_in.bias`, ...),
so a checkpoint read by `utils.hf_weights` loads with strict=True.

The memory bank has the JAX package's fixed capacity and slot layout: 1..8
conditioning slots, `num_maskmem - 1` recent slots and a circular
object-pointer buffer, with validity masks; invalid memory tokens are
masked out of the cross-attention's softmax (-1e30), which equals leaving
them out. The keys are therefore the JAX keys, in the JAX order, and the
shapes stay fixed from frame to frame.

Attention: the memory attention's self-attention (RoPE applied first) goes
through `ops.attention.attention(q, k, v, model.attn_impl)`: xla_attention
on CPU tensors; on the card K9's fp32 forward at SAM2.1's (1, 1, 4096, 256).
The cross-attention to the memory stays an fp32 einsum (its keys are
masked, Nq != Nk), its logits built once per layer over all heads, with the
object-pointer keys excluded from RoPE. The JAX package computes both
attentions with its own fp32 einsum.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.depth_anything import _box, materialize
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.sam2 import (
    SAM2Config, SAM2Image, _attention_module, _conv, _dflt, _feed_forward, _ffn, _lin, _ln,
    config_from_hf_sam2, load_numpy_state_dict, sam2_decode_heads,
    hiera_attention_shapes, sam2_encode_image, sam2_state_dict, sine_pos_embedding, _c2d,
    _lin_sd, _ln_sd, _attn_sd, _ffn_sd)
from align3r_tpu_torch.ops.attention import attention, route
from align3r_tpu_torch.utils import hf_weights

NO_OBJ_SCORE = -1024.0


@dataclasses.dataclass(frozen=True)
class SAM2VideoConfig:
    """Video additions over the image SAM2Config (HF Sam2VideoConfig)."""
    image: SAM2Config = SAM2Config()
    num_maskmem: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    max_object_pointers: int = 16
    enable_occlusion_spatial_embedding: bool = True
    enable_temporal_pos_encoding_for_object_pointers: bool = True
    multimask_output_for_tracking: bool = True
    # memory attention
    ma_hidden_size: int = 256
    ma_num_layers: int = 4
    ma_num_heads: int = 1
    ma_downsample_rate: int = 1
    ma_ff_hidden_size: int = 2048
    ma_rope_theta: float = 10000.0
    ma_rope_feat_sizes: Tuple[int, int] = (64, 64)
    # memory encoder
    me_hidden_size: int = 256
    mem_dim: int = 64
    mask_downsampler_embed_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_downsampler_total_stride: int = 16
    fuser_num_layers: int = 2
    fuser_embed_dim: int = 256
    fuser_intermediate_dim: int = 1024
    fuser_kernel: int = 7
    fuser_padding: int = 3

    @property
    def num_ptr_splits(self) -> int:
        c = self.image.fpn_hidden_size
        return c // self.mem_dim if self.mem_dim < c else 1


# ------------------------------------------------------- 2-D axial RoPE

def rotate_pairwise(x):
    """(-x1, x0) interleaved rotation (pairwise, not half-tensor)."""
    x = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(x.shape[:-2] + (-1,))


def rope_2d_cos_sin(dim: int, end_x: int, end_y: int, theta: float = 10000.0, device=None):
    """Axial 2-D rotary tables, (cos, sin) each (end_x end_y, dim) fp32,
    computed in float64 as the JAX package does (numpy); positions enumerate
    the feature map row-major (x fastest)."""
    assert dim % 4 == 0, "head dim must be divisible by 4 for axial RoPE"
    freqs = 1.0 / theta ** (np.arange(0, dim, 4)[: dim // 4].astype(np.float64) / dim)
    idx = np.arange(end_x * end_y)
    t = np.concatenate([np.outer(idx % end_x, freqs), np.outer(idx // end_x, freqs)], axis=-1)
    t = np.repeat(t, 2, axis=-1)
    return (torch.tensor(np.cos(t), dtype=torch.float32, device=device),
            torch.tensor(np.sin(t), dtype=torch.float32, device=device))


def _rope(x, cos, sin):
    xf = x.float()
    return xf * cos + rotate_pairwise(xf) * sin


def rope_attention(m, q, k, v, cos, sin, num_heads: int, num_k_exclude_rope: int = 0,
                   rope_k_repeat: bool = False, k_valid=None, impl: str = "auto"):
    """Sam2VideoRoPEAttention. q (B, Sq, Cq); k / v (B, Sk, Ckv). The last
    `num_k_exclude_rope` keys (object pointers) skip RoPE. `k_valid` (B, Sk)
    masks padded memory tokens out of the softmax. Without a mask, Sq == Sk
    and no excluded keys (the self-attention), the attention goes through
    the dispatch (`impl`); otherwise it is an fp32 einsum."""
    B, Sq = q.shape[:2]
    qq, kk, vv = _lin(m.q_proj, q), _lin(m.k_proj, k), _lin(m.v_proj, v)
    D = qq.shape[-1] // num_heads

    def heads(t):
        return t.reshape(B, -1, num_heads, D).permute(0, 2, 1, 3)

    qq, kk, vv = heads(qq), heads(kk), heads(vv)
    Sk = kk.shape[2]
    n_rot = Sk - num_k_exclude_rope
    qq = _rope(qq, cos, sin)
    if k_valid is None and num_k_exclude_rope == 0 and Sk == Sq:
        out = attention(qq, _rope(kk, cos, sin), vv.float(), impl)
    else:
        if n_rot > 0:
            cos_k, sin_k = cos, sin
            if rope_k_repeat and n_rot != Sq:
                rep = n_rot // Sq
                cos_k, sin_k = cos.repeat(rep, 1), sin.repeat(rep, 1)
            kk = torch.cat([_rope(kk[:, :, :n_rot], cos_k, sin_k), kk[:, :, n_rot:].float()],
                           dim=2)
        logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk.float()) / math.sqrt(D)
        if k_valid is not None:
            logits = logits.masked_fill(~k_valid[:, None, None, :], -1e30)
        w = torch.softmax(logits, dim=-1)
        del logits
        out = torch.einsum("bhqk,bhkd->bhqd", w, vv.float())
    out = out.permute(0, 2, 1, 3).reshape(B, Sq, num_heads * D)
    return _lin(m.o_proj, out.to(q.dtype))


# ---------------------------------------------------- memory attention

def memory_attention_layer(lp, queries, memory, mem_pos, cos, sin, cfg: SAM2VideoConfig,
                           num_k_exclude_rope: int = 0, k_valid=None, impl: str = "auto"):
    """Pre-LN self-attention, image -> memory cross-attention and a relu MLP."""
    H = cfg.ma_num_heads
    x = _ln(lp.layer_norm1, queries, 1e-5)
    queries = queries + rope_attention(lp.self_attn, x, x, x, cos, sin, H, impl=impl)
    x = _ln(lp.layer_norm2, queries, 1e-5)
    queries = queries + rope_attention(
        lp.cross_attn_image, x, memory + mem_pos, memory, cos, sin, H,
        num_k_exclude_rope=num_k_exclude_rope, rope_k_repeat=True, k_valid=k_valid)
    x = _ln(lp.layer_norm3, queries, 1e-5)
    x = _lin(lp.linear2, F.relu(_lin(lp.linear1, x)))
    return queries + x


def memory_attention(ma, cur_feats, cur_pos, memory, mem_pos, cfg: SAM2VideoConfig,
                     num_obj_ptr_tokens: int = 0, k_valid=None, impl: str = "auto"):
    """Sam2VideoMemoryAttention, batch first: cur_feats / cur_pos (B, S, C);
    memory / mem_pos (B, M, mem_dim)."""
    cos, sin = rope_2d_cos_sin(cfg.ma_hidden_size // (cfg.ma_downsample_rate * cfg.ma_num_heads),
                               *cfg.ma_rope_feat_sizes, cfg.ma_rope_theta,
                               device=cur_feats.device)
    x = cur_feats + 0.1 * cur_pos
    for lp in ma.layers:
        x = memory_attention_layer(lp, x, memory, mem_pos, cos, sin, cfg,
                                   num_k_exclude_rope=num_obj_ptr_tokens, k_valid=k_valid,
                                   impl=impl)
    return _ln(ma.layer_norm, x, 1e-5)


# ------------------------------------------------------ memory encoder

def memory_fuser_block(lp, x, cfg: SAM2VideoConfig):
    """ConvNeXt-style CX block (NHWC): depthwise 7x7, LN, pointwise MLP with
    GELU, layer scale, residual."""
    r = _conv(lp.depthwise_conv, x)
    r = _ln(lp.layer_norm, r, 1e-6)
    r = _lin(lp.pointwise_conv2, L.gelu(_lin(lp.pointwise_conv1, r)))
    return x + lp.scale * r


def mask_downsampler(md, masks, cfg: SAM2VideoConfig):
    """Strided conv + LN + GELU pyramid, then a 1x1 projection. masks (B, H, W, 1)."""
    x = masks
    for lp in md.layers:
        x = L.gelu(_ln(lp.layer_norm, _conv(lp.conv, x), 1e-6))
    return _conv(md.final_conv, x)


def memory_encoder(me, vision_feats, masks, cfg: SAM2VideoConfig):
    """vision_feats (B, h, w, hidden); masks (B, H, W, 1) at image size.
    Returns (features (B, h, w, mem_dim), pos (h, w, mem_dim))."""
    m = mask_downsampler(me.mask_downsampler, masks, cfg)
    x = _conv(me.feature_projection, vision_feats) + m
    for lp in me.memory_fuser.layers:
        x = memory_fuser_block(lp, x, cfg)
    x = _conv(me.projection, x)
    pos = sine_pos_embedding(x.shape[1], x.shape[2], cfg.mem_dim // 2, device=x.device)
    return x, pos


def get_1d_sine_pe(pos, dim: int, temperature: float = 10000.0):
    """pos (...,) -> (..., dim)."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / pe_dim)
    v = pos[..., None] / dim_t
    return torch.cat([torch.sin(v), torch.cos(v)], dim=-1)


# --------------------------------------------------------------- model

class SAM2Video(SAM2Image):
    """Sam2VideoModel: the image model's modules and the memory ones."""

    def __init__(self, cfg: SAM2VideoConfig = SAM2VideoConfig()):
        super().__init__(cfg.image)
        self.vcfg = cfg
        C, md = cfg.image.fpn_hidden_size, cfg.mem_dim
        Cm = cfg.ma_hidden_size
        ds = Cm // cfg.ma_downsample_rate
        self.memory_attention = _box(
            layers=nn.ModuleList(_box(
                self_attn=_attention_module(Cm, ds),
                cross_attn_image=_box(q_proj=nn.Linear(Cm, ds), k_proj=nn.Linear(md, ds),
                                      v_proj=nn.Linear(md, ds), o_proj=nn.Linear(ds, Cm)),
                linear1=nn.Linear(Cm, cfg.ma_ff_hidden_size),
                linear2=nn.Linear(cfg.ma_ff_hidden_size, Cm),
                layer_norm1=nn.LayerNorm(Cm), layer_norm2=nn.LayerNorm(Cm),
                layer_norm3=nn.LayerNorm(Cm)) for _ in range(cfg.ma_num_layers)),
            layer_norm=nn.LayerNorm(Cm))
        n_ds = int(math.log2(cfg.mask_downsampler_total_stride)
                   / math.log2(cfg.mask_downsampler_stride))
        s, k, p = (cfg.mask_downsampler_stride, cfg.mask_downsampler_kernel,
                   cfg.mask_downsampler_padding)
        chans = [s ** (2 * i) for i in range(n_ds + 1)]
        Ce, Cf = cfg.me_hidden_size, cfg.fuser_embed_dim
        self.memory_encoder = _box(
            mask_downsampler=_box(
                layers=nn.ModuleList(_box(conv=nn.Conv2d(chans[i], chans[i + 1], k, stride=s,
                                                         padding=p),
                                          layer_norm=nn.LayerNorm(chans[i + 1]))
                                     for i in range(n_ds)),
                final_conv=nn.Conv2d(chans[-1], cfg.mask_downsampler_embed_dim, 1)),
            feature_projection=nn.Conv2d(Ce, Ce, 1),
            memory_fuser=_box(layers=nn.ModuleList(_box(
                depthwise_conv=nn.Conv2d(Cf, Cf, cfg.fuser_kernel, padding=cfg.fuser_padding,
                                         groups=Cf),
                layer_norm=nn.LayerNorm(Cf),
                pointwise_conv1=nn.Linear(Cf, cfg.fuser_intermediate_dim),
                pointwise_conv2=nn.Linear(cfg.fuser_intermediate_dim, Cf),
                scale=nn.Parameter(torch.ones(Cf))) for _ in range(cfg.fuser_num_layers))),
            projection=nn.Conv2d(Ce, md, 1))
        self.memory_temporal_positional_encoding = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, md))
        self.no_memory_positional_encoding = nn.Parameter(torch.zeros(1, 1, C))
        self.no_object_pointer = nn.Parameter(torch.zeros(1, C))
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)
        self.object_pointer_proj = _feed_forward(C, C, C, 3)
        if cfg.enable_temporal_pos_encoding_for_object_pointers:
            self.temporal_positional_encoding_projection_layer = nn.Linear(C, md)
        if cfg.enable_occlusion_spatial_embedding:
            self.occlusion_spatial_embedding_parameter = nn.Parameter(torch.zeros(1, md))


# -------------------------------------------------------- memory bank

@dataclasses.dataclass
class MemoryBank:
    """Fixed-capacity tracking state (one object, forward tracking).

    cond_feat    (K, B, HW, mem_dim)  conditioning-frame spatial memories
    cond_valid   (K,) bool
    cond_count   int   conditioning frames inserted so far
    recent_feat  (R, B, HW, mem_dim)  recent[r] = the frame at offset r + 1
    recent_valid (R,) bool
    ptr          (P, B, C)  object pointers (circular over all frames)
    ptr_frame    (P,) int32 absolute frame index of each pointer
    ptr_valid    (P,) bool
    ptr_is_cond  (P,) bool  cond pointers ignore the recency window
    ptr_count    int
    """
    cond_feat: torch.Tensor
    cond_valid: torch.Tensor
    cond_count: int
    recent_feat: torch.Tensor
    recent_valid: torch.Tensor
    ptr: torch.Tensor
    ptr_frame: torch.Tensor
    ptr_valid: torch.Tensor
    ptr_is_cond: torch.Tensor
    ptr_count: int


def init_memory_bank(cfg: SAM2VideoConfig, batch: int, hw: int, num_cond_slots: int = 1,
                     device=None) -> MemoryBank:
    R, P, C = cfg.num_maskmem - 1, cfg.max_object_pointers, cfg.image.fpn_hidden_size
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    f = lambda n: torch.zeros(n, dtype=torch.bool, device=device)
    return MemoryBank(
        cond_feat=z(num_cond_slots, batch, hw, cfg.mem_dim), cond_valid=f(num_cond_slots),
        cond_count=0, recent_feat=z(R, batch, hw, cfg.mem_dim), recent_valid=f(R),
        ptr=z(P, batch, C),
        ptr_frame=torch.full((P,), -10 ** 6, dtype=torch.int32, device=device),
        ptr_valid=f(P), ptr_is_cond=f(P), ptr_count=0)


def _set(t, i, v):
    t = t.clone()
    t[i] = v
    return t


def update_memory_bank(bank: MemoryBank, mem_feat, ptr, frame_idx: int,
                       is_cond: bool) -> MemoryBank:
    """Insert the just-encoded frame: a conditioning frame fills a circular
    cond slot, a tracked one rolls into the recent buffer; both append a
    pointer to the circular pointer buffer."""
    pslot = bank.ptr_count % bank.ptr.shape[0]
    upd = dict(ptr=_set(bank.ptr, pslot, ptr),
               ptr_frame=_set(bank.ptr_frame, pslot, frame_idx),
               ptr_valid=_set(bank.ptr_valid, pslot, True),
               ptr_is_cond=_set(bank.ptr_is_cond, pslot, is_cond),
               ptr_count=bank.ptr_count + 1)
    if is_cond:
        cslot = bank.cond_count % bank.cond_feat.shape[0]
        return dataclasses.replace(bank, cond_feat=_set(bank.cond_feat, cslot, mem_feat),
                                   cond_valid=_set(bank.cond_valid, cslot, True),
                                   cond_count=bank.cond_count + 1, **upd)
    recent = _set(torch.roll(bank.recent_feat, 1, dims=0), 0, mem_feat)
    rvalid = _set(torch.roll(bank.recent_valid, 1, dims=0), 0, True)
    return dataclasses.replace(bank, recent_feat=recent, recent_valid=rvalid, **upd)


def prepare_memory_conditioned_features(model: SAM2Video, cur_feats, cur_pos,
                                        bank: MemoryBank, frame_idx: int, max_ptr_use: int):
    """Cross-attend the current features to the memory bank, fixed shapes.
    cur_feats / cur_pos (B, HW, C); max_ptr_use = min(num_frames, max_ptrs)."""
    cfg = model.vcfg
    B, HW, C = cur_feats.shape
    R, K, D = cfg.num_maskmem - 1, bank.cond_feat.shape[0], cfg.mem_dim
    dev = cur_feats.device
    pos = sine_pos_embedding(*cfg.ma_rope_feat_sizes[::-1], D // 2, device=dev).reshape(HW, D)
    tpe = model.memory_temporal_positional_encoding.reshape(cfg.num_maskmem, 1, D)

    # spatial memory: cond frames (temporal index -1), then the recent ones
    # oldest to newest (offset r + 1 -> temporal index r)
    order = torch.arange(R - 1, -1, -1, device=dev)
    spatial = torch.cat([bank.cond_feat.transpose(0, 1),
                         bank.recent_feat[order].transpose(0, 1)], dim=1)  # (B, K+R, HW, D)
    spos = torch.cat([(pos + tpe[-1])[None].expand(K, HW, D), pos[None] + tpe[order]], dim=0)
    svalid = torch.cat([bank.cond_valid, bank.recent_valid[order]])
    spatial = spatial.reshape(B, (K + R) * HW, D)
    spos = spos[None].expand(B, K + R, HW, D).reshape(B, (K + R) * HW, D)
    svalid = svalid[None, :, None].expand(B, K + R, HW).reshape(B, (K + R) * HW)

    # object pointers: offsets from the current frame; eligible when
    # 0 <= offset (cond) / 1 <= offset <= max_ptr_use - 1 (tracked)
    offsets = (frame_idx - bank.ptr_frame).float()
    pvalid = bank.ptr_valid & (bank.ptr_frame >= 0) & (offsets >= 0)
    pvalid = pvalid & (bank.ptr_is_cond | (offsets <= max_ptr_use - 1))
    if cfg.enable_temporal_pos_encoding_for_object_pointers:
        norm = offsets / float(max(max_ptr_use - 1, 1))
        ppos = _lin(model.temporal_positional_encoding_projection_layer,
                    get_1d_sine_pe(norm, C))
    else:
        ppos = torch.zeros(offsets.shape[0], D, device=dev)
    S, P = cfg.num_ptr_splits, bank.ptr.shape[0]
    ptr = bank.ptr.transpose(0, 1).reshape(B, P * S, D)
    ppos = torch.repeat_interleave(ppos, S, dim=0)[None].expand(B, P * S, D)
    pvalid = torch.repeat_interleave(pvalid, S)[None].expand(B, P * S)

    memory = torch.cat([spatial, ptr], dim=1)
    mem_pos = torch.cat([spos, ppos], dim=1)
    k_valid = torch.cat([svalid, pvalid], dim=1)
    return memory_attention(model.memory_attention, cur_feats, cur_pos, memory, mem_pos, cfg,
                            num_obj_ptr_tokens=P * S, k_valid=k_valid, impl=model.attn_impl)


# ------------------------------------------------------- per-frame step

def encode_new_memory(model: SAM2Video, top_feats, high_res_masks, object_score_logits,
                      is_mask_from_pts: bool):
    """top_feats (B, h, w, C); high_res_masks (B, H, W, 1) logits at image
    size. Returns (B, HW, mem_dim), rounded through bf16 as HF stores it."""
    cfg = model.vcfg
    m = (high_res_masks > 0).float() if is_mask_from_pts else torch.sigmoid(high_res_masks)
    m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
    feats, _pos = memory_encoder(model.memory_encoder, top_feats, m, cfg)
    if cfg.enable_occlusion_spatial_embedding:
        appearing = (object_score_logits > 0).float()
        feats = feats + ((1.0 - appearing)[:, None, None]
                         * model.occlusion_spatial_embedding_parameter.reshape(1, 1, 1, -1))
    feats = feats.to(torch.bfloat16).float()
    return feats.reshape(feats.shape[0], -1, cfg.mem_dim)


def _object_pointer(model: SAM2Video, sam_tokens, iou, object_score_logits, multimask: bool):
    """SAM output token -> object pointer, mixed with the no-object pointer
    where the object is occluded."""
    tok = sam_tokens[:, 0, 0]
    if multimask and sam_tokens.shape[2] > 1:
        best = torch.argmax(iou[:, 0], dim=-1)
        tok = sam_tokens[torch.arange(tok.shape[0], device=tok.device), 0, best]
    ptr = _ffn(model.object_pointer_proj, tok)
    lam = (object_score_logits > 0).float()  # (B, 1)
    return lam * ptr + (1 - lam) * model.no_object_pointer


def _upsample_to_image(masks, size: int):
    """bilinear, align_corners=False (F.interpolate), to (size, size)."""
    x = masks.reshape((-1, 1) + masks.shape[-2:])
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return x.reshape(masks.shape[:-2] + (size, size))


def _select_best(masks, high_res, iou, multi: bool):
    if not multi:
        return masks[:, :1], high_res[:, :1]
    best = torch.argmax(iou[:, 0], dim=-1)
    b = torch.arange(masks.shape[0], device=masks.device)
    return masks[b, best][:, None], high_res[b, best][:, None]


def sam2_video_frame(model: SAM2Video, pixel_values, bank: MemoryBank, frame_idx: int,
                     num_frames: int, init_mask=None, init_points=None, init_labels=None):
    """One tracking step. `init_mask` (B, H, W, 1) binary at image size marks
    a mask-conditioned frame (mask as output); `init_points` (B, P, N, 2)
    with `init_labels` a point-conditioned frame (no-memory embedding and
    the SAM head with point prompts); tracked frames pass neither. Returns
    (low-res mask logits (B, 1, g4, g4), object_score_logits, updated bank)."""
    cfg = model.vcfg
    img = cfg.image
    s0, s1, top, top_pos = sam2_encode_image(model, pixel_values)
    B, h, w, C = top.shape
    is_cond = init_mask is not None or init_points is not None
    if init_mask is not None and init_points is None:
        # mask as output: +20 / -10 logits, the pointer from the SAM head fed
        # the 4x-downsampled mask prompt on the raw backbone features
        high_res = init_mask * 20.0 - 10.0
        prompt = _conv(model.mask_downsample, init_mask)
        _m, iou, obj, tokens = sam2_decode_heads(model, top, s0, s1, prompt,
                                                 multimask_output=False)
        lam = (init_mask.reshape(B, -1) > 0).any(dim=1, keepdim=True).float()
        obj_logits = 20.0 * lam - 10.0
        ptr = _ffn(model.object_pointer_proj, tokens[:, 0, 0])
        ptr = lam * ptr + (1 - lam) * model.no_object_pointer
        # antialiased bilinear downsample (jax.image.resize "linear")
        low_res = L.resize(high_res[..., 0], img.image_size // 4, img.image_size // 4,
                           "bilinear")[:, None]
    else:
        if init_points is not None:
            # point-conditioned: no-memory embedding, point prompts,
            # multimask with at most one point
            feats = top + model.no_memory_embedding.reshape(1, 1, 1, -1)
            multi = init_points.shape[2] <= 1
            prompts = dict(input_points=init_points, input_labels=init_labels)
        else:
            max_ptr_use = min(num_frames, cfg.max_object_pointers)
            feats = prepare_memory_conditioned_features(
                model, top.reshape(B, h * w, C), top_pos.reshape(B, h * w, C), bank,
                frame_idx, max_ptr_use).reshape(B, h, w, C)
            multi = cfg.multimask_output_for_tracking
            prompts = {}
        masks, iou, obj_logits, tokens = sam2_decode_heads(
            model, feats, s0, s1, None, multimask_output=multi, **prompts)
        obj_logits = obj_logits[:, 0]
        masks = torch.where(obj_logits[:, :, None, None] > 0, masks[:, 0],
                            torch.full_like(masks[:, 0], NO_OBJ_SCORE))
        high_res = _upsample_to_image(masks, img.image_size)
        low_res, high_res = _select_best(masks, high_res, iou, multi)
        ptr = _object_pointer(model, tokens, iou, obj_logits, multi)
        high_res = high_res[:, 0][..., None]

    mem = encode_new_memory(model, top, high_res, obj_logits, is_mask_from_pts=is_cond)
    bank = update_memory_bank(bank, mem, ptr, frame_idx, is_cond=is_cond)
    return low_res, obj_logits, bank


@torch.no_grad()
def propagate_video(model: SAM2Video, frames, seed_masks, num_cond_slots: Optional[int] = None):
    """Track one object through `frames` (T, S, S, 3), SAM2-normalised at the
    model's image size, from binary conditioning masks: one (S, S, 1) mask on
    frame 0, or a dict {frame_idx: (S, S, 1)}. Returns the (T, g4, g4) mask
    logits on the frames' device; frames before the first seed are -10."""
    cfg = model.vcfg
    T = frames.shape[0]
    if not isinstance(seed_masks, dict):
        seed_masks = {0: seed_masks}
    g4 = cfg.image.image_size // 4
    hw = (cfg.image.image_size // 16) ** 2
    K = num_cond_slots if num_cond_slots is not None else max(1, min(len(seed_masks), 8))
    bank = init_memory_bank(cfg, 1, hw, num_cond_slots=K, device=frames.device)
    out = torch.empty(T, g4, g4, device=frames.device)
    start = min(seed_masks)
    out[:start] = -10.0
    for t in range(start, T):
        seed = seed_masks.get(t)
        low, _obj, bank = sam2_video_frame(
            model, frames[t:t + 1], bank, t, T,
            init_mask=None if seed is None else torch.as_tensor(seed, device=frames.device)[None])
        out[t] = low[0, 0]
    return out


SAM2_MEAN = (0.485, 0.456, 0.406)
SAM2_STD = (0.229, 0.224, 0.225)


def preprocess_sam2_frames(images01, size: int, device=None):
    """(T, H, W, 3) in [0, 1] -> normalised (T, size, size, 3) (HF
    Sam2VideoProcessor: bilinear resize, align_corners False, and imagenet
    normalisation)."""
    x = torch.as_tensor(np.asarray(images01, np.float32), device=device)
    x = L.bilinear_resize(x, size, size, align_corners=False)
    mean = torch.tensor(SAM2_MEAN, device=x.device)
    std = torch.tensor(SAM2_STD, device=x.device)
    return (x - mean) / std


def frame_steps(masks: np.ndarray) -> Tuple[int, int]:
    """(frame steps, tracked steps) refine_motion_masks runs for (T, H, W)
    masks: for each parity with a seed, every frame from its first seed on;
    the seeded frames are conditioning steps, the others tracked."""
    T = len(masks)
    steps = tracked = 0
    for parity in (1, 0):
        seeds = [t for t in range(parity, T, 2) if masks[t].any()]
        if seeds:
            steps += T - seeds[0]
            tracked += T - seeds[0] - len(seeds)
    return steps, tracked


def dispatch_counts(cfg: SAM2VideoConfig) -> Tuple[Counter, Counter]:
    """What `ops.attention.route` makes of the dispatched attentions on the
    card, fp32: ({route: count} of one frame step's Hiera trunk, {route:
    count} of one tracked step's memory self-attentions). With
    `frame_steps`, the launches a refinement makes of K6 ("small") and K9
    ("flash")."""
    meta = lambda *s: torch.empty(s, device="meta")
    trunk = Counter(route(meta(n, h, nq, d), meta(n, h, nk, d), meta(n, h, nk, d), True)
                    for n, h, nq, nk, d in hiera_attention_shapes(cfg.image.hiera,
                                                                  cfg.image.image_size))
    heads = cfg.ma_num_heads
    q = meta(1, heads, math.prod(cfg.ma_rope_feat_sizes),
             cfg.ma_hidden_size // (cfg.ma_downsample_rate * heads))
    return trunk, Counter({route(q, q, q, True): cfg.ma_num_layers})


@torch.no_grad()
def refine_motion_masks(model: SAM2Video, images01, masks, num_cond_slots: int = 8):
    """Seed SAM2 video tracking with the motion masks on odd frames and take
    the propagated masks on even frames, then swap the roles; OR the
    propagated masks into the input masks. images01 (T, H, W, 3) in [0, 1];
    masks (T, H, W) bool. Returns the refined (T, H, W) bool, numpy. Runs on
    the model's device."""
    cfg = model.vcfg
    S = cfg.image.image_size
    dev = next(model.parameters()).device
    masks = np.asarray(masks).astype(bool)
    T, H, W = masks.shape
    frames = preprocess_sam2_frames(images01, S, device=dev)
    mt = torch.as_tensor(masks, dtype=torch.float32, device=dev)[..., None]
    refined = torch.as_tensor(masks, device=dev)
    for parity in (1, 0):
        seeds = {t: (L.bilinear_resize(mt[t:t + 1], S, S, align_corners=False)[0] > 0.5).float()
                 for t in range(parity, T, 2) if masks[t].any()}
        if not seeds:
            continue
        logits = propagate_video(model, frames, seeds, num_cond_slots=num_cond_slots)
        ts = [t for t in range(1 - parity, T, 2) if t >= min(seeds)]
        if ts:
            up = L.bilinear_resize(logits[ts][..., None], H, W, align_corners=False)[..., 0]
            refined[ts] |= up > 0
    return refined.cpu().numpy()


# ----------------------------------------------------------- config, weights

def config_from_hf_sam2_video(config: dict) -> SAM2VideoConfig:
    """SAM2VideoConfig from a Sam2VideoModel config.json dict (a key missing
    from the file takes transformers' default)."""
    img = dataclasses.replace(config_from_hf_sam2(config),
                              image_size=_dflt(config, "image_size", 1024))
    d = SAM2VideoConfig()
    g = lambda key, default: _dflt(config, key, default)
    return SAM2VideoConfig(
        image=img, num_maskmem=g("num_maskmem", d.num_maskmem),
        sigmoid_scale_for_mem_enc=g("sigmoid_scale_for_mem_enc", d.sigmoid_scale_for_mem_enc),
        sigmoid_bias_for_mem_enc=g("sigmoid_bias_for_mem_enc", d.sigmoid_bias_for_mem_enc),
        max_object_pointers=g("max_object_pointers_in_encoder", d.max_object_pointers),
        enable_occlusion_spatial_embedding=g("enable_occlusion_spatial_embedding",
                                             d.enable_occlusion_spatial_embedding),
        enable_temporal_pos_encoding_for_object_pointers=g(
            "enable_temporal_pos_encoding_for_object_pointers",
            d.enable_temporal_pos_encoding_for_object_pointers),
        multimask_output_for_tracking=g("multimask_output_for_tracking",
                                        d.multimask_output_for_tracking),
        ma_hidden_size=g("memory_attention_hidden_size", d.ma_hidden_size),
        ma_num_layers=g("memory_attention_num_layers", d.ma_num_layers),
        ma_num_heads=g("memory_attention_num_attention_heads", d.ma_num_heads),
        ma_downsample_rate=g("memory_attention_downsample_rate", d.ma_downsample_rate),
        ma_ff_hidden_size=g("memory_attention_feed_forward_hidden_size", d.ma_ff_hidden_size),
        ma_rope_theta=g("memory_attention_rope_theta", d.ma_rope_theta),
        ma_rope_feat_sizes=tuple(g("memory_attention_rope_feat_sizes", d.ma_rope_feat_sizes)),
        me_hidden_size=g("memory_encoder_hidden_size", d.me_hidden_size),
        mem_dim=g("memory_encoder_output_channels", d.mem_dim),
        mask_downsampler_embed_dim=g("mask_downsampler_embed_dim",
                                     d.mask_downsampler_embed_dim),
        mask_downsampler_kernel=g("mask_downsampler_kernel_size", d.mask_downsampler_kernel),
        mask_downsampler_stride=g("mask_downsampler_stride", d.mask_downsampler_stride),
        mask_downsampler_padding=g("mask_downsampler_padding", d.mask_downsampler_padding),
        mask_downsampler_total_stride=g("mask_downsampler_total_stride",
                                        d.mask_downsampler_total_stride),
        fuser_num_layers=g("memory_fuser_num_layers", d.fuser_num_layers),
        fuser_embed_dim=g("memory_fuser_embed_dim", d.fuser_embed_dim),
        fuser_intermediate_dim=g("memory_fuser_intermediate_dim", d.fuser_intermediate_dim),
        fuser_kernel=g("memory_fuser_kernel_size", d.fuser_kernel),
        fuser_padding=g("memory_fuser_padding", d.fuser_padding))


def load_hf_sam2_video(name_or_path: str, device="cuda"):
    """(SAM2Video, cfg) from a local HF Sam2VideoModel folder or cached hub
    name, on `device` (the card unless "cpu" is asked for)."""
    dev = device_or_raise(device)
    config, sd = hf_weights.load(name_or_path)
    cfg = config_from_hf_sam2_video(config)
    return materialize(lambda: SAM2Video(cfg), sd, dev), cfg


def sam2_video_state_dict(params, cfg: SAM2VideoConfig) -> Dict[str, np.ndarray]:
    """The JAX SAM2 video tree (convert_hf_sam2_video's) under HF keys."""
    sd = sam2_state_dict(params["image"])
    for i, lp in enumerate(params["memory_attention"]["layers"]):
        q = f"memory_attention.layers.{i}"
        sd.update({**_attn_sd(lp["self_attn"], f"{q}.self_attn"),
                   **_attn_sd(lp["cross_attn"], f"{q}.cross_attn_image"),
                   **_lin_sd(lp["fc1"], f"{q}.linear1"), **_lin_sd(lp["fc2"], f"{q}.linear2"),
                   **{k: v for n in (1, 2, 3)
                      for k, v in _ln_sd(lp[f"ln{n}"], f"{q}.layer_norm{n}").items()}})
    sd.update(_ln_sd(params["memory_attention"]["ln"], "memory_attention.layer_norm"))
    me, pfx = params["memory_encoder"], "memory_encoder"
    for i, lp in enumerate(me["mask_downsampler"]["layers"]):
        sd.update({**_c2d(lp["conv"], f"{pfx}.mask_downsampler.layers.{i}.conv"),
                   **_ln_sd(lp["ln"], f"{pfx}.mask_downsampler.layers.{i}.layer_norm")})
    sd.update({**_c2d(me["mask_downsampler"]["final"], f"{pfx}.mask_downsampler.final_conv"),
               **_c2d(me["feature_projection"], f"{pfx}.feature_projection"),
               **_c2d(me["projection"], f"{pfx}.projection")})
    for i, lp in enumerate(me["fuser"]):
        q = f"{pfx}.memory_fuser.layers.{i}"
        sd.update({f"{q}.depthwise_conv.weight":
                   np.asarray(lp["dwconv"]["kernel"]).transpose(3, 2, 0, 1),
                   f"{q}.depthwise_conv.bias": np.asarray(lp["dwconv"]["bias"]),
                   **_ln_sd(lp["ln"], f"{q}.layer_norm"),
                   **_lin_sd(lp["pw1"], f"{q}.pointwise_conv1"),
                   **_lin_sd(lp["pw2"], f"{q}.pointwise_conv2"),
                   f"{q}.scale": np.asarray(lp["scale"])})
    sd.update({"memory_temporal_positional_encoding": np.asarray(params["memory_temporal_pe"]),
               "no_object_pointer": np.asarray(params["no_object_ptr"]),
               **_c2d(params["mask_downsample"], "mask_downsample"),
               **_ffn_sd(params["obj_ptr_proj"], "object_pointer_proj")})
    if cfg.enable_temporal_pos_encoding_for_object_pointers:
        sd.update(_lin_sd(params["tpe_proj"], "temporal_positional_encoding_projection_layer"))
    if cfg.enable_occlusion_spatial_embedding:
        sd["occlusion_spatial_embedding_parameter"] = np.asarray(params["occlusion_embed"])
    return sd


def load_jax_params(model: SAM2Video, params) -> SAM2Video:
    """The JAX parameter tree (convert_hf_sam2_video's) into the port's module."""
    return load_numpy_state_dict(model, sam2_video_state_dict(params, model.vcfg))
