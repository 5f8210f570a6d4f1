"""The Align3R two-view network (port of align3r_tpu/models/align3r.py).

``Align3R`` is an ``nn.Module`` with the reference checkpoint's parameter
names (dust3r/model.py, croco/models/croco.py), so a reference ``.pth``
loads with ``load_state_dict(strict=True)``. Inference runs on a
``PreparedAlign3R``, built once from the module by ``Align3R.prepare``: every
site's matmul weights transposed to (in, out), cast to the compute dtype and
stacked over a stream axis (the two decoder streams of a layer as G=2, the
JAX ``stack_decoder_params`` layout), biases and LayerNorm parameters fp32.

Functions ``encode_images``, ``embed_point_cloud``, ``decode_pair`` and
``apply_align3r`` mirror the JAX ones (the decoder's stacked path).

Training runs ``Align3R.forward`` instead (JAX ``apply_align3r`` with its
``attn_impl``, ``remat`` and ``head_dtype``): the same network on the
module's own parameters, differentiable, with per-block checkpointing. An
encoder whose parameters are all frozen runs under ``torch.no_grad()``, the
counterpart of the pruned encoder backward of the JAX freeze list
(step.py:120-133).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from align3r_tpu_torch.models.config import Align3RConfig
from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models import blocks as B
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.dpt_head import (DPTHead, apply_dpt_head,
                                               dpt_head_params, prepare_dpt_head)
from align3r_tpu_torch.models.rope import make_grid_positions, sincos_pos_embed


class Align3R(nn.Module):
    def __init__(self, cfg: Align3RConfig):
        super().__init__()
        if cfg.head_type != "dpt":
            # as JAX init_align3r: the linear head is models/linear_head.py alone
            raise NotImplementedError(f"head_type={cfg.head_type!r}: Align3R runs DPT heads")
        self.cfg = cfg
        De, Dd = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = B.PatchEmbed(cfg.patch_size, 3, De)
        self.patch_embed_point_cloud = B.PatchEmbed(cfg.patch_size, 3, Dd)
        self.enc_blocks = nn.ModuleList(
            [B.Block(De, cfg.mlp_ratio) for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(De, eps=1e-6)
        self.decoder_embed = nn.Linear(De, Dd)
        self.dec_blocks = nn.ModuleList(
            [B.DecoderBlock(Dd, cfg.mlp_ratio, cfg.norm_im2_in_dec)
             for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [B.DecoderBlock(Dd, cfg.mlp_ratio, cfg.norm_im2_in_dec)
             for _ in range(cfg.dec_depth)])
        self.dec_blocks_pc = nn.ModuleList(
            [B.Block(Dd, cfg.mlp_ratio) for _ in range(cfg.n_pc_blocks)])
        self.dec_norm = nn.LayerNorm(Dd, eps=1e-6)
        self.zero_convs = nn.ModuleList(
            [nn.Sequential(nn.Conv1d(Dd, Dd, 1)) for _ in range(cfg.n_zero_convs)])
        nch = 3 + (1 if cfg.conf_mode is not None else 0)
        self.downstream_head1 = DPTHead(cfg.dpt_dim_tokens(), nch)
        self.downstream_head2 = DPTHead(cfg.dpt_dim_tokens(), nch)

    def forward(self, view1, view2, dtype=torch.bfloat16, attn_impl: str = "auto",
                remat: str = "full", head_dtype=torch.float32):
        """Differentiable two-view forward (JAX apply_align3r,
        align3r.py:335-371). view*: {'img' (B, H, W, 3), 'pred_depth'
        (B, H, W, 3)} on the model's device. attn_impl: 'auto' | 'xla' |
        'small' | 'fused' (ops/attention.py, blocks.py); remat: 'none' |
        'full' | 'dots' (see _ckpt). Returns (res1{pts3d, conf},
        res2{pts3d_in_other_view, conf}) in fp32."""
        cfg = self.cfg
        img1, img2 = view1["img"], view2["img"]
        Bn, H, W, _ = img1.shape
        ps = cfg.patch_size
        pos = make_grid_positions(H // ps, W // ps, batch=2 * Bn, device=img1.device)
        encoder = [self.patch_embed, *self.enc_blocks, self.enc_norm]
        frozen = not any(t.requires_grad for m in encoder for t in m.parameters())
        with torch.no_grad() if frozen else contextlib.nullcontext():
            x = B.apply_patch_embed(self.patch_embed.proj.weight,
                                    self.patch_embed.proj.bias,
                                    torch.cat([img1, img2]).to(dtype), ps)
            x = _add_cosine(cfg, x, pos, cfg.enc_embed_dim)
            block = _ckpt(functools.partial(
                B.apply_block, num_heads=cfg.enc_num_heads,
                rope_base=cfg.effective_rope_base, attn_impl=attn_impl),
                "none" if frozen else remat)
            for blk in self.enc_blocks:
                x = block(blk, x, pos)
            feats = L.layernorm(x, self.enc_norm.weight, self.enc_norm.bias).float()
        pe = self.patch_embed_point_cloud.proj
        pc = B.apply_patch_embed(pe.weight, pe.bias, torch.cat(
            [view1["pred_depth"], view2["pred_depth"]]).to(dtype), ps)
        hooks1, hooks2 = self._decode(feats[:Bn], feats[Bn:], pc, pos, dtype,
                                      attn_impl, remat)
        grid = (H // ps, W // ps)
        res1, res2 = (apply_dpt_head(dpt_head_params(h, head_dtype), hk, grid,
                                     (H, W), cfg.depth_mode, cfg.conf_mode,
                                     head_dtype)
                      for h, hk in ((self.downstream_head1, hooks1),
                                    (self.downstream_head2, hooks2)))
        res2["pts3d_in_other_view"] = res2.pop("pts3d")
        return res1, res2

    def _decode(self, feat1, feat2, pc, pos, dtype, attn_impl, remat):
        """The stacked dual-stream decoder with prior injection (JAX
        decode_pair, align3r.py:165-282) -> per-view hook lists in fp32."""
        cfg = self.cfg
        hooks = cfg.dpt_hooks()
        Bn = feat1.shape[0]
        rb = cfg.effective_rope_base

        def zero_conv(i, t):
            conv = self.zero_convs[i][0]
            return L.dense(t, conv.weight[:, :, 0].t(), conv.bias)

        de = self.decoder_embed
        f1 = _add_cosine(cfg, L.dense(feat1.to(dtype), de.weight.t(), de.bias),
                         pos[:Bn], cfg.dec_embed_dim)
        f2 = _add_cosine(cfg, L.dense(feat2.to(dtype), de.weight.t(), de.bias),
                         pos[Bn:], cfg.dec_embed_dim)
        f1 = f1 + zero_conv(0, pc[:Bn])
        f2 = f2 + zero_conv(0, pc[Bn:])
        f = torch.stack([f1, f2])                              # (2, B, N, D)
        pos_s = torch.stack([pos[:Bn], pos[Bn:]])              # (2, B, N, 2)
        dec = _ckpt(functools.partial(B.apply_decoder_block_stacked,
                                      num_heads=cfg.dec_num_heads, rope_base=rb,
                                      attn_impl=attn_impl), remat)
        pc_block = _ckpt(functools.partial(B.apply_block, num_heads=cfg.dec_num_heads,
                                           rope_base=rb, attn_impl=attn_impl), remat)
        captured = {}
        for layer in range(cfg.dec_depth):
            f = dec((self.dec_blocks[layer], self.dec_blocks2[layer]), f, pos_s)
            if layer < cfg.n_pc_blocks:
                pc = pc_block(self.dec_blocks_pc[layer], pc, pos)
                f = f + zero_conv(layer + 1, pc).reshape(f.shape)
            if layer + 1 in hooks[1:]:
                captured[layer + 1] = f

        def hook_list(enc_feat, s):
            out = [enc_feat.float()]
            out += [captured[h][s].float() for h in hooks[1:-1]]
            out.append(L.layernorm(captured[hooks[-1]][s], self.dec_norm.weight,
                                   self.dec_norm.bias).float())
            return out

        return hook_list(feat1, 0), hook_list(feat2, 1)

    @torch.no_grad()
    def prepare(self, dtype=torch.bfloat16, head_dtype=torch.bfloat16, device="cuda"):
        """The inference weights (see module docstring), built once, on
        `device`: the card unless the caller passes device="cpu". Without
        CUDA, "cuda" raises."""
        dev = device_or_raise(device)
        return _tree_to(self._prepare(dtype, head_dtype), dev)

    def _prepare(self, dtype, head_dtype):
        def dense(lin):
            return lin.weight.detach().t().to(dtype), lin.bias.detach().float()

        def zconv(seq):
            conv = seq[0]
            return conv.weight.detach()[:, :, 0].t().to(dtype), conv.bias.detach().float()

        lnp = lambda ln: (ln.weight.detach().float(), ln.bias.detach().float())
        pe = lambda m: (m.proj.weight.detach().to(dtype), m.proj.bias.detach().float())
        return PreparedAlign3R(
            cfg=self.cfg, dtype=dtype, head_dtype=head_dtype,
            patch_embed=pe(self.patch_embed),
            patch_embed_point_cloud=pe(self.patch_embed_point_cloud),
            enc_blocks=[B.prepare_block(b, dtype) for b in self.enc_blocks],
            enc_norm=lnp(self.enc_norm),
            decoder_embed=dense(self.decoder_embed),
            dec_layers=[B.prepare_decoder_layer(b1, b2, dtype)
                        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2)],
            pc_blocks=[B.prepare_block(b, dtype) for b in self.dec_blocks_pc],
            dec_norm=lnp(self.dec_norm),
            zero_convs=[zconv(z) for z in self.zero_convs],
            head1=prepare_dpt_head(self.downstream_head1, head_dtype),
            head2=prepare_dpt_head(self.downstream_head2, head_dtype),
        )


def _tree_to(tree, dev):
    """Move every tensor of a prepared-weights tree (PreparedAlign3R, dicts,
    lists, tuples) to `dev`; tensors already there are kept, not copied."""
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, PreparedAlign3R):
        return dataclasses.replace(tree, **{f.name: _tree_to(getattr(tree, f.name), dev)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree


@dataclasses.dataclass
class PreparedAlign3R:
    cfg: Align3RConfig
    dtype: torch.dtype
    head_dtype: torch.dtype
    patch_embed: Tuple[torch.Tensor, torch.Tensor]
    patch_embed_point_cloud: Tuple[torch.Tensor, torch.Tensor]
    enc_blocks: List[Dict[str, Any]]
    enc_norm: Tuple[torch.Tensor, torch.Tensor]
    decoder_embed: Tuple[torch.Tensor, torch.Tensor]
    dec_layers: List[Dict[str, Any]]
    pc_blocks: List[Dict[str, Any]]
    dec_norm: Tuple[torch.Tensor, torch.Tensor]
    zero_convs: List[Tuple[torch.Tensor, torch.Tensor]]
    head1: Dict[str, Any]
    head2: Dict[str, Any]

    @property
    def device(self):
        return self.patch_embed[0].device


def _dots_policy():
    """Selective checkpointing that saves the outputs of weight matmuls
    (aten.mm / addmm: products without batch dimensions) and recomputes the
    rest, batched attention and grouped-stream products included: the
    counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _ckpt(fn, remat):
    """Per-block rematerialisation (JAX _ckpt, align3r.py:84-96): 'none'
    saves every activation; 'full' recomputes the whole block in the backward
    (torch.utils.checkpoint, non-reentrant); 'dots' saves the weight-matmul
    outputs only (_dots_policy)."""
    from torch.utils.checkpoint import checkpoint
    if remat in (False, None, "none"):
        return fn
    if remat in (True, "full"):
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_policy)
    raise ValueError(f"unknown remat mode {remat!r}")


@torch.no_grad()
def init_align3r_(model: Align3R, seed: int = 0) -> Align3R:
    """Seeded random init with the JAX init_align3r distributions: Linear
    xavier-uniform with zero bias, LayerNorm (1, 0), convs U(+-1/sqrt(fan_in))
    with zero bias, zero convs all zero. Returns the model."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def uniform_(t, a):
        t.copy_((torch.rand(t.shape, generator=gen, device=dev) * 2 - 1) * a)

    zero = {id(m) for z in model.zero_convs for m in z.modules()}
    for m in model.modules():
        if isinstance(m, nn.Linear):
            uniform_(m.weight, math.sqrt(6.0 / (m.in_features + m.out_features)))
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            if id(m) in zero:
                nn.init.zeros_(m.weight)
            else:
                uniform_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.ConvTranspose2d):
            uniform_(m.weight, 1.0 / math.sqrt(m.in_channels))
            nn.init.zeros_(m.bias)
    return model


# ------------------------------------------------------------------ forward

def _add_cosine(cfg, x, pos, dim: int):
    """pos_embed='cosine': x plus the sin-cos table of its token positions,
    cast to x's dtype (JAX align3r.py:111-113, :163-166); the attention
    sites then run without RoPE (identity tables). Other configs: x."""
    if cfg.pos_embed != "cosine":
        return x
    return x + sincos_pos_embed(pos, dim).to(x.dtype)


def _grid_pos(pm: PreparedAlign3R, H: int, W: int, device):
    p = pm.cfg.patch_size
    return make_grid_positions(H // p, W // p, device=device)


def encode_images(pm: PreparedAlign3R, imgs):
    """imgs (B, H, W, 3) NHWC landscape -> tokens (B, N, D_enc) fp32."""
    cfg = pm.cfg
    Bn, H, W, _ = imgs.shape
    x = B.apply_patch_embed(*pm.patch_embed, imgs.to(pm.dtype), cfg.patch_size)
    pos = _grid_pos(pm, H, W, imgs.device)
    x = _add_cosine(cfg, x, pos, cfg.enc_embed_dim)[None]
    for p in pm.enc_blocks:
        x = B.apply_block_prepared(p, x, pos, cfg.enc_num_heads, cfg.effective_rope_base)
    return L.layernorm(x[0], *pm.enc_norm).float()


def embed_point_cloud(pm: PreparedAlign3R, prior_pc):
    """Patch-embed the normalised prior pointclouds (B, H, W, 3)."""
    return B.apply_patch_embed(*pm.patch_embed_point_cloud,
                               prior_pc.to(pm.dtype), pm.cfg.patch_size)


def decode_pair(pm: PreparedAlign3R, feat1, feat2, pc_tokens, grid_hw):
    """Dual cross-attending decoder with prior injection, both streams
    stacked (G=2) per layer. feat1/feat2 (B, N, D_enc) encoder tokens;
    pc_tokens (2B, N, D_dec) prior tokens for [view1; view2]. Returns per
    view the hook list [enc_out, dec_6, dec_9, dec_norm(dec_12)] in fp32."""
    cfg = pm.cfg
    dt = pm.dtype
    hooks = cfg.dpt_hooks()
    Bn = feat1.shape[0]
    pos = make_grid_positions(*grid_hw, device=feat1.device)
    # the sin-cos tables go on the decoder streams, not on the prior tokens
    f1 = _add_cosine(cfg, L.dense(feat1.to(dt), *pm.decoder_embed), pos, cfg.dec_embed_dim)
    f2 = _add_cosine(cfg, L.dense(feat2.to(dt), *pm.decoder_embed), pos, cfg.dec_embed_dim)
    pc = pc_tokens.to(dt)
    f1 = f1 + L.dense(pc[:Bn], *pm.zero_convs[0])
    f2 = f2 + L.dense(pc[Bn:], *pm.zero_convs[0])
    f = torch.stack([f1, f2])                                  # (2, B, N, D)
    pcs = pc[None]                                             # (1, 2B, N, D)
    captured = {}
    for layer in range(cfg.dec_depth):
        f = B.apply_decoder_layer_prepared(pm.dec_layers[layer], f, pos,
                                          cfg.dec_num_heads,
                                          cfg.effective_rope_base)
        if layer < cfg.n_pc_blocks:
            pcs = B.apply_block_prepared(pm.pc_blocks[layer], pcs, pos,
                                cfg.dec_num_heads, cfg.effective_rope_base)
            inj = L.dense(pcs[0], *pm.zero_convs[layer + 1])
            f = f + inj.reshape(f.shape)
        if layer + 1 in hooks[1:]:
            captured[layer + 1] = f

    def hook_list(enc_feat, s):
        out = [enc_feat.float()]
        for h in hooks[1:-1]:
            out.append(captured[h][s].float())
        out.append(L.layernorm(captured[hooks[-1]][s], *pm.dec_norm).float())
        return out

    return hook_list(feat1, 0), hook_list(feat2, 1)


def decode_heads(pm: PreparedAlign3R, hooks1, hooks2, img_hw, conv_impl: str = "xla"):
    """Both DPT heads on the decoder hooks -> (res1, res2) fp32 dicts.
    conv_impl: "xla" | "pipeline" (models/dpt_head.py)."""
    cfg = pm.cfg
    H, W = img_hw
    grid = (H // cfg.patch_size, W // cfg.patch_size)
    res1 = apply_dpt_head(pm.head1, hooks1, grid, img_hw, cfg.depth_mode,
                          cfg.conf_mode, pm.head_dtype, conv_impl)
    res2 = apply_dpt_head(pm.head2, hooks2, grid, img_hw, cfg.depth_mode,
                          cfg.conf_mode, pm.head_dtype, conv_impl)
    return res1, res2


@torch.no_grad()
def apply_align3r(pm: PreparedAlign3R, view1, view2):
    """Full two-view forward. view*: {'img' (B, H, W, 3), 'pred_depth'
    (B, H, W, 3)}. Returns (res1{pts3d, conf}, res2{pts3d_in_other_view,
    conf}); view2's points are in view1's camera frame."""
    img1, img2 = view1["img"], view2["img"]
    Bn, H, W, _ = img1.shape
    feats = encode_images(pm, torch.cat([img1, img2]))
    pc = embed_point_cloud(pm, torch.cat([view1["pred_depth"],
                                          view2["pred_depth"]]))
    grid = (H // pm.cfg.patch_size, W // pm.cfg.patch_size)
    hooks1, hooks2 = decode_pair(pm, feats[:Bn], feats[Bn:], pc, grid)
    res1, res2 = decode_heads(pm, hooks1, hooks2, (H, W))
    res2["pts3d_in_other_view"] = res2.pop("pts3d")
    return res1, res2
