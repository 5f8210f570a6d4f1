"""CroCo transformer blocks (port of align3r_tpu/models/blocks.py).

Three parts:
- ``nn.Module``s whose parameter names are the reference checkpoint keys
  (croco/models/blocks.py: Attention, CrossAttention, Mlp, Block,
  DecoderBlock, PatchEmbed), so a reference ``state_dict`` loads with
  ``load_state_dict(strict=True)``;
- the inference path, as functions on *prepared* weights: per site, the
  matmul weights stacked over a leading stream axis G and stored (in, out) in
  the compute dtype, biases and LayerNorm parameters in fp32. A prepared
  block goes through the fused sites (ops/fused_site.py, kernels K1 and K2);
- the differentiable path of training (JAX blocks.py:112-356), as functions
  on the modules' own parameters so that gradients reach them: attention
  through ops/attention.py (K6 under attn_impl="auto" on the card), or whole
  sites through the differentiable K1/K2 wrappers under attn_impl="fused".
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.rope import apply_rope2d
from align3r_tpu_torch.ops import fused_site as FS
from align3r_tpu_torch.ops.attention import attention
from align3r_tpu_torch.ops.fused_site import attention_site, mlp_site


# ------------------------------------------------------------------ modules

class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)


class CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)


def _ln(dim: int):
    return nn.LayerNorm(dim, eps=1e-6)


class Block(nn.Module):
    """Encoder-style block (also the prior branch's dec_blocks_pc)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


class DecoderBlock(nn.Module):
    """Self-attention + cross-attention (other view as memory) + MLP."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, norm_mem: bool = True):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim)
        self.cross_attn = CrossAttention(dim)
        self.norm2 = _ln(dim)
        self.norm3 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm_y = _ln(dim) if norm_mem else None


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)


# --------------------------------------------------------- prepared weights

def _kernel(lin: nn.Linear, dtype, lo: int = 0, hi: int | None = None):
    """(in, out) kernel of a Linear (optionally rows lo:hi of its output)."""
    return lin.weight[lo:hi].detach().t().to(dtype)


def _bias(lin: nn.Linear, lo: int = 0, hi: int | None = None):
    return lin.bias[lo:hi].detach().float()


def _lnp(ln: nn.LayerNorm):
    return ln.weight.detach().float(), ln.bias.detach().float()


def _stack(sites):
    """Stack per-stream site dicts over a leading G axis (contiguous)."""
    out = {}
    for k in sites[0]:
        if isinstance(sites[0][k], tuple):
            out[k] = tuple(torch.stack([s[k][i] for s in sites]).contiguous()
                           for i in range(len(sites[0][k])))
        else:
            out[k] = torch.stack([s[k] for s in sites]).contiguous()
    return out


def _block_site(b: Block, dtype):
    C = b.norm1.weight.shape[0]
    qkv = b.attn.qkv
    return {
        "ln1": _lnp(b.norm1),
        "wq": _kernel(qkv, dtype, 0, C), "wk": _kernel(qkv, dtype, C, 2 * C),
        "wv": _kernel(qkv, dtype, 2 * C, 3 * C),
        "bq": _bias(qkv, 0, C), "bk": _bias(qkv, C, 2 * C),
        "bv": _bias(qkv, 2 * C, 3 * C),
        "wo": _kernel(b.attn.proj, dtype), "bo": _bias(b.attn.proj),
        "ln2": _lnp(b.norm2),
        "w1": _kernel(b.mlp.fc1, dtype), "b1": _bias(b.mlp.fc1),
        "w2": _kernel(b.mlp.fc2, dtype), "b2": _bias(b.mlp.fc2),
    }


def prepare_block(b: Block, dtype):
    """One Block's weights as a G=1 prepared site dict."""
    return _stack([_block_site(b, dtype)])


def prepare_decoder_layer(b1: DecoderBlock, b2: DecoderBlock, dtype):
    """Decoder layer l of both streams stacked over G=2 (stream 1 =
    dec_blocks[l], stream 2 = dec_blocks2[l]) — the layout the stacked
    decode path runs on (JAX stack_decoder_params, align3r.py:295-330)."""
    def site(b: DecoderBlock):
        s = _block_site(b, dtype)
        s["ln3"] = _lnp(b.norm3)
        ca = b.cross_attn
        s.update({"cq": _kernel(ca.projq, dtype), "ck": _kernel(ca.projk, dtype),
                  "cv": _kernel(ca.projv, dtype), "co": _kernel(ca.proj, dtype),
                  "cbq": _bias(ca.projq), "cbk": _bias(ca.projk),
                  "cbv": _bias(ca.projv), "cbo": _bias(ca.proj)})
        if b.norm_y is not None:
            s["lny"] = _lnp(b.norm_y)
        return s
    return _stack([site(b1), site(b2)])


# ------------------------------------------------------------ apply (fused)

def apply_block_prepared(p, x, pos, num_heads: int, rope_base=100.0):
    """Encoder-style block on prepared weights: x (G, B, N, C), pos (N, 2)."""
    x = attention_site(x, x, p["wq"], p["wk"], p["wv"], p["wo"], p["bq"],
                       p["bk"], p["bv"], p["bo"], pos, num_heads, rope_base,
                       ln_q=p["ln1"], ln_kv="same", residual=True)
    return mlp_site(x, p["w1"], p["b1"], p["w2"], p["b2"], ln=p["ln2"],
                    residual=True)


def apply_decoder_layer_prepared(p, x, pos, num_heads: int, rope_base=100.0):
    """One decoder layer over both streams on prepared weights: x (2, B, N, C). The cross-
    attention memory of each stream is the other stream's pre-layer input
    (JAX blocks.py:283-333)."""
    y = torch.flip(x, dims=(0,))
    x = attention_site(x, x, p["wq"], p["wk"], p["wv"], p["wo"], p["bq"],
                       p["bk"], p["bv"], p["bo"], pos, num_heads, rope_base,
                       ln_q=p["ln1"], ln_kv="same", residual=True)
    x = attention_site(x, y, p["cq"], p["ck"], p["cv"], p["co"], p["cbq"],
                       p["cbk"], p["cbv"], p["cbo"], pos, num_heads, rope_base,
                       ln_q=p["ln2"], ln_kv=p.get("lny"), residual=True)
    return mlp_site(x, p["w1"], p["b1"], p["w2"], p["b2"], ln=p["ln3"],
                    residual=True)


def apply_patch_embed(weight, bias, img, patch_size: int):
    """img (B, H, W, C) NHWC in the compute dtype -> tokens (B, h*w, D).
    The conv output is rounded before the bias is added, as nn.conv2d does."""
    x = F.conv2d(img.permute(0, 3, 1, 2), weight.to(img.dtype), stride=patch_size)
    B, D, h, w = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(B, h * w, D)
    return tokens + bias.to(img.dtype)


# ----------------------------------------------- differentiable (training)

def _lin(lin: nn.Linear, lo: int = 0, hi: int | None = None):
    """(in, out) kernel and bias of a Linear, rows lo:hi of its output."""
    return lin.weight[lo:hi].t(), lin.bias[lo:hi]


def _stream(mods, fn):
    """fn(module) of each stream's module, stacked over a leading G axis."""
    outs = [fn(m) for m in mods]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(t) for t in zip(*outs))
    return torch.stack(outs)


def _lnp(ln: nn.LayerNorm):
    return ln.weight, ln.bias


def _split_heads(x, num_heads):
    *lead, N, C = x.shape
    return x.reshape(-1, N, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x, lead):
    BH, H, N, D = x.shape
    return x.transpose(1, 2).reshape(*lead, N, H * D)


def _attend(q, k, v, qpos, kpos, rope_base, attn_impl):
    """RoPE2D on q and k, then the ops.attention dispatch. q/k/v
    (B, H, N, D), positions (B, N, 2)."""
    if rope_base is not None:
        q = apply_rope2d(q, qpos, rope_base)
        k = apply_rope2d(k, kpos, rope_base)
    return attention(q, k, v, "auto" if attn_impl == "fused" else attn_impl)


def apply_mlp(p: Mlp, x):
    return L.dense(L.gelu(L.dense(x, *_lin(p.fc1))), *_lin(p.fc2))


def apply_attention(p: Attention, x, pos, num_heads: int,
                    rope_base: float | None = 100.0, attn_impl: str = "auto"):
    """Self-attention with RoPE2D on q, k. x (B, N, C); pos (B, N, 2)."""
    q, k, v = (_split_heads(t, num_heads)
               for t in L.dense(x, *_lin(p.qkv)).chunk(3, dim=-1))
    out = _attend(q, k, v, pos, pos, rope_base, attn_impl)
    return L.dense(_merge_heads(out, x.shape[:-2]), *_lin(p.proj))


def apply_cross_attention(p: CrossAttention, query, key, value, qpos, kpos,
                          num_heads: int, rope_base: float | None = 100.0,
                          attn_impl: str = "auto"):
    q = _split_heads(L.dense(query, *_lin(p.projq)), num_heads)
    k = _split_heads(L.dense(key, *_lin(p.projk)), num_heads)
    v = _split_heads(L.dense(value, *_lin(p.projv)), num_heads)
    out = _attend(q, k, v, qpos, kpos, rope_base, attn_impl)
    return L.dense(_merge_heads(out, query.shape[:-2]), *_lin(p.proj))


def _fused_attention(ps, x, y, pos, num_heads, rope_base, ln_q, ln_kv, cross):
    """One site through the differentiable K1 over G = len(ps) streams."""
    C = x.shape[-1]
    if cross:
        ws = [_stream(ps, lambda p, n=n: _lin(getattr(p.cross_attn, n)))
              for n in ("projq", "projk", "projv")]
        wo = _stream(ps, lambda p: _lin(p.cross_attn.proj))
    else:
        ws = [_stream(ps, lambda p, i=i: _lin(p.attn.qkv, i * C, (i + 1) * C))
              for i in range(3)]
        wo = _stream(ps, lambda p: _lin(p.attn.proj))
    (wq, bq), (wk, bk), (wv, bv) = ws
    return FS.attention_site_diff(x, y, wq, wk, wv, wo[0], bq, bk, bv, wo[1],
                                  pos, num_heads, rope_base, ln_q=ln_q,
                                  ln_kv=ln_kv, residual=True)


def _fused_mlp(ps, x, ln):
    w1, b1 = _stream(ps, lambda p: _lin(p.mlp.fc1))
    w2, b2 = _stream(ps, lambda p: _lin(p.mlp.fc2))
    return FS.mlp_site_diff(x, w1, b1, w2, b2, ln=ln, residual=True)


def apply_block(p: Block, x, pos, num_heads: int, rope_base=100.0,
                attn_impl: str = "auto"):
    """Encoder-style block: x (B, N, C), pos (B, N, 2). attn_impl="fused"
    runs the attention and MLP sites through K1/K2 where the JAX gates
    hold, with pos[0] as the grid every row shares."""
    if attn_impl == "fused" and FS.supported(x[None], num_heads):
        x = _fused_attention([p], x[None], x[None], pos[0], num_heads,
                             rope_base, _stream([p], lambda m: _lnp(m.norm1)),
                             "same", cross=False)
        if FS.mlp_supported(x, p.mlp.fc1.out_features):
            return _fused_mlp([p], x, _stream([p], lambda m: _lnp(m.norm2)))[0]
        x = x[0]
        return x + apply_mlp(p.mlp, L.layernorm(x, *_lnp(p.norm2)))
    x = x + apply_attention(p.attn, L.layernorm(x, *_lnp(p.norm1)), pos,
                            num_heads, rope_base, attn_impl)
    return x + apply_mlp(p.mlp, L.layernorm(x, *_lnp(p.norm2)))


def _gdense(x, w, b):
    """Grouped dense: x (G, B, N, D), w (G, D, K) cast to x's dtype."""
    y = torch.einsum("gbnd,gdk->gbnk", x, w.to(x.dtype))
    return y + b.to(x.dtype)[:, None, None]


def _gln(x, scale, bias):
    return L.layernorm(x, scale[:, None, None], bias[:, None, None])


def apply_decoder_block_stacked(ps, x, xpos, num_heads: int, rope_base=100.0,
                                attn_impl: str = "auto"):
    """One decoder layer over both streams at once (JAX blocks.py:283-356).
    ps: the two streams' DecoderBlocks (dec_blocks[l], dec_blocks2[l]);
    x (2, B, N, C); xpos (2, B, N, 2). Each stream's cross-attention memory
    is the other stream's pre-layer input."""
    G, B, N, C = x.shape
    y = torch.flip(x, dims=(0,))
    ln = lambda name: _stream(ps, lambda p: _lnp(getattr(p, name)))
    if attn_impl == "fused" and FS.supported(x, num_heads):
        pos0 = xpos[0, 0]
        x = _fused_attention(ps, x, x, pos0, num_heads, rope_base, ln("norm1"),
                             "same", cross=False)
        x = _fused_attention(ps, x, y, pos0, num_heads, rope_base, ln("norm2"),
                             ln("norm_y") if ps[0].norm_y is not None else None,
                             cross=True)
        if FS.mlp_supported(x, ps[0].mlp.fc1.out_features):
            return _fused_mlp(ps, x, ln("norm3"))
    else:
        flat_pos = xpos.reshape(G * B, N, 2)
        flip_pos = torch.flip(xpos, dims=(0,)).reshape(G * B, N, 2)
        attn_impl = "auto" if attn_impl == "fused" else attn_impl
        h = _gln(x, *ln("norm1"))
        qkv = _gdense(h, *_stream(ps, lambda p: _lin(p.attn.qkv)))
        q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        out = _attend(q, k, v, flat_pos, flat_pos, rope_base, attn_impl)
        x = x + _gdense(_merge_heads(out, (G, B)),
                        *_stream(ps, lambda p: _lin(p.attn.proj)))
        y_ = _gln(y, *ln("norm_y")) if ps[0].norm_y is not None else y
        ca = lambda n: _stream(ps, lambda p: _lin(getattr(p.cross_attn, n)))
        q = _split_heads(_gdense(_gln(x, *ln("norm2")), *ca("projq")), num_heads)
        k = _split_heads(_gdense(y_, *ca("projk")), num_heads)
        v = _split_heads(_gdense(y_, *ca("projv")), num_heads)
        out = _attend(q, k, v, flat_pos, flip_pos, rope_base, attn_impl)
        x = x + _gdense(_merge_heads(out, (G, B)), *ca("proj"))
    h = L.gelu(_gdense(_gln(x, *ln("norm3")),
                       *_stream(ps, lambda p: _lin(p.mlp.fc1))))
    return x + _gdense(h, *_stream(ps, lambda p: _lin(p.mlp.fc2)))
