"""2D rotary position embedding, RoPE100 (port of align3r_tpu/models/rope.py).

The head dim is split in two halves: the first is rotated by the token's y
coordinate, the second by its x coordinate; within each half the rotation is
GPT-NeoX style (freqs of length D/4 duplicated, rotate_half = (-x2, x1)).
"""
from __future__ import annotations

import torch


def rope_cos_sin(pos1d, half_dim: int, base: float = 100.0,
                 dtype=torch.float32):
    """cos/sin of shape (..., N, half_dim) for positions (..., N), with the
    frequency layout cat(f, f), f = base^(-2i/half_dim)."""
    D = half_dim
    inv_freq = 1.0 / (base ** (torch.arange(0, D, 2, dtype=torch.float32,
                                            device=pos1d.device) / D))
    freqs = pos1d[..., None].float() * inv_freq
    freqs = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rope_tables(pos, D: int, base: float = 100.0, dtype=torch.float32):
    """(N, D) cos/sin tables for one (N, 2) grid of (y, x) positions:
    the y-half then the x-half."""
    half = D // 2
    cy, sy = rope_cos_sin(pos[..., 0], half, base, dtype)
    cx, sx = rope_cos_sin(pos[..., 1], half, base, dtype)
    return torch.cat([cy, cx], dim=-1), torch.cat([sy, sx], dim=-1)


def rotate_halves(t):
    """rotate_half applied within each D/2 half of the last dim:
    out[:q] = -in[q:2q], out[q:2q] = in[:q] (q = D // 4)."""
    D = t.shape[-1]
    t5 = t.reshape(*t.shape[:-1], 2, 2, D // 4)
    rot = torch.cat([-t5[..., 1:2, :], t5[..., 0:1, :]], dim=-2)
    return rot.reshape(t.shape)


def apply_rope2d(tokens, positions, base: float = 100.0):
    """tokens (B, H, N, D) with D % 4 == 0; positions (B, N, 2) as (y, x)."""
    D = tokens.shape[-1]
    if D % 4:
        raise ValueError(f"head dim {D} must be divisible by 4 for RoPE2D")
    cos, sin = rope_tables(positions, D, base, tokens.dtype)
    return tokens * cos[:, None] + rotate_halves(tokens) * sin[:, None]


def make_grid_positions(h: int, w: int, batch: int | None = None,
                        device=None):
    """Token (y, x) positions for an h x w patch grid, row-major: (h*w, 2)
    or (batch, h*w, 2)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    pos = torch.stack([ys, xs], dim=-1).reshape(h * w, 2).int()
    if batch is not None:
        pos = pos[None].expand(batch, h * w, 2)
    return pos


# ------------------------------------------- sincos tables (pos_embed='cosine')

def sincos_pos_embed_1d(dim: int, pos):
    """MAE-style 1-D sin-cos table at positions `pos` (...,) -> (..., dim)
    fp32 (JAX rope.py:108-115)."""
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float32,
                                           device=pos.device) / (dim / 2.0))
    out = pos.float()[..., None] * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_pos_embed(positions, dim: int):
    """2-D sin-cos table at token positions (..., 2) of (y, x) -> (..., dim)
    fp32: the first half encodes x, the second y (JAX rope.py:118-126)."""
    return torch.cat([sincos_pos_embed_1d(dim // 2, positions[..., 1]),
                      sincos_pos_embed_1d(dim // 2, positions[..., 0])], dim=-1)
