"""Linear (pixel-shuffle) prediction head, the DPT head's lightweight
alternative (port of align3r_tpu/models/linear_head.py; the reference's
dust3r/heads/linear_head.py). No released checkpoint uses it, and Align3R
builds DPT heads only, as the JAX init_align3r does.

One fp32 Linear from the last decoder tokens to (3 + conf) P^2 values a
patch, pixel-shuffled to full resolution, cropped to the image, then
optionally the standard postprocess.
"""
from __future__ import annotations

import torch
from torch import nn

from align3r_tpu_torch.models.postprocess import postprocess


class LinearHead(nn.Module):
    """The reference's parameter names: proj.weight (out, in), proj.bias."""

    def __init__(self, dec_embed_dim: int, patch_size: int, has_conf: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(dec_embed_dim, (3 + int(has_conf)) * patch_size ** 2)

    def forward(self, tokens, grid_hw, img_hw, depth_mode=None, conf_mode=None):
        return apply_linear_head(self.proj.weight, self.proj.bias, tokens, grid_hw,
                                 img_hw, self.patch_size, depth_mode, conf_mode)


def apply_linear_head(weight, bias, tokens, grid_hw, img_hw, patch_size: int,
                      depth_mode=None, conf_mode=None):
    """tokens (B, N, D), the last decoder layer; weight (C P^2, D) and bias
    (C P^2,) as nn.Linear stores them; grid_hw = (nh, nw). Returns (B, H, W,
    C) fp32, or the postprocessed dict when depth_mode is given."""
    nh, nw = grid_hw
    H, W = img_hw
    B = tokens.shape[0]
    feat = torch.nn.functional.linear(tokens.float(), weight.float(), bias.float())
    C = feat.shape[-1] // patch_size ** 2
    # pixel shuffle: (B, nh, nw, C, P, P) -> (B, nh P, nw P, C)
    feat = feat.reshape(B, nh, nw, C, patch_size, patch_size)
    feat = feat.permute(0, 1, 4, 2, 5, 3).reshape(B, nh * patch_size, nw * patch_size, C)
    out = feat[:, :H, :W, :]
    if depth_mode is None:
        return out
    return postprocess(out, depth_mode, conf_mode)
