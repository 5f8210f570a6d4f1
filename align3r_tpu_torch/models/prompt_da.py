"""Prompt Depth Anything (PromptDA): prompt-conditioned depth upsampling for
the refine step (port of align3r_tpu/models/prompt_da.py).

Depth Anything's DINOv2 + DPT with a three-conv prompt encoder in every
fusion layer (`neck.fusion_stage.layers.i.prompt_depth_layer`), the prompt
min-max normalised per image outside the network and the sigmoid output
mapped back to the prompt's range. `rescale_depth_maps` refines optimised
low-resolution depths at the frames' own resolution (jax.image.resize's
antialiased bicubic for the images, bilinear for the depths, as the JAX
function resizes them).
"""
from __future__ import annotations

import numpy as np
import torch

from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.depth_anything import (
    DA_V2_LARGE, IMAGENET_MEAN, IMAGENET_STD, DAConfig, DepthAnything, config_from_hf,
    load_jax_params, materialize)
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.utils import hf_weights

__all__ = ["PromptDepthAnything", "load_prompt_da", "load_jax_params", "rescale_depth_maps"]


class PromptDepthAnything(DepthAnything):
    """PromptDepthAnythingForDepthEstimation. forward(pixel_values (B, H, W,
    3) normalised, prompt_depth (B, h, w, 1) metric or None) -> (B, H', W')
    metric depth (relative without a prompt)."""

    def __init__(self, cfg: DAConfig = DA_V2_LARGE):
        super().__init__(cfg, prompt=True)

    def forward(self, pixel_values, prompt_depth=None):
        feats, (ph, pw) = self.features(pixel_values.permute(0, 3, 1, 2))
        if prompt_depth is None:
            return self.decode(feats, ph, pw)
        B = prompt_depth.shape[0]
        flat = prompt_depth.reshape(B, -1)
        dmin = flat.min(dim=1).values[:, None, None]
        dmax = flat.max(dim=1).values[:, None, None]
        prompt = (prompt_depth.permute(0, 3, 1, 2) - dmin[:, None]) / (dmax - dmin)[:, None]
        depth = self.decode(feats, ph, pw, prompt)
        return depth * (dmax - dmin) + dmin


def load_prompt_da(name_or_path: str, device="cuda"):
    """(model, cfg) from a local HF folder or cached hub name, on `device`."""
    dev = device_or_raise(device)
    config, sd = hf_weights.load(name_or_path)
    cfg = config_from_hf(config)
    return materialize(lambda: PromptDepthAnything(cfg), sd, dev), cfg


@torch.inference_mode()
def rescale_depth_maps(model: PromptDepthAnything, images_01, depthmaps,
                       batch: int = 2) -> np.ndarray:
    """Refined depths (n, H, W) at the images' resolution: each image
    (n, H, W, 3) in [0, 1] resized to the patch grid (width round(W / 14) 14),
    the low-resolution depth (n, h, w) as the prompt, the output resized back
    to (H, W) (JAX rescale_depth_maps, reference depth_test.py:535-549)."""
    dev = next(model.parameters()).device
    n, H, W, _ = images_01.shape
    nw = round(W / 14) * 14
    nh = round(H * (nw / W) / 14) * 14
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    out = []
    for s in range(0, n, batch):
        e = min(s + batch, n)
        img = torch.as_tensor(np.asarray(images_01[s:e], np.float32), device=dev)
        img = (L.resize(img, nh, nw, "bicubic") - mean) / std
        pr = torch.as_tensor(np.asarray(depthmaps[s:e], np.float32), device=dev)[..., None]
        d = L.resize(model(img, pr), H, W, "bilinear")
        out.append(d.cpu().numpy())
    return np.concatenate(out)
