"""Seeded weights, made on the device in a few large calls.

A model's parameters (names and shapes from the benchmark's own reference
module) are laid end to end in one flat float32 buffer, drawn by one
`torch.rand` or `torch.randn` call on a generator seeded from --seed, and
scaled and shifted by group (all leaves sharing a scale and an offset form
one contiguous range). The state dict's tensors are views of that buffer:
the program and the reference receive the same numbers. Drawing again from
the same seed on the same device gives the same buffer.

Distributions:
- Align3R: Linear weights uniform +-sqrt(6 / (fan_in + fan_out)), conv
  weights uniform +-1 / sqrt(fan_in) (transposed: +-1 / sqrt(in channels)),
  the prior injection's 1x1 convs a tenth of that, biases 0, LayerNorms
  (1, 0);
- the priors: weights N(0, 1 / fan_in), biases 0, LayerNorms (1, 0), layer
  scales 0.1, class / mask tokens and position embeddings N(0, 0.02), each
  output conv a tenth of that with its bias set (inverse depth near 1, a 60
  degree field of view), so that the priors give positive depths.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

SALT = {"align3r": 1, "prior": 2}


def _leaf_rule(model, name, p, kind):
    """(uniform: bool, scale, offset) of one leaf."""
    mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    mod = model.get_submodule(mod_name) if mod_name else model
    if kind == "align3r":
        if isinstance(mod, nn.LayerNorm):
            return 0.0, 1.0 if leaf == "weight" else 0.0
        if leaf == "bias":
            return 0.0, 0.0
        if isinstance(mod, nn.Linear):
            return math.sqrt(6.0 / (mod.in_features + mod.out_features)), 0.0
        if isinstance(mod, nn.ConvTranspose2d):
            return 1.0 / math.sqrt(mod.in_channels), 0.0
        a = 1.0 / math.sqrt(p[0].numel())
        return (0.1 * a if name.startswith("zero_convs.") else a), 0.0
    out_convs = model.output_convs_names()
    if leaf == "lambda1":
        return 0.0, 0.1
    if leaf in ("cls_token", "mask_token", "position_embeddings"):
        return 0.02, 0.0
    if leaf == "bias":
        return 0.0, out_convs.get(mod_name, 0.0)
    if p.dim() == 1:
        return 0.0, 1.0
    fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
    s = 1.0 / math.sqrt(fan_in)
    return (0.1 * s if mod_name in out_convs else s), 0.0


def make_state(model: nn.Module, kind: str, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """The state dict (every key, aliases included) of `model` (a reference
    module, on any device) drawn from `seed` on `device`."""
    params = list(model.named_parameters())
    rules = [_leaf_rule(model, n, p, kind) for n, p in params]
    order = sorted(range(len(params)), key=lambda i: rules[i])
    offsets, total = {}, 0
    for i in order:
        offsets[i] = total
        total += params[i][1].numel()
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 16 + SALT[kind]) % (2 ** 63 - 1))
    if kind == "align3r":
        flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    else:
        flat = torch.randn(total, generator=gen, device=device)
    k = 0
    while k < len(order):      # one scale and shift per run of equal rules
        r = rules[order[k]]
        lo = offsets[order[k]]
        while k < len(order) and rules[order[k]] == r:
            k += 1
        hi = offsets[order[k]] if k < len(order) else total
        flat[lo:hi].mul_(r[0]).add_(r[1])
    by_id = {id(p): flat[offsets[i]: offsets[i] + p.numel()].view(p.shape)
             for i, (_, p) in enumerate(params)}
    return OrderedDict((n, by_id[id(p)]) for n, p in model.named_parameters(remove_duplicate=False))


def load(module: nn.Module, state) -> nn.Module:
    """`module` (built on the meta device) holding `state`'s tensors
    themselves, checked name by name and shape by shape."""
    module.load_state_dict(state, strict=True, assign=True)
    for p in module.parameters():
        p.requires_grad_(False)
    return module.eval()
