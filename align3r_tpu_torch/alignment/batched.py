"""Batched multi-scene alignment: S same-shape scenes in one solve (port of
align3r_tpu/alignment/batched.py).

The JAX package vmaps its whole Adam scan over scenes. Here the per-scene
loss is vmapped (``torch.func.vmap``, :func:`vmap_scenes`) over the stacked
parameters and observations, and the single-scene solve (``scene.solve``,
``scene.solve_in_phases``) differentiates the sum of the S losses, which
gives each scene its own gradient. Every iteration is one set of launches
for all S scenes: the stacked parameters move through one batched Adam
update (``scene.adam_update`` over a leading scene axis), and the fused
pairwise term runs K3 and K4 once with a scene axis (``EdgeLoss``'s vmap
rule, ops/edge_loss.py). Any per-scene ``loss_fn`` of the single-scene solve
serves, ``flow.flow_forward`` with its step-gated flow term included: the
step index is one host integer for every scene.

Scenes share one ``SceneConfig`` (image shape, image and edge counts); their
graphs, observations and parameters may differ. The packed observations of
the S scenes are assembled by one K5 launch (:func:`pack_scenes`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from align3r_tpu_torch.alignment.scene import (SceneConfig, SceneData, pack_observations,
                                               pairwise_pts_loss, solve_in_phases,
                                               solve_phases)
from align3r_tpu_torch.alignment.schedules import schedule_array

_FIELDS = [f.name for f in dataclasses.fields(SceneData)]
_PACKED = [k for k in _FIELDS if k.startswith("packed_")]


def stack_scenes(datas: Sequence[SceneData]) -> SceneData:
    """Stack same-shape SceneData along a new leading scene axis (a field
    that is None in one scene must be None in all)."""
    out = {}
    for k in _FIELDS:
        vals = [getattr(d, k) for d in datas]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"SceneData.{k} is set in some scenes only")
            out[k] = None
        else:
            out[k] = torch.stack(vals)
    return SceneData(**out)


def stack_params(params_list: Sequence[Dict]) -> Dict:
    return {k: torch.stack([p[k] for p in params_list]) for k in params_list[0]}


def pack_scenes(datas: Sequence[SceneData], cfg: SceneConfig,
                dtype=torch.bfloat16) -> SceneData:
    """scene.pack_scene for S scenes at once, stacked (scene.
    pack_observations: one K5 launch for every scene's pack)."""
    unpacked = [dataclasses.replace(d, **{k: None for k in _PACKED}) for d in datas]
    return dataclasses.replace(stack_scenes(unpacked),
                               **pack_observations(datas, cfg.n_imgs, dtype))


def vmap_scenes(loss_fn):
    """A per-scene loss_fn(params, data, cfg, step) as one over stacked
    scenes: the S losses, from torch.func.vmap over the stacked parameters
    and observations."""
    template = SceneData(**{k: None for k in _FIELDS})

    def batched_loss(params_s, data_s: SceneData, cfg: SceneConfig, step: int):
        fields = {k: v for k, v in vars(data_s).items() if v is not None}

        def one(params, obs):
            return loss_fn(params, dataclasses.replace(template, **obs), cfg, step)
        return torch.func.vmap(one)(params_s, fields)
    return batched_loss


def batched_alignment(params_list, masks_list, datas, cfg: SceneConfig,
                      lr: float = 0.01, niter: int = 300,
                      schedule: str = "cosine", lr_min: float = 1e-6,
                      loss_fn=pairwise_pts_loss, precision: str = "mixed"):
    """Solve S same-shape scenes together (JAX batched.py:51-99).

    precision as in scene.solve_phases, cfg.fast_solve aside (JAX's batched
    solve ignores it): 'mixed' (default) the first 80% of the iterations
    through K3/K4 on a bf16 pack of every scene, then an fp32 repack,
    continuing the same Adam moments and the global step index; 'bf16' all
    on the bf16 pack; 'fp32' the plain fp32 loss. Returns (list of S solved
    parameter dicts, losses (S, niter) numpy)."""
    phases = solve_phases(niter, dataclasses.replace(cfg, fast_solve=False), precision)
    # the solve's fp32 products must stay fp32 (no TF32 on the card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def pack(dtype):
        return stack_scenes(datas) if dtype is None else pack_scenes(datas, cfg, dtype)
    params_s, losses = solve_in_phases(
        stack_params(params_list), stack_params(masks_list), pack,
        schedule_array(schedule, niter, lr, lr_min), phases, vmap_scenes(loss_fn))
    solved: List[Dict] = [{key: v[z] for key, v in params_s.items()}
                          for z in range(len(datas))]
    return solved, losses.T.cpu().numpy()
