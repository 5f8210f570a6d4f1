"""Tiny versions of the cells' files, for runs on the CPU in the tests:
the published configurations with every width, depth and size cut down
(the TINY_TEST network, two-layer 128-wide priors, 4 frames of 64 x 128)."""
from __future__ import annotations

import copy

from benchmark.harness import cell

TINY_MODEL = ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', img_size=(64, 64), head_type='dpt', "
              "output_mode='pts3d', depth_mode=('exp', -inf, inf), conf_mode=('exp', 1, inf), "
              "enc_embed_dim=64, enc_depth=4, enc_num_heads=4, dec_embed_dim=48, dec_depth=12, "
              "dec_num_heads=4)")
TINY_NET = {"img_size": [64, 64], "patch_size": 16, "enc_embed_dim": 64, "enc_depth": 4,
            "enc_num_heads": 4, "dec_embed_dim": 48, "dec_depth": 12, "dec_num_heads": 4,
            "mlp_ratio": 4.0, "pos_embed": "RoPE100"}
TINY_VIT = {"model_type": "dinov2", "hidden_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 2, "patch_size": 8, "image_size": 32}


def tiny_config(name):
    cfg = copy.deepcopy(cell.load("configs", name))
    cfg["model"], cfg["network"] = TINY_MODEL, dict(TINY_NET)
    p = cfg["prior"]
    if p["kind"] == "depthpro":
        p.update(patch_model_config=dict(TINY_VIT), image_model_config=dict(TINY_VIT),
                 fov_model_config=dict(TINY_VIT), patch_size=32, image_size=128,
                 scaled_images_feature_dims=[32, 32, 16], intermediate_hook_ids=[1, 0],
                 intermediate_feature_dims=[16, 16], fusion_hidden_size=16)
    else:
        p["backbone_config"].update(hidden_size=128, num_hidden_layers=4, num_attention_heads=2,
                                    image_size=70, out_indices=[1, 2, 3, 4],
                                    out_features=["stage1", "stage2", "stage3", "stage4"])
        p.update(neck_hidden_sizes=[16, 24, 32, 32], fusion_hidden_size=16, head_hidden_size=8,
                 input_short_side=42)
    return cfg


def tiny_cell(name, limits=None):
    """(workload, configuration, traffic) of cell `name`, cut down."""
    wl, _, tr = cell.load_cell(name)
    wl, tr = copy.deepcopy(wl), copy.deepcopy(tr)
    tr.update(frames=4, height=64, width=128, image_size=64, prior_batch=2, engine_batch=4,
              distinct_videos=2)
    wl["check"].update(frames=3, pairs=3, videos=1)
    if tr.get("solve"):
        tr["solve"]["niter"] = 20
        wl["check"]["solve_steps"] = [2, 5, 10]
    if limits is not None:
        wl["check"]["limits"] = limits
    return wl, tiny_config(wl["config"]), tr
