"""Pairwise inference engine (port of align3r_tpu/inference/engine.py:264-471).

1. Every unique image is encoded once (ViT encoder) and every prior
   pointcloud patch-embedded once, in chunks of ``encode_chunk`` images.
2. Pairs are decoded in batches of ``batch_size``: the batch's encoder tokens
   and prior tokens are gathered by index, the dual-stream decoder and both
   DPT heads run on them. The last batch is the ragged tail, run at its own
   size (PyTorch runs eagerly, so no padding to a static shape is needed).

Landscape only (W >= H), as the JAX engine. The output dict follows the
reference contract (engine.py:295-300): view1/view2 {'idx' (E,) int32 numpy},
pred1 {'pts3d' (E, H, W, 3), 'conf' (E, H, W)}, pred2
{'pts3d_in_other_view', 'conf'}, all fp32 tensors on the model's device.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from align3r_tpu_torch.models.align3r import (PreparedAlign3R, decode_heads,
                                              decode_pair, embed_point_cloud,
                                              encode_images)


@torch.no_grad()
def inference(pairs: Sequence[Tuple[int, int]], model: PreparedAlign3R,
              imgs, priors, batch_size: int = 16,
              encode_chunk: int = 16, head_conv_impl: str = "xla") -> Dict:
    """Run the two-view network over a frame graph.

    pairs: (i, j) image-index edges; imgs (n, H, W, 3) normalised images and
    priors (n, H, W, 3) normalised prior pointclouds, tensors or arrays
    (moved to the model's device). Compute dtypes are the prepared model's
    (``model.dtype``, ``model.head_dtype``). head_conv_impl: "xla" or
    "pipeline" (K7/K8 heads, JAX engine.py:270)."""
    # fp32 convolutions (the pinned final head conv, an fp32 engine) must not
    # run in TF32: the reference keeps them in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = model.device
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    priors = torch.as_tensor(priors, dtype=torch.float32, device=dev)
    n, H, W, _ = imgs.shape
    if W < H:
        raise ValueError("engine expects landscape images (pre-transpose portraits)")
    p = model.cfg.patch_size
    grid = (H // p, W // p)

    feats, pc_tok = [], []
    for s in range(0, n, encode_chunk):
        feats.append(encode_images(model, imgs[s:s + encode_chunk]))
        pc_tok.append(embed_point_cloud(model, priors[s:s + encode_chunk]))
    feats = torch.cat(feats)
    pc_tok = torch.cat(pc_tok)

    idx_i = np.array([pr[0] for pr in pairs], np.int32)
    idx_j = np.array([pr[1] for pr in pairs], np.int32)
    ti = torch.as_tensor(idx_i, dtype=torch.long, device=dev)
    tj = torch.as_tensor(idx_j, dtype=torch.long, device=dev)
    outs1, outs2 = [], []
    for s in range(0, len(pairs), batch_size):
        bi, bj = ti[s:s + batch_size], tj[s:s + batch_size]
        pc = torch.cat([pc_tok.index_select(0, bi), pc_tok.index_select(0, bj)])
        hooks1, hooks2 = decode_pair(model, feats.index_select(0, bi),
                                     feats.index_select(0, bj), pc, grid)
        r1, r2 = decode_heads(model, hooks1, hooks2, (H, W), head_conv_impl)
        outs1.append(r1)
        outs2.append(r2)
    res1 = {k: torch.cat([o[k] for o in outs1]) for k in outs1[0]}
    res2 = {k: torch.cat([o[k] for o in outs2]) for k in outs2[0]}
    res2["pts3d_in_other_view"] = res2.pop("pts3d")
    return {"view1": {"idx": idx_i}, "view2": {"idx": idx_j},
            "pred1": res1, "pred2": res2}
