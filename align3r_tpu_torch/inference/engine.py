"""Pairwise inference engine (port of align3r_tpu/inference/engine.py:264-471).

1. Every unique image is encoded once (ViT encoder) and every prior
   pointcloud patch-embedded once, in chunks of ``encode_chunk`` images.
2. Pairs are decoded in batches of ``batch_size``: the batch's encoder tokens
   and prior tokens are gathered by index, the dual-stream decoder and both
   DPT heads run on them. The last batch is the ragged tail, run at its own
   size (PyTorch runs eagerly, so no padding to a static shape is needed).

Data parallelism (``group``, a torch.distributed process group; JAX
engine.py:161-208, :337-380): each rank encodes its slice of every encode
chunk and decodes its slice of every pair batch; the encoder and prior tokens
and the outputs are gathered so that every rank holds the whole result.
The gathers are sums of zero-filled buffers (parallel.mesh.all_gather_sum),
which NCCL and gloo both take on CUDA tensors. Without a group (or in a group
of one) the one rank holds every row and nothing is gathered, whatever
process group is up.

Landscape only (W >= H), as the JAX engine. The output dict follows the
reference contract (engine.py:295-300): view1/view2 {'idx' (E,) int32 numpy},
pred1 {'pts3d' (E, H, W, 3), 'conf' (E, H, W)}, pred2
{'pts3d_in_other_view', 'conf'}, all fp32 tensors on the model's device.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from align3r_tpu_torch.models.align3r import (PreparedAlign3R, decode_heads,
                                              decode_pair, embed_point_cloud,
                                              encode_images)
from align3r_tpu_torch.parallel.mesh import all_gather_sum


def _share(start: int, size: int, end: int, nd: int, r: int) -> Tuple[int, int]:
    """Rank r's rows of the block [start, start + size) (size / nd each),
    clipped to `end`."""
    per = size // nd
    lo = min(start + r * per, end)
    return lo, min(lo + per, end)


@torch.no_grad()
def inference(pairs: Sequence[Tuple[int, int]], model: PreparedAlign3R,
              imgs, priors, batch_size: int = 16,
              encode_chunk: int = 16, head_conv_impl: str = "xla",
              group=None) -> Dict:
    """Run the two-view network over a frame graph.

    pairs: (i, j) image-index edges; imgs (n, H, W, 3) normalised images and
    priors (n, H, W, 3) normalised prior pointclouds, tensors or arrays
    (moved to the model's device). Compute dtypes are the prepared model's
    (``model.dtype``, ``model.head_dtype``). head_conv_impl: "xla" or
    "pipeline" (K7/K8 heads, JAX engine.py:270). group: a process group to
    split the work over (the module docstring); batch_size and encode_chunk
    must be multiples of its size."""
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
    nd = 1 if group is None else dist.get_world_size(group)
    r = 0 if group is None else dist.get_rank(group)
    if batch_size % nd or encode_chunk % nd:
        raise ValueError(f"batch_size={batch_size} and encode_chunk={encode_chunk} "
                         f"must be multiples of the group size {nd}")
    N = grid[0] * grid[1]
    # every rank fills its rows and the sums gather them (exact: one writer a
    # row); the prior tokens go through the sum in fp32
    feats = torch.zeros((n, N, model.cfg.enc_embed_dim), dtype=torch.float32, device=dev)
    pc_tok = torch.zeros((n, N, model.cfg.dec_embed_dim), dtype=torch.float32, device=dev)
    for s in range(0, n, encode_chunk):
        lo, hi = _share(s, encode_chunk, n, nd, r)
        if hi > lo:
            feats[lo:hi] = encode_images(model, imgs[lo:hi])
            pc_tok[lo:hi] = embed_point_cloud(model, priors[lo:hi]).float()
    gather = (lambda t: all_gather_sum(t, group)) if nd > 1 else (lambda t: t)
    feats = gather(feats)
    pc_tok = gather(pc_tok).to(model.dtype)

    idx_i = np.array([pr[0] for pr in pairs], np.int32)
    idx_j = np.array([pr[1] for pr in pairs], np.int32)
    ti = torch.as_tensor(idx_i, dtype=torch.long, device=dev)
    tj = torch.as_tensor(idx_j, dtype=torch.long, device=dev)
    E = len(pairs)
    shapes = {"pts3d": (E, H, W, 3)}
    if model.cfg.conf_mode is not None:
        shapes["conf"] = (E, H, W)
    res1, res2 = ({k: torch.zeros(v, dtype=torch.float32, device=dev)
                   for k, v in shapes.items()} for _ in range(2))
    for s in range(0, E, batch_size):
        lo, hi = _share(s, batch_size, E, nd, r)
        if hi <= lo:
            continue
        bi, bj = ti[lo:hi], tj[lo:hi]
        pc = torch.cat([pc_tok.index_select(0, bi), pc_tok.index_select(0, bj)])
        hooks1, hooks2 = decode_pair(model, feats.index_select(0, bi),
                                     feats.index_select(0, bj), pc, grid)
        for out, part in zip((res1, res2), decode_heads(model, hooks1, hooks2, (H, W),
                                                        head_conv_impl)):
            for k, v in part.items():
                out[k][lo:hi] = v
    for out in (res1, res2):
        for v in out.values():
            gather(v)
    res2["pts3d_in_other_view"] = res2.pop("pts3d")
    return {"view1": {"idx": idx_i}, "view2": {"idx": idx_j},
            "pred1": res1, "pred2": res2}
