"""Tensor parallelism over a model process group (port of
align3r_tpu/parallel/shardings.py).

The Megatron layout of the JAX package: every transformer block's q/k/v,
cross-attention q/k/v and fc1 split by columns (output features), its proj,
cross-attention proj and fc2 by rows (input features), so a block needs one
all-reduce a sublayer. LayerNorms, the patch embeds, ``decoder_embed``, the
zero convs and the DPT heads are small and stay whole on every rank.

One deviation, pinned by tests/test_torch_tp.py: JAX splits the fused
(C, 3C) ``qkv`` kernel over its 3C axis (shardings.py:34-38), which is not
aligned to heads (at m = 2 rank 0 holds all of q and half of k, and GSPMD
reshards before attention). The port's prepared weights keep q, k and v
apart, so each of them is split by heads: rank r holds the columns of heads
r H / m .. (r + 1) H / m - 1 of q, of k and of v, the layout JAX's own
docstring describes. The outputs agree.

A rank runs its share of a site on the card through K1/K2's launches
(ops/fused_site.py ``attention_partial``, ``mlp_partial``); the model group
sums the fp32 partials and ``finish`` adds the bias and the residual.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

# The split dim of each tensor of a block in the reference checkpoint's
# layout (an nn.Linear weight is (out, in)): 0 splits the output features
# (a column-split kernel), 1 the input features (row-split), None keeps it
# whole. Keyed by the name under "<stack>.<layer>.".
BLOCK_SPECS: Dict[str, Optional[int]] = {
    "norm1.weight": None, "norm1.bias": None, "norm2.weight": None, "norm2.bias": None,
    "attn.qkv.weight": 0, "attn.qkv.bias": 0,
    "attn.proj.weight": 1, "attn.proj.bias": None,
    "mlp.fc1.weight": 0, "mlp.fc1.bias": 0,
    "mlp.fc2.weight": 1, "mlp.fc2.bias": None,
}
DEC_BLOCK_SPECS: Dict[str, Optional[int]] = {
    **BLOCK_SPECS,
    "norm3.weight": None, "norm3.bias": None, "norm_y.weight": None, "norm_y.bias": None,
    **{f"cross_attn.proj{x}.{t}": 0 for x in "qkv" for t in ("weight", "bias")},
    "cross_attn.proj.weight": 1, "cross_attn.proj.bias": None,
}
STACK_SPECS = {"enc_blocks": BLOCK_SPECS, "dec_blocks": DEC_BLOCK_SPECS,
               "dec_blocks2": DEC_BLOCK_SPECS, "dec_blocks_pc": BLOCK_SPECS}

# The prepared site keys (models/blocks.py) and the checkpoint tensors they
# are made of; the LayerNorm pairs (ln1, ln2, ln3, lny) stay whole.
PREPARED_SOURCES = {
    "wq": "attn.qkv.weight", "wk": "attn.qkv.weight", "wv": "attn.qkv.weight",
    "bq": "attn.qkv.bias", "bk": "attn.qkv.bias", "bv": "attn.qkv.bias",
    "wo": "attn.proj.weight", "bo": "attn.proj.bias",
    "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias",
    "cq": "cross_attn.projq.weight", "ck": "cross_attn.projk.weight",
    "cv": "cross_attn.projv.weight", "co": "cross_attn.proj.weight",
    "cbq": "cross_attn.projq.bias", "cbk": "cross_attn.projk.bias",
    "cbv": "cross_attn.projv.bias", "cbo": "cross_attn.proj.bias",
}


def param_specs(names: Iterable[str]) -> Dict[str, Optional[int]]:
    """The split dim of each checkpoint tensor name (JAX
    align3r_param_specs): the block stacks' by their tables, every other
    tensor whole (None)."""
    out = {}
    for name in names:
        stack, _, rest = name.partition(".")
        layer, _, key = rest.partition(".")
        specs = STACK_SPECS.get(stack) if layer.isdigit() else None
        out[name] = None if specs is None else specs[key]
    return out


def check_heads(cfg, n_model: int) -> None:
    """JAX's guard (engine.py:348-356): the model size must divide both head
    counts, or the layout stops being aligned to heads."""
    if cfg.enc_num_heads % n_model or cfg.dec_num_heads % n_model:
        raise ValueError(f"mesh 'model' size {n_model} must divide the head counts "
                         f"({cfg.enc_num_heads} enc / {cfg.dec_num_heads} dec)")


def _shard_site(site: dict, n_model: int, r: int) -> dict:
    """Rank r's share of one prepared site: a prepared weight is (G, in, out),
    so a split of dim 0 (output features) cuts its last axis and one of dim 1
    (input features) the one before; a bias (G, out) is cut on its last."""
    out = {}
    for key, t in site.items():
        dim = DEC_BLOCK_SPECS.get(PREPARED_SOURCES.get(key))
        if dim is None:
            out[key] = t
            continue
        axis = -1 if dim == 0 else -2
        n = t.shape[axis] // n_model
        out[key] = t.narrow(axis, r * n, n).contiguous()
    return out


def shard_prepared(pm, n_model: int, r: int):
    """Rank r's PreparedAlign3R in a model group of n_model: columns
    [r C/m, (r+1) C/m) of wq/wk/wv, bq/bk/bv, cq/ck/cv, cbq/cbk/cbv (each of q,
    k and v by heads) and the matching rows of wo and co; columns
    [r F/m, (r+1) F/m) of w1 and b1 and the matching rows of w2; bo, cbo, b2,
    the LayerNorms and everything outside the blocks whole. The decoder's
    sites keep their stacked G = 2 streams (JAX's dec_blocks_lg stream axis,
    shardings.py:77-103). The result records (n_model, r) as ``tp``."""
    check_heads(pm.cfg, n_model)
    if pm.tp != (1, 0):
        raise ValueError(f"the model is already split {pm.tp[0]} ways (rank {pm.tp[1]})")
    if not 0 <= r < n_model:
        raise ValueError(f"rank {r} is not in a model group of {n_model}")
    if n_model == 1:
        return pm
    return dataclasses.replace(
        pm, enc_blocks=[_shard_site(s, n_model, r) for s in pm.enc_blocks],
        dec_layers=[_shard_site(s, n_model, r) for s in pm.dec_layers],
        pc_blocks=[_shard_site(s, n_model, r) for s in pm.pc_blocks], tp=(n_model, r))


def for_mesh(pm, mesh):
    """pm as this rank's share on `mesh` (parallel.mesh.make_mesh): split
    here when pm is whole, as it is when it was split for this rank."""
    want = (mesh.n_model, mesh.model_rank)
    if pm.tp == want or mesh.n_model == 1 and pm.tp == (1, 0):
        return pm
    if pm.tp != (1, 0):
        raise ValueError(f"the model is split {pm.tp[0]} ways for rank {pm.tp[1]}; this "
                         f"rank of the mesh takes {want[0]} ways, rank {want[1]}")
    return shard_prepared(pm, *want)


def block_bytes(pm) -> int:
    """Bytes of the prepared block weights (encoder, decoder and prior
    branch): what a split divides about by the model size."""
    def size(t):
        return sum(size(x) for x in t) if isinstance(t, tuple) else t.numel() * t.element_size()
    return sum(size(t) for sites in (pm.enc_blocks, pm.dec_layers, pm.pc_blocks)
               for s in sites for t in s.values())
