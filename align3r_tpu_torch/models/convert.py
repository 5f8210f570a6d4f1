"""Checkpoint conversion (subset of align3r_tpu/models/convert.py).

``load_torch_checkpoint`` reads a reference-format ``.pth`` (the port's
module names are the reference keys, so no layout changes), applying the
reference's ``dec_blocks2`` duplication rule.

``state_dict_from_jax`` mirrors ``export_state_dict`` (convert.py:183) on a
pytree of numpy arrays, without importing jax, and returns torch tensors
keyed by the reference checkpoint names, ready for
``Align3R.load_state_dict(strict=True)``.

Layout transforms (JAX -> reference):
  dense kernel (in, out)        -> Linear weight (out, in)
  conv kernel HWIO              -> Conv2d weight (out, in, kh, kw)
  conv-transpose (in, s, s, out) -> ConvTranspose2d weight (in, out, s, s)
  zero conv (in, out)           -> Conv1d weight (out, in, 1)
  layernorm scale/bias          -> weight/bias
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from align3r_tpu_torch.models.config import Align3RConfig, parse_model_string


def load_torch_checkpoint(path: str, cfg: Align3RConfig | None = None):
    """A reference .pth -> (state_dict, cfg), as the JAX load_torch_checkpoint
    (convert.py:165-178) reads it: cfg from the checkpoint's ``args.model``
    string unless given (args a Namespace, as the reference writes it, or a
    dict, as the port's export_torch_checkpoint does), the ``model`` entry
    (or the whole file) as the state dict, and dec_blocks2 copied from
    dec_blocks when it is absent (reference model.py:114-121). Load the
    result with ``load_state_dict(strict=True)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if cfg is None:
        args = ckpt.get("args")
        model = args.get("model") if isinstance(args, dict) else getattr(args, "model", None)
        cfg = parse_model_string(model) if model else Align3RConfig()
    sd = dict(ckpt.get("model", ckpt))
    if not any(k.startswith("dec_blocks2") for k in sd):
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]
    return sd, cfg


def state_dict_from_jax(params, cfg: Align3RConfig) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}

    def put_linear(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_conv2d(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in p:
            sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_convT(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(0, 3, 1, 2)
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_conv1d(name, p):
        sd[f"{name}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def put_enc_block(pfx, p):
        put_ln(f"{pfx}.norm1", p["norm1"])
        put_linear(f"{pfx}.attn.qkv", p["attn"]["qkv"])
        put_linear(f"{pfx}.attn.proj", p["attn"]["proj"])
        put_ln(f"{pfx}.norm2", p["norm2"])
        put_linear(f"{pfx}.mlp.fc1", p["mlp"]["fc1"])
        put_linear(f"{pfx}.mlp.fc2", p["mlp"]["fc2"])

    def put_dec_block(pfx, p):
        put_enc_block(pfx, p)
        put_ln(f"{pfx}.norm3", p["norm3"])
        if "norm_y" in p:
            put_ln(f"{pfx}.norm_y", p["norm_y"])
        for k in ("projq", "projk", "projv", "proj"):
            put_linear(f"{pfx}.cross_attn.{k}", p["cross_attn"][k])

    put_conv2d("patch_embed.proj", params["patch_embed"]["proj"])
    put_conv2d("patch_embed_point_cloud.proj",
               params["patch_embed_point_cloud"]["proj"])
    for i in range(cfg.enc_depth):
        put_enc_block(f"enc_blocks.{i}", layer(params["enc_blocks"], i))
    put_ln("enc_norm", params["enc_norm"])
    put_linear("decoder_embed", params["decoder_embed"])
    for i in range(cfg.dec_depth):
        put_dec_block(f"dec_blocks.{i}", layer(params["dec_blocks"], i))
        put_dec_block(f"dec_blocks2.{i}", layer(params["dec_blocks2"], i))
    for i in range(cfg.n_pc_blocks):
        put_enc_block(f"dec_blocks_pc.{i}", layer(params["dec_blocks_pc"], i))
    put_ln("dec_norm", params["dec_norm"])
    for i in range(cfg.n_zero_convs):
        put_conv1d(f"zero_convs.{i}.0", layer(params["zero_convs"], i))
    for hk, pfx in (("head1", "downstream_head1.dpt"),
                    ("head2", "downstream_head2.dpt")):
        h = params[hk]
        put_conv2d(f"{pfx}.act_postprocess.0.0", h["act1_conv"])
        put_convT(f"{pfx}.act_postprocess.0.1", h["act1_up"])
        put_conv2d(f"{pfx}.act_postprocess.1.0", h["act2_conv"])
        put_convT(f"{pfx}.act_postprocess.1.1", h["act2_up"])
        put_conv2d(f"{pfx}.act_postprocess.2.0", h["act3_conv"])
        put_conv2d(f"{pfx}.act_postprocess.3.0", h["act4_conv"])
        put_conv2d(f"{pfx}.act_postprocess.3.1", h["act4_down"])
        put_conv2d(f"{pfx}.head.0", h["head_conv1"])
        put_conv2d(f"{pfx}.head.2", h["head_conv2"])
        put_conv2d(f"{pfx}.head.4", h["head_conv3"])
        for k in range(1, 5):
            put_conv2d(f"{pfx}.scratch.layer{k}_rn", h[f"layer{k}_rn"])
            put_conv2d(f"{pfx}.scratch.layer_rn.{k - 1}", h[f"layer{k}_rn"])
            for unit, ours in (("resConfUnit1", "res1"), ("resConfUnit2", "res2")):
                put_conv2d(f"{pfx}.scratch.refinenet{k}.{unit}.conv1",
                           h[f"refinenet{k}"][ours]["conv1"])
                put_conv2d(f"{pfx}.scratch.refinenet{k}.{unit}.conv2",
                           h[f"refinenet{k}"][ours]["conv2"])
            put_conv2d(f"{pfx}.scratch.refinenet{k}.out_conv",
                       h[f"refinenet{k}"]["out_conv"])
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}
