"""How far a tensor-parallel network drifts from the whole one, layer by layer.

    python -m align3r_tpu_torch.tools.tp_drift [--device cpu] [--n_model 4]
        [--enc_depth 24] [--dec_depth 12] [--grid 18 32] [--frames 8]
        [--out build/tp_drift.json]

Builds VIT_L_512 (depths as given) from seed 0, prepared in bf16, and runs
its encoder blocks on `frames` images' worth of random tokens and its decoder
layers on as many random pairs, twice from the same input: whole (K1/K2 on
the card, their plain versions on the CPU), and as the sum of n_model ranks'
shares (parallel/shardings.py) in this one process, each sublayer's fp32
partials summed in rank order and finished (ops.fused_site.finish), as a
model group computes it. After every layer it reports the share of the
elements whose bf16 values differ and the median relative difference.

The split sums each out-projection and fc2 in another order than the whole
product, so bf16 rounds an element the other way now and then (about one
element in 10^4 a sublayer), and each such element moves the next layer's
LayerNorm, attention and MLP of its token: this measures how fast those
differences spread, which bounds how close the tensor-parallel engine can
come to one rank's output in bf16. Prints one JSON line, written to --out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch


def seeded_model(device, enc_depth: int = 24, dec_depth: int = 12):
    """VIT_L_512 at these depths from seed 0, prepared in bf16 on `device`."""
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import VIT_L_512
    cfg = dataclasses.replace(VIT_L_512, enc_depth=enc_depth, dec_depth=dec_depth)
    with torch.device(device):
        model = Align3R(cfg)
    init_align3r_(model, seed=0)
    return model.prepare(torch.bfloat16, torch.bfloat16, device=device)


def _compare(a, b) -> dict:
    a, b = a.float(), b.float()
    nz = b != 0
    return {"differ": (a != b).float().mean().item(),
            "median_rel": ((a - b).abs()[nz] / b.abs()[nz]).median().item()}


def drift(pm, n_model: int = 4, grid=(18, 32), frames: int = 8, seed: int = 0) -> dict:
    """{"encoder": [per block], "decoder": [per layer]}: each entry the share
    of bf16 elements that differ between the whole and the split run, and
    their median relative difference (module docstring)."""
    from align3r_tpu_torch.models import blocks as B
    from align3r_tpu_torch.models.rope import make_grid_positions
    from align3r_tpu_torch.ops import fused_site as FS
    from align3r_tpu_torch.parallel.shardings import shard_prepared

    cfg, dev = pm.cfg, pm.device
    shares = [shard_prepared(pm, n_model, r) for r in range(n_model)]
    pos = make_grid_positions(*grid, device=dev)
    N = pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def split(steps, x):
        for i in range(len(steps[0])):
            partials = [s[i][0](x) for s in steps]
            total = partials[0]
            for p in partials[1:]:
                total = total + p
            x = FS.finish(total, steps[0][i][1], x.dtype, resid=x)
        return x

    out = {"encoder": [], "decoder": []}
    x = torch.randn(1, frames, N, cfg.enc_embed_dim, generator=gen, device=dev).to(pm.dtype)
    whole, part = x, x
    for layer, p in enumerate(pm.enc_blocks):
        whole = B.apply_block_prepared(p, whole, pos, cfg.enc_num_heads, cfg.effective_rope_base)
        part = split([B.block_steps(s.enc_blocks[layer], part, pos, cfg.enc_num_heads,
                                    cfg.effective_rope_base) for s in shares], part)
        out["encoder"].append(_compare(part, whole))
    f = torch.randn(2, frames, N, cfg.dec_embed_dim, generator=gen, device=dev).to(pm.dtype)
    whole, part = f, f
    for layer, p in enumerate(pm.dec_layers):
        whole = B.apply_decoder_layer_prepared(p, whole, pos, cfg.dec_num_heads,
                                               cfg.effective_rope_base)
        part = split([B.decoder_layer_steps(s.dec_layers[layer], part, pos, cfg.dec_num_heads,
                                            cfg.effective_rope_base) for s in shares], part)
        out["decoder"].append(_compare(part, whole))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n_model", type=int, default=4)
    ap.add_argument("--enc_depth", type=int, default=24)
    ap.add_argument("--dec_depth", type=int, default=12)
    ap.add_argument("--grid", type=int, nargs=2, default=(18, 32))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join("build", "tp_drift.json"))
    a = ap.parse_args(argv)
    pm = seeded_model(a.device, a.enc_depth, a.dec_depth)
    res = {"device": str(pm.device), "n_model": a.n_model, "grid": list(a.grid),
           "frames": a.frames, "enc_depth": a.enc_depth, "dec_depth": a.dec_depth,
           **drift(pm, a.n_model, a.grid, a.frames)}
    if pm.device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
