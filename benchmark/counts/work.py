"""The work of one video of a cell, counted from shapes: the reference's
forward passes run on the meta device (no memory, no arithmetic) under a
counting `Precision`, and the kernels' frozen counts at the shapes the path
launches. Nothing here reads the program.
"""
from __future__ import annotations

import functools
import json

import torch

from benchmark.counts import kernels as K
from benchmark.reference import align3r as ref_align3r
from benchmark.reference import common as C
from benchmark.reference import priors as ref_priors


def network_hw(traffic):
    """(h, w) of the network's views: long side `image_size`, both sides cut
    to multiples of 16."""
    H, W, S = traffic["height"], traffic["width"], traffic["image_size"]
    w, h = round(W * S / max(W, H)), round(H * S / max(W, H))
    return ((h // 2) * 2 // 16) * 16, ((w // 2) * 2 // 16) * 16


@functools.lru_cache(maxsize=8)
def _video(cfg_json: str, traffic_json: str):
    cfg, tr = json.loads(cfg_json), json.loads(traffic_json)
    n = tr["frames"]
    pairs = n * (n - 1) if tr["scene_graph"] == "complete" else None
    if pairs is None:
        raise ValueError(f"no count for the scene graph {tr['scene_graph']!r}")
    P = C.Precision()
    meta = torch.device("meta")
    prior = ref_priors.build(cfg["prior"])
    x01 = torch.empty(1, tr["height"], tr["width"], 3, device=meta)
    if cfg["prior"]["kind"] == "depthpro":
        prior.depth_focal(P, x01)
    else:
        prior.depth(P, x01)
    per_frame = dict(P.flops)
    P = C.Precision()
    net = ref_align3r.build(cfg["network"])
    h, w = network_hw(tr)
    net.encode(P, torch.empty(1, h, w, 3, device=meta))
    per_encode = dict(P.flops)
    P = C.Precision()
    net.pairs(P, torch.empty(2, (h // 16) * (w // 16), cfg["network"]["enc_embed_dim"],
                             device=meta), torch.empty(2, h, w, 3, device=meta),
              torch.tensor([0]), torch.tensor([1]), (h, w))
    per_pair = dict(P.flops)
    flops = {}
    for d, times in ((per_frame, n), (per_encode, n), (per_pair, pairs)):
        for k, v in d.items():
            flops[k] = flops.get(k, 0.0) + v * times
    net_cfg = cfg["network"]
    sites = K.engine_sites(n, pairs, tr["engine_batch"], (h // 16) * (w // 16), net_cfg)
    out = {"frames": n, "pairs": pairs, "hw": (h, w), "flops": flops,
           "k1k2_bound_s": sum(K.bound_s(o, b, "bf16") for _, o, b in sites)}
    # K9's fp32 forward on every attention of the prior: operations bound
    out["k9_fp32_bound_s"] = 3.0 * flops.get(("prior", "attn"), 0.0) / K.PEAK["tf32"]
    so = tr.get("solve")
    if so:
        A = h * w
        k_first = int(so["niter"] * cfg["solve"]["first_share"])
        per_it = lambda dt: sum(K.bound_s(*K.edge_loss(2 * pairs, A, n, dt, bwd), "fp32")
                                for bwd in (False, True))
        out["k3k4_bound_s"] = k_first * per_it("bf16") + (so["niter"] - k_first) * per_it("fp32")
    return out


def video(cfg: dict, traffic: dict) -> dict:
    """{frames, pairs, hw, flops {(part, "mm"|"attn"): ops}, k1k2_bound_s,
    k9_fp32_bound_s, k3k4_bound_s (cells that solve)} for one video."""
    return _video(json.dumps(cfg, sort_keys=True), json.dumps(traffic, sort_keys=True))


def least_time_s(cfg: dict, traffic: dict) -> float:
    """One video's products at the chip's peaks, each part in the precision
    the configuration states: bf16 at 989 TFLOP/s, fp32 at 67; the priors'
    attention on K9's 3xTF32, three times its operations at 494.7."""
    v = video(cfg, traffic)
    peak = {"bf16": K.PEAK["bf16"], "fp32": K.PEAK["fp32"]}
    t = 0.0
    for (part, kind), ops in v["flops"].items():
        if part == "prior" and kind == "attn":
            t += 3.0 * ops / K.PEAK["tf32"]
        else:
            t += ops / peak[cfg["precision"][part]]
    return t


def roofline_share(run, names, bound_key):
    """A kernel family's roofline share in % over a traced window: the
    least time of every video's launches (`video(...)[bound_key]`) over the
    time the trace gives the kernels `names`. None where the trace holds
    none of them."""
    tr, n = run.trace, len(run.done())
    if tr is None or not n:
        return None
    t = tr.kernel_seconds(names)
    bound = video(run.cfg, run.traffic).get(bound_key)
    if not t or not bound:
        return None
    return 100.0 * n * bound / t
