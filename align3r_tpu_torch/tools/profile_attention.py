"""Profile K6's fp32 forward, K9's fp32 forward and backward and K9's bf16
backward at D = 256 on one GPU, by launch, beside torch's
scaled_dot_product_attention.

    python -m align3r_tpu_torch.tools.profile_attention [--out build/attention_profile.json]
        [--bits build/attention_bits.pt]

K6 fp32 runs at the encoder's training shape (4, 16, 576, 64); K9 fp32 at
the 512x512 training shape (4, 16, 1024, 64), (4, 8, 1024, 128) and
(4, 4, 1024, 256); K9's bf16 backward at (4, 4, 1024, 256). The backwards run
on the plain forward's (o, lse) and a seeded dO. It calls only what every
tree of the port has (``small_attention(q, k, v)``, ``flash_attention_fwd``,
``flash_attention_plain`` and ``flash_attention_bwd(q, k, v, o, lse, do)``),
so a copy of this file profiles an older tree as well. Per variant it
reports:
- the device time: the forwards from a CUDA graph of 20 calls (CUDA
  events); the backwards as the sum of their kernels' device time under
  torch.profiler over 10 calls (and from a CUDA graph), as chip_smoke.py
  times them;
- SDPA's time on the same inputs, timed the same way (its backward alone on
  a retained graph), which the port never calls;
- its bound: bytes at 3.35 TB/s against operations at the tensor cores'
  dense peak, 989 TFLOP/s bf16, or for fp32 three TF32 products per fp32
  product at 494.7 TFLOP/s (3xTF32, the least time of an fp32-accurate route
  on the tensor cores);
- its split by launch under torch.profiler (device ms per call, by kernel
  name) and the largest error against the plain version.
With --bits it also runs, on seeded inputs, the variants whose code K9's
fp32 kernels share or sit beside: K6 bf16 and fp32, K9's bf16 forward and
backward at D = 64, 128 and 256, and K1's attention
launch; it saves their outputs to that file, or, where the file exists
(written by another tree), reports which are bit-identical to it. It prints the card's name and power limit and one JSON line, and writes
the same JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from align3r_tpu_torch.tools.profile_site import graph_ms, split_site

HBM_BYTES_S, PEAK_BF16, PEAK_TF32 = 3.35e12, 989e12, 494.7e12


def bound_ms(nbytes, ops, peak) -> tuple:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def profile_k6_f32(dev, gen) -> dict:
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import small_attention as sa
    B, H, N, D = shape = (4, 16, 576, 64)
    q, k, v = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
    kern = lambda: sa.small_attention(q, k, v)
    lib = lambda: F.scaled_dot_product_attention(q, k, v)
    b, by = bound_ms(4 * B * H * N * D * 4, 3 * 4 * B * H * N * N * D, PEAK_TF32)
    ms = graph_ms(kern, 20)
    sp = split_site("K6 fp32", kern, (("split", "split"), ("attention", "small_attention")), 10,
                    graph=False)
    return {"kernel": "K6 fp32", "shape": str(shape), "ms": ms, "library_ms": graph_ms(lib, 20),
            "bound_ms": b, "bound_by": by, "bound_share": b / ms,
            "split_ms": sp["split_ms"], "kernels_ms": sp["kernels_ms"],
            "max_rel_err": rel_err(kern(), sa.small_attention_plain(q, k, v))}


def profile_k9_bwd_d256(dev, gen) -> dict:
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import flash_attention as fa
    B, H, N, D = shape = (4, 4, 1024, 256)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v)
    kern = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs)
    lib = lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True)
    heads = B * H
    b, by = bound_ms(8 * heads * N * D * 2 + heads * N * 4, 10 * heads * N * N * D, PEAK_BF16)
    sp = split_site("K9 bwd D=256", kern, (("prep", "prep|di"), ("dK/dV", "dkv"), ("dQ", "dq")),
                    10, graph=False)
    ms = sp["kernel_sum_ms"]
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    return {"kernel": "K9 bwd", "shape": str(shape), "ms": ms, "ms_graph": graph_ms(kern, 10),
            "library_ms": split_site("SDPA bwd", lib, (), 10, graph=False)["kernel_sum_ms"],
            "bound_ms": b, "bound_by": by,
            "bound_share": b / ms, "split_ms": sp["split_ms"], "kernels_ms": sp["kernels_ms"],
            "max_rel_err": max(rel_err(a, r) for a, r in zip(kern(), refs))}


def profile_k9_f32(dev, gen, shape) -> list:
    """K9's fp32 forward and backward at `shape`, each beside SDPA, split by
    launch (the split pre-pass, the attention; the pre-pass, dK/dV, dQ)."""
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import flash_attention as fa
    B, H, N, D = shape
    q, k, v, do = (torch.randn(*shape, generator=gen, device=dev) for _ in range(4))
    heads = B * H
    kern = lambda: fa.flash_attention_fwd(q, k, v)
    lib = lambda: F.scaled_dot_product_attention(q, k, v)
    b, by = bound_ms(4 * heads * N * D * 4 + heads * N * 4, 3 * 4 * heads * N * N * D, PEAK_TF32)
    ms = graph_ms(kern, 20)
    sp = split_site("K9 fp32", kern, (("split", "split"), ("attention", "flash_fwd")), 10,
                    graph=False)
    o, lse = fa.flash_attention_plain(q, k, v)
    fwd = {"kernel": "K9 fp32", "shape": str(shape), "ms": ms, "library_ms": graph_ms(lib, 20),
           "bound_ms": b, "bound_by": by, "bound_share": b / ms, "split_ms": sp["split_ms"],
           "kernels_ms": sp["kernels_ms"], "max_rel_err": rel_err(kern()[0], o)}
    kb = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs)
    lb = lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True)
    b, by = bound_ms(8 * heads * N * D * 4 + heads * N * 4, 3 * 10 * heads * N * N * D,
                     PEAK_TF32)
    sp = split_site("K9 fp32 bwd", kb, (("prep", "prep|_di"), ("dK/dV", "dkv"), ("dQ", "dq")),
                    10, graph=False)
    ms = sp["kernel_sum_ms"]
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    bwd = {"kernel": "K9 fp32 bwd", "shape": str(shape), "ms": ms, "ms_graph": graph_ms(kb, 10),
           "library_ms": split_site("SDPA bwd", lb, (), 10, graph=False)["kernel_sum_ms"],
           "bound_ms": b, "bound_by": by, "bound_share": b / ms, "split_ms": sp["split_ms"],
           "kernels_ms": sp["kernels_ms"],
           "max_rel_err": max(rel_err(a, r) for a, r in zip(kb(), refs))}
    return [fwd, bwd]


def bit_outputs(dev) -> dict:
    """The outputs of the attention variants whose code is shared with the
    timed ones, on seeded inputs."""
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    out = {"K6 bf16": sa.small_attention(*(rnd(4, 16, 576, 64) for _ in range(3))),
           "K6 fp32": sa.small_attention(*(rnd(4, 16, 576, 64).float() for _ in range(3))),
           "K1 attention": fs.site_attention(*(rnd(16, 576, 1024) for _ in range(3)), 16)}
    for D, H in ((64, 16), (128, 8), (256, 4)):
        q, k, v, do = (rnd(4, H, 1024, D) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        out[f"K9 fwd D={D}"] = torch.cat([o.float().flatten(), lse.flatten()])
        out[f"K9 bwd D={D}"] = torch.cat([g.float().flatten() for g in
                                          fa.flash_attention_bwd(q, k, v, o, lse, do)])
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/attention_profile.json")
    ap.add_argument("--bits", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attention needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"card": card, "tree": os.getcwd(),
           "kernels": [profile_k6_f32(dev, gen), profile_k9_bwd_d256(dev, gen)]}
    for shape in ((4, 16, 1024, 64), (4, 8, 1024, 128), (4, 4, 1024, 256)):
        res["kernels"] += profile_k9_f32(dev, gen, shape)
    for r in res["kernels"]:
        print(json.dumps(r), flush=True)
    if args.bits:
        outs = bit_outputs(dev)
        if os.path.exists(args.bits):
            ref = torch.load(args.bits)
            res["same_bits"] = {k: bool(torch.equal(v, ref[k])) for k, v in outs.items()}
            print("same bits as " + args.bits + " " + json.dumps(res["same_bits"]), flush=True)
        else:
            torch.save(outs, args.bits)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
