"""Profile the pipeline DPT heads' kernels K7 and K8 on one GPU, by launch,
and the serving engine with either head.

    python -m align3r_tpu_torch.tools.profile_heads [--out build/heads_profile.json]
        [--engine] [--dtype fp32]

Runs K7 (``ops.dpt_pipeline.fused_res_unit``) at the four refinenet levels of
the serving path (a decode batch of 32 pairs at 512x288: 72x128 with and
without the fusion block's base, 36x64, 18x32, 9x16; C = 256) and K8
(``fused_head_final``) at the head tail (32, 144, 256, 256), from seeded
random bf16 inputs and weights (fp32 with ``--dtype fp32``), as
``chip_smoke.py``'s kernels phase does. Per shape it reports:
- the call's device time from a CUDA graph of 10 calls (CUDA events), its
  time over 10 calls launched one by one (CUDA events; an older tree's K8
  wrapper copied its interpolation tables from the host on every call,
  which a graph cannot capture, so there it has this time only), and its
  bound (the larger of its FLOPs at the 989 TFLOP/s bf16 peak, in fp32 three
  TF32 products per product at 494.7 TFLOP/s, and its bytes at 3.35 TB/s);
- its split by launch from torch.profiler over 10 eager calls, in device ms
  per call: K7's conv 1 and conv 2 (+ residual), K8's conv 1, the upsample
  and conv 2 (+ the 1x1), and anything else (the weights' stack and cast),
  each conv with its TFLOP/s. The convs are told apart by epilogue in the
  kernels' names (``conv3x3_kernel<T, EPI, RELU>`` before the GEMM core took
  the bf16 ones, ``conv_sm90<EPI>`` and ``conv3x3_fp32<EPI, RELU>`` after,
  ``conv_tf32_sm90<EPI>`` for fp32 since the 3xTF32 kernel), so a copy of
  this file (with ``profile_site.py``) profiles an older tree as well;
- the same function through the port's XLA-path chain (the default head's
  cuDNN convolutions, TF32 off), from a CUDA graph and launched one by one.
With ``--engine`` it also builds VIT_L_512 from seeded weights and times the
serving engine on ``chip_smoke.py``'s 24 synthetic frames (190 pairs, batch
32) with ``head_conv_impl="xla"`` and ``"pipeline"``, warm, in turns (xla,
pipeline, pipeline, xla, twice). It prints the card's name and power limit
and one JSON line, and writes the same JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from align3r_tpu_torch.tools.profile_site import graph_ms, serving_setup, split_site

PEAK_BF16, PEAK_TF32, HBM_BYTES_S = 989e12, 494.7e12, 3.35e12
BATCH, C, C2, C3 = 32, 256, 128, 4


def _conv(epi: int, relu: str, old: tuple[int, str]) -> str:
    """A conv launch with epilogue `epi` and operand relu `relu`, by its
    kernel's name: bf16 conv_sm90<EPI>, fp32 conv_tf32_sm90<EPI> (before it,
    conv3x3_fp32<EPI, RELU>), and before the GEMM core took the bf16 convs,
    conv3x3_kernel<T, EPI, RELU> (epilogue and relu `old`)."""
    return (rf"conv_sm90<{epi}>|conv_tf32_sm90<{epi}>|conv3x3_fp32<{epi}, ?{relu}>|"
            rf"conv3x3_kernel<[^,]+, ?{old[0]}, ?{old[1]}>")


# (part, regular expression on the kernel's name); first match wins. The
# epilogues: 0 round, 1 residual, 2 head (+ 1x1), 3 relu. K7's conv 1 is
# relu(x) in, relu out (before: epilogue 0 with the operand relu), its conv 2
# takes no operand relu (before: it did)
K7_PARTS = (("conv 1", _conv(3, "true", (0, "true"))),
            ("conv 2 (+ residual)", _conv(1, "false", (1, "true"))))
K8_PARTS = (("conv 1", _conv(0, "false", (0, "false"))), ("upsample", "upsample2x"),
            ("conv 2 (+ 1x1)", _conv(2, "false", (2, "false"))))
LEVELS = ((72, 128, False), (72, 128, True), (36, 64, False), (18, 32, False), (9, 16, False))


def _bound(nbytes: float, flops: float, dtype=torch.bfloat16) -> tuple[float, str]:
    """bf16 products at the bf16 peak; fp32 ones as three TF32 products
    (3xTF32) at the TF32 peak."""
    to = (flops / PEAK_BF16 if dtype == torch.bfloat16 else 3 * flops / PEAK_TF32) * 1e3
    tb = nbytes / HBM_BYTES_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _rnd(gen, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def events_ms(fn, reps: int = 10) -> float:
    """Mean ms of fn() over `reps` calls launched one by one (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_k7(dev, gen, H, W, with_base, reps: int = 10, dtype=torch.bfloat16) -> dict:
    from align3r_tpu_torch.models.dpt_head import _residual_conv_unit
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    conv = lambda: (_rnd(gen, dev, C, C, 3, 3, scale=1 / (3 * C ** 0.5), dtype=dtype),
                    _rnd(gen, dev, C, scale=0.1, dtype=dtype))
    unit = (conv(), conv())
    v = _rnd(gen, dev, BATCH, H, W, C, dtype=dtype)
    base = _rnd(gen, dev, BATCH, H, W, C, dtype=dtype) if with_base else None
    isz, name = v.element_size(), "bf16" if dtype == torch.bfloat16 else "fp32"
    kern = lambda: dp.fused_res_unit(v, unit, base)
    xla = ((lambda: _residual_conv_unit(unit, v)) if base is None
           else (lambda: base + _residual_conv_unit(unit, v)))
    px = BATCH * H * W
    conv_flops = 2 * px * 9 * C * C
    res = split_site(f"K7 ({BATCH}, {H}, {W}, {C}) {name}{' + base' if with_base else ''}",
                     kern, K7_PARTS, reps)
    b_ms, b_by = _bound(px * C * isz * (3 if with_base else 2) + 2 * 9 * C * C * isz + 2 * C * 4,
                        2 * conv_flops, dtype)
    res.update(events_ms=events_ms(kern, reps), xla_chain_graph_ms=graph_ms(xla, reps),
               xla_chain_events_ms=events_ms(xla, reps),
               bound_ms=b_ms, bound_by=b_by,
               tflops={k: conv_flops / (res["split_ms"][k] * 1e9)
                       for k in ("conv 1", "conv 2 (+ residual)") if k in res["split_ms"]})
    return res


def profile_k8(dev, gen, reps: int = 10, dtype=torch.bfloat16) -> dict:
    from align3r_tpu_torch.models import nn as L
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    B, Hin, Win = BATCH, 144, 256
    x = _rnd(gen, dev, B, Hin, Win, C, dtype=dtype)
    isz, name = x.element_size(), "bf16" if dtype == torch.bfloat16 else "fp32"
    p1 = (_rnd(gen, dev, C2, C, 3, 3, scale=1 / (3 * C ** 0.5), dtype=dtype),
          _rnd(gen, dev, C2, scale=0.1, dtype=dtype))
    p2 = (_rnd(gen, dev, C2, C2, 3, 3, scale=1 / (3 * C2 ** 0.5), dtype=dtype),
          _rnd(gen, dev, C2, scale=0.1, dtype=dtype))
    p3 = (_rnd(gen, dev, C3, C2, 1, 1, scale=C2 ** -0.5, dtype=torch.float32),
          _rnd(gen, dev, C3, scale=0.1, dtype=torch.float32))
    kern = lambda: dp.fused_head_final(x, p1, p2, p3)

    def xla():
        h = L.conv2d(x, *p1, padding=1)
        h = L.bilinear_resize(h, 2 * Hin, 2 * Win, align_corners=True)
        h = torch.relu(L.conv2d(h, *p2, padding=1))
        return L.conv2d(h.float(), *p3)

    px_in, px_out = B * Hin * Win, 4 * B * Hin * Win
    flops = {"conv 1": 2 * px_in * 9 * C * C2, "conv 2 (+ 1x1)": 2 * px_out * 9 * C2 * C2}
    res = split_site(f"K8 ({B}, {Hin}, {Win}, {C}) {name} -> ({B}, {2 * Hin}, {2 * Win}, {C3})",
                     kern, K8_PARTS, reps, graph=hasattr(dp, "_interp_taps_on"))
    b_ms, b_by = _bound(px_in * C * isz + px_out * C3 * 4 + 9 * (C + C2) * C2 * isz,
                        sum(flops.values()) + 4 * 2 * C2 * px_out + 2 * C2 * C3 * px_out, dtype)
    up_bytes = px_in * C2 * isz + px_out * C2 * isz
    res.update(events_ms=events_ms(kern, reps), xla_chain_graph_ms=graph_ms(xla, reps),
               xla_chain_events_ms=events_ms(xla, reps),
               bound_ms=b_ms, bound_by=b_by, upsample_bound_ms=up_bytes / HBM_BYTES_S * 1e3,
               tflops={k: f / (res["split_ms"][k] * 1e9) for k, f in flops.items()
                       if k in res["split_ms"]})
    return res


def engine_heads(dev) -> dict:
    """The serving engine with the default (xla) and the pipeline heads,
    warm, in turns."""
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    pm, imgs, priors, pairs = serving_setup(dev)
    launches, secs = {}, {}
    for impl in ("xla", "pipeline"):   # cold: cuDNN picks its algorithms, the kernels load
        dp.fused_res_unit.launches = dp.fused_head_final.launches = 0
        inference(pairs, pm, imgs, priors, batch_size=BATCH, head_conv_impl=impl)
        torch.cuda.synchronize()
        launches[impl] = [dp.fused_res_unit.launches, dp.fused_head_final.launches]
    for impl in ("xla", "pipeline", "pipeline", "xla") * 2:
        t0 = time.perf_counter()
        inference(pairs, pm, imgs, priors, batch_size=BATCH, head_conv_impl=impl)
        torch.cuda.synchronize()
        secs.setdefault(impl, []).append(time.perf_counter() - t0)
    return {"pairs": len(pairs), "k7_k8_launches": launches, "engine_s": secs,
            "pairs_per_s": {k: [len(pairs) / s for s in v] for k, v in secs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/heads_profile.json")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="the kernels' storage dtype (the engine's heads stay bf16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_heads needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    res = {"card": card, "dtype": args.dtype,
           "k7": [profile_k7(dev, gen, *lv, dtype=dt) for lv in LEVELS],
           "k8": profile_k8(dev, gen, dtype=dt)}
    torch.cuda.empty_cache()
    if args.engine:
        res["engine"] = engine_heads(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
