"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name under `benchmark/`:
`workloads/<cell>.json` names its configuration (`configs/<name>.json`),
its traffic mix (`traffic/<mix>.json`), the metrics it reports and the
check's sample and limits; each metric is read by `metrics/<name>.py`, or
by `metrics/<name without its last dotted part>.py` where a family of
metrics shares one reader.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import checks
from benchmark.harness.program import Program, sync
from benchmark.harness.trace import Trace
from benchmark.harness.traffic import WARMUP_VIDEO, make_video
from benchmark.reference import common as C

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "align3r_tpu"}


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_cell(name: str):
    """(workload, configuration, traffic) of a cell, by file name."""
    wl = load("workloads", name)
    return wl, load("configs", wl["config"]), load("traffic", wl["traffic"])


def reader(metric: str):
    """The module that reads `metric`."""
    for stem in (metric, metric.rsplit(".", 1)[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for the metric {metric!r} under {BENCH / 'metrics'}")


class Run:
    """What a metric reader reads: the cell's files, the set-up time, the
    window, each video's record, the benchmark's spans and, in a traced run,
    the device trace."""

    def __init__(self, wl, cfg, traffic):
        self.workload, self.cfg, self.traffic = wl, cfg, traffic
        self.setup_s = None
        self.window = None
        self.videos = []
        self.spans = []
        self.trace = None

    def done(self):
        return [v for v in self.videos if v is not None]

    def span_seconds(self, name):
        return sum(t1 - t0 for n, t0, t1, v in self.spans if n == name and v is not None and v >= 0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_process: float,
             device="cuda", defs=None):
    """Run the cell once and return the result dict (the last line's
    object); the check's numbers go to standard error. `defs` replaces the
    cell's files (the tests' tiny cells)."""
    log = sys.stderr
    wl, cfg, tr = defs if defs is not None else load_cell(workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    run = Run(wl, cfg, tr)
    prog = Program(cfg, tr, seed, dev)
    pool = [make_video(tr, seed, k, dev).numpy() for k in range(tr["distinct_videos"])]
    prog.run_video(make_video(tr, seed, WARMUP_VIDEO, dev).numpy(), -1)
    plan = checks.plan(seed, tr, wl["check"])
    prog.capture = plan
    prog.spans.items.clear()
    sync(dev)
    run.setup_s = time.perf_counter() - t_process
    trace = Trace() if traced else None
    if trace is not None:
        trace.start()
    t0 = time.perf_counter()
    k = failed = 0
    while time.perf_counter() - t0 < seconds:
        try:
            run.videos.append(prog.run_video(pool[k % len(pool)], k))
        except Exception:         # a failed request is counted, and the run goes on
            traceback.print_exc(file=log)
            run.videos.append(None)
            failed += 1
        k += 1
    sync(dev)
    run.window = (t0, time.perf_counter())
    if trace is not None:
        trace.stop()
        run.trace = trace
    run.spans = list(prog.spans.items)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n_done = max(len(run.done()), 1)
    phases = {n: run.span_seconds(n) / n_done for n in ("prior", "loader", "engine", "init",
                                                        "solve", "video")}
    print("seconds a video: " + ", ".join(f"{n} {v:.3f}" for n, v in phases.items()), file=log)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for name in wl[kind]:
        mod = reader(name)
        value = mod.read(run, name.rsplit(".", 1)[-1] if "." in name else "")
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    result = {"correct": False, "attempted": k, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": wl["chips"], "memory_peak_bytes": int(peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = trace.breakdown(run.spans)

    # the check, with the program's state freed
    prog.close()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rows, ok = [], False
    if plan.get("engine") is None or plan["video"] >= len(run.videos) or \
            run.videos[plan["video"]] is None:
        print(f"check: the checked video {plan['video']} did not complete", file=log)
    else:
        frames = pool[plan["video"] % len(pool)]
        try:
            ref = checks.reference(cfg, tr, seed, frames, plan, dev, C.Precision())
            if "pnp_problems" in ref:
                need, posed = ref["pnp_problems"]
                print(f"pnp: {need} frames without a pose after the MST walk, {posed} posed "
                      "by the program's PnP", file=log)
            ok, rows = checks.verdict(checks.gaps(cfg, tr, wl["check"], plan, ref),
                                      wl["check"]["limits"])
        except (NotImplementedError, ValueError) as e:
            print(f"check: the reference cannot judge this run: {e}", file=log)
    result["correct"] = bool(ok and failed == 0 and k > 0)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} {v:.6g} limit {lim if lim is not None else 'none'}", file=log)
    return result


def as_line(result) -> str:
    return json.dumps(result, default=lambda o: float(o) if isinstance(o, np.floating) else str(o))
