"""The readings that the check's limits are set from, at a cell's own size.

    python3 -m benchmark.harness.control --workload depth24.depthpro \
        --seeds 11 12 13 --control-seeds 11 12 13 [--nudge 1e-6] [--lr-scale 0.9] \
        [--out readings.jsonl]

For each seed, in one process: the program runs the cell's first video and
keeps the sample a run's check keeps; the reference recomputes it; the gaps
between the two are the program's readings (the lower ones). For each
control seed the reference also runs in the control's precision, one step
below what the configuration states for each part, and its gaps from the
reference are the control's readings (the upper ones). Where the cell
solves, `--nudge` and `--lr-scale` add the reference's solve from a
nudged start (how far rounding carries) and at a wrong learning rate (a
fault's reading). Not part of the
benchmark's runs; each line it prints is one seed's JSON record.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark.harness import cell, checks
from benchmark.harness.program import Program
from benchmark.harness.traffic import make_video
from benchmark.reference import common as C
from benchmark.reference import compare


def witness(cfg, tr, plan, ref, nudge=0.0, lr_scale=1.0):
    """The reference's solve again from its own initialisation, the log-depths
    nudged by `nudge` (seeded noise) or the learning rate scaled by
    `lr_scale`: how far a difference of that size carries through the
    solve, and what a wrong step size reads (`solve_curve` at the
    workload's steps, the descents' gap at READ_STEPS and the last loss's)."""
    from benchmark.reference import scene as ref_scene
    raw, sc = plan["raw"], plan["scene"]
    scfg = dict(cfg["solve"], **tr["solve"])
    scfg["lr"] *= lr_scale
    r = ref_scene.run(raw["pred_i"], raw["pred_j"], raw["conf_i"], raw["conf_j"], sc["pairs"],
                      len(sc["depths"]), sc["hw"], scfg, C.Precision(),
                      checks.follow_pnp(plan.get("pnp")), nudge=nudge)
    r["losses"] = r["losses"].double().cpu().numpy()
    return {"nudge": nudge, "lr_scale": lr_scale,
            **compare.solve_gaps(r, ref["scene"], plan["solve_steps"], ref["objective"]),
            **compare.solve_diagnostics(r, ref["scene"])}


def readings(workload, seed, device, control: bool, defs=None, nudge=0.0, lr_scale=1.0):
    wl, cfg, tr = defs if defs is not None else cell.load_cell(workload)
    dev = torch.device(device)
    t0 = time.perf_counter()
    prog = Program(cfg, tr, seed, dev)
    plan = checks.plan(seed, tr, wl["check"])
    plan["video"] = 0
    prog.capture = plan
    frames = make_video(tr, seed, 0, dev).numpy()
    prog.run_video(frames, 0)
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = checks.reference(cfg, tr, seed, frames, plan, dev, C.Precision())
    rec = {"seed": seed, "program": checks.gaps(cfg, tr, wl["check"], plan, ref),
           "pnp_problems": ref.get("pnp_problems"), "program_s": t1 - t0,
           "reference_s": time.perf_counter() - t1}
    rec["program_unchecked"] = dict(compare.engine_diagnostics(plan["engine"], ref["engine"]),
                                    **compare.prior_diagnostics(plan["prior"], ref["prior"]))
    if tr.get("solve"):
        rec["program_unchecked"].update(compare.solve_diagnostics(
            plan["scene"], ref["scene"], plan["init"], ref["init"], cfg["solve"]))
    if nudge and tr.get("solve"):
        rec["witness"] = witness(cfg, tr, plan, ref, nudge=nudge)
    if lr_scale != 1.0 and tr.get("solve"):
        rec["fault_lr"] = witness(cfg, tr, plan, ref, lr_scale=lr_scale)
    if control:
        ctl = checks.reference(cfg, tr, seed, frames, plan, dev,
                               C.Precision("control", cfg["precision"]))
        rec["control"] = checks.gaps(cfg, tr, wl["check"], ctl, ref)
        rec["control_unchecked"] = dict(compare.engine_diagnostics(ctl["engine"], ref["engine"]),
                                        **compare.prior_diagnostics(ctl["prior"], ref["prior"]))
        if tr.get("solve"):
            rec["control_unchecked"].update(compare.solve_diagnostics(
                ctl["scene"], ref["scene"], ctl["init"], ref["init"], cfg["solve"]))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="also run the reference's solve at this multiple of its learning "
                         "rate (a fault's reading)")
    ap.add_argument("--nudge", type=float, default=0.0,
                    help="also run the reference's solve with its initial log-depths nudged "
                         "by this much (the witness of how far rounding carries)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cell.card()}", flush=True)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            rec = readings(args.workload, seed, "cuda", seed in args.control_seeds,
                           nudge=args.nudge, lr_scale=args.lr_scale)
            rec["workload"] = args.workload
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
