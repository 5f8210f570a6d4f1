"""The benchmark of align3r_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload depth24.depthpro --seed 7 --seconds 51 --trace 0

Prints the check's numbers on standard error and, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, and with --trace 1 a breakdown of the trace. Exits 2 without a
result where CUDA is missing or the card count is below the cell's, and 3
where JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache a run can fill lives at a fixed place in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))

    import torch
    from benchmark.harness import cell

    wl, _, _ = cell.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"no CUDA card for {args.workload} (needs {wl['chips']})", file=sys.stderr)
        return 2
    print(f"card: {cell.card()}", file=sys.stderr, flush=True)
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           T_PROCESS)
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(cell.as_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
