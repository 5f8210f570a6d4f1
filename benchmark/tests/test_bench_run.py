"""run.py fails without a card and prints no result; nothing the benchmark
runs imports JAX or the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_exits_without_a_card_and_prints_no_metric():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "depth24.depthpro",
                        "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == "" and "metrics" not in p.stderr


CHECK = r"""
import importlib.util, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import benchmark.run, benchmark.harness.cell, benchmark.harness.control
from benchmark.harness import cell
from benchmark.counts import work
for name in [p.stem for p in (cell.BENCH / "workloads").glob("*.json")]:
    wl, cfg, tr = cell.load_cell(name)
    for m in wl["end_to_end"] + wl["per_layer"]:
        cell.reader(m)
    work.video(cfg, tr)
import align3r_tpu_torch.pipeline, align3r_tpu_torch.models.depth_pro
import align3r_tpu_torch.models.depth_anything
bad = cell.forbidden_modules()
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_no_jax_in_the_benchmark_process():
    p = subprocess.run([sys.executable, "-c", CHECK, str(ROOT)], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "BAD []" in p.stdout
