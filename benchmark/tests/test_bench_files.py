"""The benchmark's files: every cell names a configuration, a traffic mix
and metrics that the harness finds by name, and BENCHMARK.json agrees."""
import json
import re
from pathlib import Path

import pytest

from benchmark.harness import cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    wl, cfg, tr = cell.load_cell(name)
    assert wl["name"] == name and cfg["name"] == wl["config"]
    for metric in wl["end_to_end"] + wl["per_layer"]:
        mod = cell.reader(metric)
        assert UNIT.match(mod.UNIT) and callable(mod.read)
    assert tr["frames"] >= 2 and wl["chips"] in (1, 4)


def test_benchmark_json_matches_the_files():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for w in b["workloads"]:
        wl, _, _ = cell.load_cell(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert w["config"] in cfgs
        for m in wl["end_to_end"] + wl["per_layer"]:
            assert m in metrics and cell.reader(m).UNIT == metrics[m]["unit"]
            assert "workloads" not in metrics[m] or w["name"] in metrics[m]["workloads"]
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for w in m.get("workloads", []):
            assert m["moves"] in cell.load("workloads", w)["end_to_end"]


def test_names_and_units_keep_the_allowed_characters():
    b = spec()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for text in [w["why"] for w in b["workloads"]] + [c["source"] for c in b["configs"]] + \
            [m["layer"] for m in b["per_layer"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(b)) <= 64 * 1024
