"""BENCHMARK.json against the contract's shape, and every cell resolved
to the files the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from harness import common

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir()
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = common.load_cell(name)
    assert (cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert hasattr(cell.driver, "run") and hasattr(cell.driver, "calibrate")
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for m in cell.per_layer:
        reader = common.load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_lists_its_cuts(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
