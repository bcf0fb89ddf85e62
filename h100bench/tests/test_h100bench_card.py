"""On the card (``pytest -m gpu h100bench/tests`` on the H100): each
driver at fixture size through the port's CUDA kernels, with the result
line's metrics, the device record and ``correct``."""

import json
import time
from types import SimpleNamespace

import pytest

import tiny
from harness import common

CELLS = json.loads((common.ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in CELLS])
@pytest.mark.parametrize("trace_on", [False, True])
def test_driver_on_the_card(card, name, trace_on):
    cell = tiny.cell(name)
    cell.config["dtype"] = "bfloat16"
    ctx = SimpleNamespace(cell=cell, seed=11, seconds=1.0, trace=trace_on, device=card,
                          t_start=time.perf_counter(), clock=time.perf_counter,
                          log=lambda m: None,
                          read_metrics=lambda **kw: {"busy_s": kw["summary"].busy_s})
    result, check = cell.driver.run(ctx)
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0
    if trace_on:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
    else:
        assert {"setup_s", "peak_mem_gib"} <= set(result["metrics"])
    assert check.values
