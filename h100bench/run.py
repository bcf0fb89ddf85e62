"""The benchmark of rule_guided_music_tpu_torch on one NVIDIA H100.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in BENCHMARK.json, its configuration, traffic mix, window
driver (``drivers/<traffic driver>.py``), limits (``limits/<cell>.json``)
and per-layer metric readers (``metrics/<metric>.py``) by name; builds the
program's kernels and models with the benchmark's weights, warms the
cell's own shapes, measures for ``--seconds`` (``--trace 0``: the
end-to-end metrics) or traces whole units under the profiler (``--trace
1``: the per-layer metrics), judges what the timed path produced against
the plain reference, and prints one JSON line last on stdout. Exits with
another code than 0, and prints no result, without a CUDA card or with a
JAX module loaded.
"""

import time

T_START = time.perf_counter()

import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))
# libraries that would load JAX by themselves are told not to
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from harness import common

    cell = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no result: the cell needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2

    def read_metrics(**kw):
        ctx = SimpleNamespace(**kw)
        out = {}
        for m in cell.per_layer:
            value = common.load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    ctx = SimpleNamespace(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0),
                          t_start=T_START, clock=time.perf_counter, log=log,
                          read_metrics=read_metrics)
    result, check = cell.driver.run(ctx)
    found = common.forbidden_modules()
    if found:
        log(f"no result: modules loaded that the port must not use: {found}")
        return 3
    common.emit(result, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
