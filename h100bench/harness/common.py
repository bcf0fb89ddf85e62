"""What every run shares: the cell's files found by name, seeds, the
check against the limits and the result line."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# top-level module names a run must not load (compared whole: the port's
# package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "rule_guided_music_tpu")


def load_module(path: Path, name: Optional[str] = None):
    """Import a harness file by path (metric readers have dots in their
    names)."""
    spec = importlib.util.spec_from_file_location(
        name or f"h100bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with its files."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1
    bench_dir: Path = BENCH_DIR

    @property
    def driver(self):
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['driver']}.py")


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """Resolve a cell by name: its configuration's file, its traffic mix
    (``traffic/<mix>.json``), its limits (``limits/<cell>.json``) and the
    metrics that apply to it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    applies = lambda m: name in m.get("workloads", [name])
    return Cell(name, config, traffic, limits,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)], cell["chips"], bench_dir)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and integer tags."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over every element, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


@dataclass
class Check:
    """Numbers compared with their limits; ``correct`` when each is at or
    under its limit (and every limit was read)."""

    limits: Dict[str, float]
    values: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, float("-inf")), float(value))

    @property
    def correct(self) -> bool:
        return bool(self.limits) and all(
            n in self.values and np.isfinite(self.values[n]) and self.values[n] <= lim
            for n, lim in self.limits.items())

    def table(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": self.values.get(n), "limit": lim}
                for n, lim in self.limits.items()}

    def report(self, stream=sys.stderr) -> None:
        for n, row in self.table().items():
            print(f"check {n}: {row['value']!r} (limit {row['limit']!r})", file=stream)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict, check: Check) -> None:
    """Print the numbers compared on stderr, then the result line last on
    stdout, with the check under its own key last."""
    check.report()
    result = dict(result, correct=check.correct)
    result["checks"] = check.table()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def timed_loop(step: Callable[[], int], seconds: float, clock, min_steps: int = 1) -> tuple:
    """Run ``step`` back to back until ``seconds`` have passed (and at
    least ``min_steps`` steps), closing at the end of the first step that
    ends after them; returns (units done, elapsed seconds, per-step
    seconds)."""
    units, times = 0, []
    t0 = clock()
    while True:
        t1 = clock()
        units += step()
        times.append(clock() - t1)
        if clock() - t0 >= seconds and len(times) >= min_steps:
            return units, clock() - t0, times
