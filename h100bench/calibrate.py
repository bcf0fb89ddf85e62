"""Readings that set a cell's limits: the program's on a dozen seeds or
more and the control's (and, for training, each planted fault's), at
the cell's own size, in one process.

    python3 h100bench/calibrate.py --workload <cell> --seeds 11,12,13

Prints one JSON line a seed, then a summary line: for each number the
largest reading of the sound runs (the lower reading) and the smallest
of the control and the faults (the upper). The benchmark's own runs do
not run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))


def summarize(rows):
    lower, upper = {}, {}
    for r in rows:
        for k, v in r["program"].items():
            lower[k] = max(lower.get(k, float("-inf")), v)
        for kind in ("control", *r.get("faults", {})):
            readings = r["control"] if kind == "control" else r["faults"][kind]
            for k, v in readings.items():
                upper.setdefault(kind, {})
                upper[kind][k] = min(upper[kind].get(k, float("inf")), v)
    return {"lower": lower, "upper": upper}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch
    from harness import common

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = common.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    log = lambda row: print(json.dumps(row), flush=True)
    rows = cell.driver.calibrate(cell, torch.device("cuda", 0), seeds, log)
    print(json.dumps({"summary": summarize(rows), "cell": args.workload,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
