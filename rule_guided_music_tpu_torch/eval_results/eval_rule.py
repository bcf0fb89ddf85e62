"""Aggregate rule-loss tables across methods.

    python -m rule_guided_music_tpu_torch.eval_results.eval_rule \\
        --root loggings/cond_demo --out rule_table.csv

Counterpart of ``scripts/eval_results/eval_rule.py``: walks ``--root``
for ``results.csv`` files and writes one row per file, in ``os.walk``
order: the method (the directory relative to the root), the number of
samples and the mean and sample std of every ``.loss`` column.
"""

from __future__ import annotations

import argparse
import os
from typing import List

from ..utils.tables import format_table, mean, read_table, std, write_table


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default="loggings/cond_demo")
    p.add_argument("--out", default="rule_table.csv")
    return p


def main(argv=None) -> List[dict]:
    args = create_argparser().parse_args(argv)
    rows = []
    for dirpath, _, files in os.walk(args.root):
        if "results.csv" not in files:
            continue
        table = read_table(os.path.join(dirpath, "results.csv"))
        row = {"method": os.path.relpath(dirpath, args.root),
               "n": len(next(iter(table.values()), []))}
        for col in [c for c in table if c.endswith(".loss")]:
            row[col + ".mean"] = mean(table[col])
            row[col + ".std"] = std(table[col])
        rows.append(row)
    write_table(args.out, rows)
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
