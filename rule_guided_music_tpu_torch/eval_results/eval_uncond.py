"""Pivot per-run mgeval CSVs into per-folder results tables.

    python -m rule_guided_music_tpu_torch.eval_results.eval_uncond \\
        --path_to_folder <dir> [--metric OA|KL]

Counterpart of ``scripts/eval_results/eval_uncond.py``: reads every
``<dataset>.<method>.<mean|std>.csv`` of the folder (as ``eval_quality
--runs N`` writes them), takes one metric per attribute, and writes
``results_mean.csv`` / ``results_std.csv`` sorted by dataset, then method.
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict

from ..utils.tables import NAN, format_table, read_table, sort_rows, table_rows, write_table

ATTRIBUTES = [
    "total_used_pitch", "avg_IOI", "total_pitch_class_histogram",
    "pitch_range", "mean_note_velocity", "mean_note_duration",
    "note_density", "avg",
]


def _item(values):
    """``Series.item()``: the one value, NaN for none."""
    if len(values) > 1:
        raise ValueError("can only convert an array of size 1 to a Python scalar")
    return values[0] if values else NAN


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--path_to_folder", required=True,
                   help="folder containing <dataset>.<method>.<mean|std>.csv")
    p.add_argument("--metric", default="OA", choices=["OA", "KL"])
    return p


def main(argv=None):
    args = create_argparser().parse_args(argv)
    results = {"mean": defaultdict(list), "std": defaultdict(list)}
    for path in sorted(glob.glob(os.path.join(args.path_to_folder, "*.csv"))):
        name = os.path.basename(path)
        parts = name.split(".")
        if len(parts) != 4 or parts[2] not in results:
            continue  # results_mean.csv etc.
        dataset, method, stat_type = parts[0], parts[1], parts[2]
        table = read_table(path)
        bucket = results[stat_type]
        bucket["dataset"].append(dataset)
        bucket["method"].append(method)
        for attr in ATTRIBUTES:
            bucket[attr].append(_item([
                v for a, v in zip(table["attribute"], table[args.metric])
                if a == attr]))

    for stat_type, bucket in results.items():
        if not bucket:
            continue
        out = sort_rows(table_rows(bucket), ["dataset", "method"])
        path = os.path.join(args.path_to_folder, f"results_{stat_type}.csv")
        write_table(path, out)
        print(f"wrote {path}")
        print(format_table(out))
    return results


if __name__ == "__main__":
    main()
