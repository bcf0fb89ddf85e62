"""Derive note-density class bins from a dataset's extracted targets.

    python -m rule_guided_music_tpu_torch.eval_results.edit_create_bins \\
        --file_name <results.csv> [--out bins.json]

Counterpart of ``scripts/eval_results/edit_create_bins.py``: pools the
vertical and horizontal halves of a ``results.csv``'s
``note_density.target_rule`` lists, splits each into ``--bins`` equal-count
bins, prints their counts and bounds, and with ``--out`` writes the inner
edges and the bins' medians as the JSON ``edit --nd_bins_file`` reads.
"""

from __future__ import annotations

import argparse
import ast
import json

import numpy as np

from ..utils.tables import read_table


def create_bins(values, n_bins=8):
    data = np.sort(np.asarray(values, dtype=np.float64))
    bins = np.array_split(data, n_bins)
    counts = [len(b) for b in bins]
    bounds = [(float(b[0]), float(b[-1])) for b in bins if len(b)]
    # inner edges: midpoint between adjacent bins' extremes; centers: medians
    inner = [
        float((bins[i][-1] + bins[i + 1][0]) / 2.0)
        for i in range(len(bins) - 1)
        if len(bins[i]) and len(bins[i + 1])
    ]
    centers = [float(np.median(b)) for b in bins if len(b)]
    return counts, bounds, inner, centers


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--file_name", required=True,
                   help="results.csv with a note_density.target_rule column")
    p.add_argument("--bins", type=int, default=8)
    p.add_argument("--out", default="",
                   help="optional JSON path for edit.py --nd_bins_file")
    return p


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    vertical, horizontal = [], []
    for row in read_table(args.file_name)["note_density.target_rule"]:
        densities = ast.literal_eval(row)
        half = len(densities) // 2
        vertical.extend(densities[:half])
        horizontal.extend(densities[half:])

    out = {}
    for name, values in [("vertical", vertical), ("horizontal", horizontal)]:
        counts, bounds, inner, centers = create_bins(values, args.bins)
        print(f"{name.capitalize()} Note Density Bins:")
        for i, (count, b) in enumerate(zip(counts, bounds), 1):
            print(f"Bin {i} (Samples: {count}, Bounds: {b})")
        print()
        out[f"{name}_bounds"] = inner
        out[f"{name}_centers"] = centers

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
