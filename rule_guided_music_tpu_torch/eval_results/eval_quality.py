"""mgeval-style quality tables: generated vs reference MIDI sets.

    python -m rule_guided_music_tpu_torch.eval_results.eval_quality \\
        --generated_dir <dir> --reference_dir <dir> [--out quality]
    ... --runs 3 --subsample 32 --dataset <tag> --method <tag>

Counterpart of ``scripts/eval_results/eval_quality.py`` over the port's
mgeval copy. With ``--runs 1`` it writes ``<out>_statistics.txt`` and
``<out>.csv`` (one row per feature). With ``--runs > 1`` it draws that many
random subsamples of both sets (``np.random.default_rng(--seed)``) and
writes each attribute's KL and OA mean and std over the runs as
``<dataset>.<method>.mean.csv`` / ``<dataset>.<method>.std.csv`` beside
``--out``, the layout ``eval_uncond`` reads.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..eval.mgeval import ATTRIBUTE_ALIASES, evaluate_sets, write_report
from ..utils.tables import format_table, mean, std, write_table


def _rows(results):
    out = []
    for feature, stats in results.items():
        out.append({
            "attribute": ATTRIBUTE_ALIASES.get(feature, feature),
            "KL": stats["kl_divergence"],
            "OA": stats["overlap_area"],
        })
    out.append({
        "attribute": "avg",
        "KL": float(np.mean([r["KL"] for r in out])),
        "OA": float(np.mean([r["OA"] for r in out])),
    })
    return out


def _by_attribute(rows, stat):
    """``groupby("attribute", sort=False)`` of the runs' rows, KL and OA
    reduced by ``stat``."""
    groups = {}
    for r in rows:
        groups.setdefault(r["attribute"], []).append(r)
    return [{"attribute": a, "KL": stat([r["KL"] for r in g]),
             "OA": stat([r["OA"] for r in g])} for a, g in groups.items()]


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--generated_dir", required=True)
    p.add_argument("--reference_dir", required=True)
    p.add_argument("--out", default="quality")
    p.add_argument("--max_files", type=int, default=200)
    p.add_argument("--runs", type=int, default=1,
                   help="multi-run protocol: subsample both sets this "
                        "many times and report per-attribute mean/std")
    p.add_argument("--subsample", type=int, default=0,
                   help="files per set per run (0 = max_files)")
    p.add_argument("--dataset", default="",
                   help="dataset tag for <dataset>.<method>.*.csv")
    p.add_argument("--method", default="",
                   help="method tag for <dataset>.<method>.*.csv")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = create_argparser().parse_args(argv)
    gen = sorted(glob.glob(os.path.join(args.generated_dir, "*.mid*")))
    ref = sorted(glob.glob(os.path.join(args.reference_dir, "*.mid*")))
    gen, ref = gen[:args.max_files], ref[:args.max_files]
    if len(gen) < 2 or len(ref) < 2:
        raise SystemExit("need at least 2 files per set")

    if args.runs <= 1:
        results = evaluate_sets(gen, ref)
        write_report(results, args.out + "_statistics.txt")
        rows = [{"feature": k, **v} for k, v in results.items()]
        write_table(args.out + ".csv", rows)
        print(format_table(rows))
        return rows

    rng = np.random.default_rng(args.seed)
    size = args.subsample or min(len(gen), len(ref))
    stacked = []
    for _ in range(args.runs):
        g = list(rng.choice(gen, size=min(size, len(gen)), replace=False))
        r = list(rng.choice(ref, size=min(size, len(ref)), replace=False))
        stacked += _rows(evaluate_sets(g, r))
    tables = {"mean": _by_attribute(stacked, mean),
              "std": _by_attribute(stacked, std)}

    dataset = args.dataset or os.path.basename(
        os.path.normpath(args.reference_dir))
    method = args.method or os.path.basename(
        os.path.normpath(args.generated_dir))
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    if os.path.basename(args.out) not in ("", "quality"):
        print(f"note: multi-run mode names files <dataset>.<method>.*.csv "
              f"(eval_uncond.py layout); the --out basename "
              f"{os.path.basename(args.out)!r} only selects the directory")
    for tag, rows in tables.items():
        path = os.path.join(out_dir, f"{dataset}.{method}.{tag}.csv")
        write_table(path, rows)
        print(f"wrote {path}")
    print(format_table(tables["mean"]))
    return tables


if __name__ == "__main__":
    main()
