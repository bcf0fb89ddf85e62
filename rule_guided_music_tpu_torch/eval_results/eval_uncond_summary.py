"""Concatenate per-folder results tables into one summary.

    python -m rule_guided_music_tpu_torch.eval_results.eval_uncond_summary \\
        --path_to_folder loggings/eval_uncond/

Counterpart of ``scripts/eval_results/eval_uncond_summary.py``: collects
every ``results_mean.csv`` / ``results_std.csv`` under the folder
(recursively) and writes ``summary_mean.csv`` / ``summary_std.csv``, sorted
by dataset, then method.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..utils.tables import read_table, sort_rows, table_rows, write_table


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--path_to_folder", default="loggings/eval_uncond/")
    return p


def main(argv=None) -> None:
    args = create_argparser().parse_args(argv)
    for stat_type in ("mean", "std"):
        files = glob.glob(
            os.path.join(args.path_to_folder, "**", f"results_{stat_type}.csv"),
            recursive=True,
        )
        if not files:
            print(f"no results_{stat_type}.csv under {args.path_to_folder}")
            continue
        merged = sort_rows([row for f in sorted(files)
                            for row in table_rows(read_table(f))],
                           ["dataset", "method"])
        out = os.path.join(args.path_to_folder, f"summary_{stat_type}.csv")
        write_table(out, merged)
        print(f"wrote {out} ({len(merged)} rows from {len(files)} folders)")


if __name__ == "__main__":
    main()
