"""Note-density edit bin accuracy.

    python -m rule_guided_music_tpu_torch.eval_results.edit_accuracy \\
        --results <edit results.csv> [--hr_scale 1.0]

Counterpart of ``scripts/eval_results/edit_accuracy.py``: for an edit
run's ``results.csv``, how often the generated excerpt's note-density
class landed in the target's bin, and within one bin, over both axes
(``rules/tensor_rules.py``'s bounds; the horizontal ones divided by
``--hr_scale``).
"""

from __future__ import annotations

import argparse
import ast

import numpy as np

from ..rules.tensor_rules import HORIZONTAL_ND_BOUNDS, VERTICAL_ND_BOUNDS
from ..utils.tables import read_table, table_rows


def to_classes(values, bounds):
    return np.searchsorted(np.asarray(bounds), np.asarray(values))


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--results", required=True, help="edit results.csv")
    p.add_argument("--rule", default="note_density")
    p.add_argument("--hr_scale", type=float, default=1.0)
    return p


def main(argv=None):
    """Prints both accuracies; returns (hits, within one bin, total)."""
    args = create_argparser().parse_args(argv)
    table = read_table(args.results)
    tgt_col = f"{args.rule}.target_rule"
    gen_col = f"{args.rule}.gen_rule"
    if tgt_col not in table:
        raise SystemExit(f"no column {tgt_col} in {args.results}")

    hits = near = total = 0
    for row in table_rows(table):
        tgt = np.asarray(ast.literal_eval(str(row[tgt_col])), dtype=float)
        gen = np.asarray(ast.literal_eval(str(row[gen_col])), dtype=float)
        half = len(tgt) // 2
        vt_t = to_classes(tgt[:half], VERTICAL_ND_BOUNDS)
        vt_g = to_classes(gen[:half], VERTICAL_ND_BOUNDS)
        hr_bounds = np.asarray(HORIZONTAL_ND_BOUNDS) / args.hr_scale
        hr_t = to_classes(tgt[half:], hr_bounds)
        hr_g = to_classes(gen[half:], hr_bounds)
        t_cls = np.concatenate([vt_t, hr_t])
        g_cls = np.concatenate([vt_g, hr_g])
        hits += int((t_cls == g_cls).sum())
        near += int((np.abs(t_cls - g_cls) <= 1).sum())
        total += len(t_cls)

    print(f"bin accuracy:   {hits / total:.3f} ({hits}/{total})")
    print(f"±1-bin accuracy: {near / total:.3f} ({near}/{total})")
    return hits, near, total


if __name__ == "__main__":
    main()
