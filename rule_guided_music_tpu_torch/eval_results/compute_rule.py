"""Recompute rule values from saved MIDI files, in one batched call on the
card.

    python -m rule_guided_music_tpu_torch.eval_results.compute_rule \\
        --midi_dir <dir> [--out computed_rules.csv] [--device cpu]

Counterpart of ``scripts/eval_results/compute_rule.py``: reparses the
``.midi`` and ``.mid`` files of ``--midi_dir`` (sorted) into rolls of
``--length`` columns, normalizes them, stacks them into one batch on
``--device`` and runs each rule of ``--rules`` on the whole batch, then
writes ``file,<rule>...`` to ``--out``, each value the list of that file's
rule values.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..constants import EXCERPT_COLS, NORM_SCALE
from ..data.midi_io import read_midi
from ..data.pianoroll import midi_to_roll
from ..pipeline import resolve_device
from ..rules.registry import FUNC_DICT
from ..utils.tables import write_table


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--midi_dir", required=True)
    p.add_argument("--rules", nargs="+",
                   default=["pitch_hist", "note_density", "chord_progression"])
    p.add_argument("--length", type=int, default=EXCERPT_COLS)
    p.add_argument("--out", default="computed_rules.csv")
    p.add_argument("--device", default="cuda")
    return p


def midi_files(midi_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(midi_dir, "*.midi"))
                  + glob.glob(os.path.join(midi_dir, "*.mid")))


def load_batch(files: Sequence[str], length: int, device) -> torch.Tensor:
    """The files' normalized rolls, (N, 3, 128, length) fp32 on ``device``."""
    rolls = [midi_to_roll(read_midi(p), length=length).astype(np.float32)
             / NORM_SCALE - 1.0 for p in files]
    return torch.as_tensor(np.stack(rolls), device=device)


def rule_values(batch: torch.Tensor, rules: Sequence[str]) -> Dict[str, torch.Tensor]:
    """{rule: (N, D) values} of every rule on the whole batch."""
    return {rule: FUNC_DICT[rule](batch) for rule in rules}


def main(argv=None) -> Dict[str, list]:
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    files = midi_files(args.midi_dir)
    values = rule_values(load_batch(files, args.length, device), args.rules)
    results = {"file": [os.path.basename(f) for f in files]}
    results.update({rule: v.cpu().numpy().tolist() for rule, v in values.items()})
    write_table(args.out, [dict(zip(results, row)) for row in zip(*results.values())])
    print(f"wrote {args.out} ({len(files)} files)")
    return results


if __name__ == "__main__":
    main()
