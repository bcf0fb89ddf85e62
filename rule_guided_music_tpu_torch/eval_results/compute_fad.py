"""Fréchet Audio Distance between two MIDI sets.

    python -m rule_guided_music_tpu_torch.eval_results.compute_fad \\
        --background_dir <dir> --eval_dir <dir> [--backend proxy|vggish]

Counterpart of ``scripts/eval_results/compute_fad.py``. ``--backend
proxy`` (the default) scores the numpy proxy of ``eval/fad.py`` (additive
synthesis + log-mel Fréchet distance; relative comparisons only) on the
first ``--max_files`` MIDI files of each directory. ``--backend vggish``
scores wav directories with the fluidsynth + VGGish stack, and raises the
gate's ``RuntimeError`` where that stack is not installed.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..eval.fad import compute_fad, compute_fad_proxy


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--background_dir", required=True,
                   help="directory of reference .midi files")
    p.add_argument("--eval_dir", required=True,
                   help="directory of generated .midi files")
    p.add_argument("--backend", default="proxy", choices=["proxy", "vggish"])
    p.add_argument("--max_files", type=int, default=200)
    return p


def main(argv=None) -> float:
    args = create_argparser().parse_args(argv)
    if args.backend == "vggish":
        score = compute_fad(args.background_dir, args.eval_dir)
    else:
        def midis(d):
            out = sorted(
                glob.glob(os.path.join(d, "*.mid"))
                + glob.glob(os.path.join(d, "*.midi"))
            )[:args.max_files]
            if len(out) < 2:
                raise SystemExit(f"need at least 2 MIDI files in {d}")
            return out

        score = compute_fad_proxy(midis(args.background_dir),
                                  midis(args.eval_dir))
    print(f"FAD ({args.backend}): {score:.4f}")
    return score


if __name__ == "__main__":
    main()
