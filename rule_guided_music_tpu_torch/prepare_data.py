"""Data preparation: MIDI -> piano-roll chunks -> training sequences + CSVs.

    python -m rule_guided_music_tpu_torch.prepare_data chunks --midi_dir <dir> --chunk_dir <dir>
    python -m rule_guided_music_tpu_torch.prepare_data rearrange --chunk_dir <dir> --out_dir <dir> --csv_prefix <prefix> --label N

Counterpart of ``scripts/prepare_data.py``, with its commands, flags and
defaults, over the port's own ``data/midi_io.read_midi`` and
``data/pianoroll.midi_to_roll``: the reference's
datasets/piano_roll_all.py (MIDI -> (3, 128, T) rolls -> 1.28 s uint8 npy
chunks) and rearrange_pr_data.py (chunks -> long sequences, with
train/test and per-class ``_cls_N`` CSV manifests). Host-only: numpy,
no device work, the same bytes as the JAX script's.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from .constants import CHUNK_COLS, DEFAULT_FS
from .data.midi_io import read_midi
from .data.pianoroll import midi_to_roll


def midi_dir_to_chunks(midi_dir: str, out_dir: str, fs: int = DEFAULT_FS,
                       chunk_cols: int = CHUNK_COLS):
    """Write (3, 128, chunk_cols) uint8 npy chunks for every MIDI file
    (datasets/piano_roll_all.py:46-124)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for root, _, files in os.walk(midi_dir):
        for fname in sorted(files):
            if not fname.lower().endswith((".mid", ".midi")):
                continue
            path = os.path.join(root, fname)
            try:
                midi = read_midi(path)
            except Exception as e:  # skip corrupt files, like the reference
                print(f"skip {path}: {e}")
                continue
            roll = midi_to_roll(midi, fs=fs)
            stem = os.path.splitext(fname)[0]
            for i in range(roll.shape[-1] // chunk_cols):
                chunk = roll[:, :, i * chunk_cols:(i + 1) * chunk_cols]
                out = os.path.join(out_dir, f"{stem}_{i}.npy")
                np.save(out, np.clip(chunk, 0, 127).astype(np.uint8))
                written.append(out)
    print(f"wrote {len(written)} chunks to {out_dir}")
    return written


def _write_manifest(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)


def rearrange_chunks(chunk_dir: str, out_dir: str, csv_prefix: str, label: int,
                     seq_chunks: int = 40, gap: int = 16, test_frac: float = 0.1,
                     seed: int = 0):
    """Concatenate per-piece chunks into ``seq_chunks``-long sequences at a
    ``gap``-chunk stride, skipping empty chunks, and write the train/test
    CSVs and their ``_cls_<label>`` copies (rearrange_pr_data.py:93-188)."""
    os.makedirs(out_dir, exist_ok=True)
    by_piece = {}
    for fname in sorted(os.listdir(chunk_dir)):
        if not fname.endswith(".npy"):
            continue
        stem, idx = fname.rsplit("_", 1)
        by_piece.setdefault(stem, []).append(
            (int(idx.split(".")[0]), os.path.join(chunk_dir, fname)))

    rows = []
    for stem, chunks in by_piece.items():
        chunks.sort()
        arrays = [arr for arr in (np.load(path) for _, path in chunks)
                  if arr[0].max() != 0]          # skip empty chunks
        for start in range(0, max(len(arrays) - seq_chunks + 1, 0), gap):
            seq = np.concatenate(arrays[start:start + seq_chunks], axis=-1)
            out = os.path.join(out_dir, f"{stem}_seq{start}.npy")
            np.save(out, seq)
            rows.append((out, label))

    np.random.default_rng(seed).shuffle(rows)
    n_test = max(int(len(rows) * test_frac), 1) if rows else 0
    for split, split_rows in (("train", rows[n_test:]), ("test", rows[:n_test])):
        _write_manifest(f"{csv_prefix}_{split}.csv", split_rows)
        # per-class CSVs, read by sample_rule --data_dir ..._test_cls_N.csv
        _write_manifest(f"{csv_prefix}_{split}_cls_{label}.csv", split_rows)
    print(f"{csv_prefix}: {len(rows)} sequences ({n_test} test)")


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["chunks", "rearrange"])
    parser.add_argument("--midi_dir", default="")
    parser.add_argument("--chunk_dir", default="chunks")
    parser.add_argument("--out_dir", default="sequences")
    parser.add_argument("--csv_prefix", default="data")
    parser.add_argument("--label", type=int, default=0)
    parser.add_argument("--fs", type=int, default=DEFAULT_FS)
    parser.add_argument("--seq_chunks", type=int, default=40)
    parser.add_argument("--gap", type=int, default=16)
    return parser


def main(argv=None):
    args = create_argparser().parse_args(argv)
    if args.command == "chunks":
        return midi_dir_to_chunks(args.midi_dir, args.chunk_dir, fs=args.fs)
    return rearrange_chunks(args.chunk_dir, args.out_dir, args.csv_prefix,
                            args.label, seq_chunks=args.seq_chunks, gap=args.gap)


if __name__ == "__main__":
    main()
