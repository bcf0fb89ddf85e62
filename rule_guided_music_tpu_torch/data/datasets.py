"""Piano-roll test-set loader (host-side numpy).

A copy of ``rule_guided_music_tpu/data/datasets.py`` (reference
guided_diffusion/pr_datasets_all.py) for what generation needs: CSV
manifests of ``.npy`` piano rolls, the onset-preserving time stretch and
the pitch shift, and the infinite batch generator, drawing from one numpy
``Generator`` in the JAX package's order (shuffle, then per item the
stretch window and the key shift), so the same manifest and seed give the
same batches.

The JAX package sends uint8 rolls through its C++ augmenter, which its own
tests hold equal to the numpy path kept here. Rule labels (``rule=...``)
are classifier-training data and wait for the training slice (ROADMAP.md,
queue 1, item 12); so does the prefetching thread: batches are drawn in
the caller's thread.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import MAX_PIANO, MIN_PIANO, NORM_SCALE


def load_manifest(csv_path: str) -> Tuple[List[str], Optional[List[int]]]:
    """Read a manifest CSV with columns midi_filename[, classes]."""
    files, classes = [], []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        has_classes = "classes" in (reader.fieldnames or [])
        for row in reader:
            files.append(row["midi_filename"])
            if has_classes:
                classes.append(int(row["classes"]))
    return files, (classes if classes else None)


def piano_like_np(x: np.ndarray) -> np.ndarray:
    """Pitches outside the piano range (axis -2) set to -1, in place."""
    x[..., :MIN_PIANO, :] = -1.0
    x[..., MAX_PIANO + 1:, :] = -1.0
    return x


def key_shift(x: np.ndarray, k: int) -> np.ndarray:
    """Pitch-shift notes and onsets by k semitones with a roll; the pedal
    stays (pr_datasets_all.py:90-105)."""
    pitches_and_onsets, pedals = x[:2], x[2:]
    if k > 0:
        pitches_and_onsets = np.concatenate(
            [pitches_and_onsets[:, k:, :], pitches_and_onsets[:, :k, :]], axis=1)
    elif k < 0:
        pitches_and_onsets = np.concatenate(
            [pitches_and_onsets[:, -k:, :], pitches_and_onsets[:, :-k, :]], axis=1)
    return piano_like_np(np.concatenate([pitches_and_onsets, pedals], axis=0))


def _nearest_resize(x: np.ndarray, new_len: int) -> np.ndarray:
    """Nearest-neighbour resize of the last axis (torch 'nearest')."""
    old_len = x.shape[-1]
    idx = (np.arange(new_len) * old_len // new_len).astype(np.int64)
    return x[..., idx]


def draw_stretch_params(t_src: int, image_size: int, rng: np.random.Generator):
    """The +-5% stretch window (pr_len, start), two draws from ``rng``."""
    pr_len = int(rng.uniform(0.95, 1.05) * image_size)
    pr_len = min(pr_len, t_src)
    start = int(rng.integers(0, max(t_src - pr_len, 1)))
    return pr_len, start


def time_stretch(arr: np.ndarray, image_size: int,
                 rng: np.random.Generator) -> np.ndarray:
    """+-5% random time stretch with onsets kept (pr_datasets_all.py:
    137-159); (3, 128, T) normalized -> (3, 128, image_size)."""
    pr_len, start = draw_stretch_params(arr.shape[-1], image_size, rng)
    return time_stretch_with_params(arr, image_size, pr_len, start)


def time_stretch_with_params(arr: np.ndarray, image_size: int, pr_len: int,
                             start: int) -> np.ndarray:
    arr = arr[:, :, start:start + pr_len]
    if pr_len < image_size:
        # stretching: resize piano and pedal, place each onset once
        piano_pedal = _nearest_resize(arr[[0, 2]], image_size)
        onset_raw = arr[1:2]
        ind_a2b = (np.arange(image_size) / image_size * pr_len).astype(np.int64)
        ind = np.concatenate([[0], np.nonzero(np.diff(ind_a2b))[0] + 1])
        onset = -np.ones((1, 128, image_size), dtype=arr.dtype)
        onset[:, :, ind] = onset_raw[:, :, :len(ind)]
        arr = np.concatenate([piano_pedal[:1], onset, piano_pedal[1:]], axis=0)
    elif pr_len > image_size:
        # compressing: resize everything, put back the onsets it dropped
        arr = _nearest_resize(arr, image_size)
        piano = arr[:1]
        padded = np.concatenate([piano[:, :, :1], piano], axis=-1)
        arr[1:2][np.diff(padded, axis=-1) > 0] = 1.0
    return arr


@dataclass
class PianoRollDataset:
    """Indexable dataset of normalized (3, 128, image_size) rolls and their
    class labels (pr_datasets_all.py:108-182): x / 63.5 - 1, optional
    augmentation."""

    paths: Sequence[str]
    classes: Optional[Sequence[int]] = None
    image_size: int = 1024
    rule: Optional[str] = None
    pitch_shift: bool = True
    time_stretch: bool = True

    def __post_init__(self):
        if self.rule is not None:
            raise NotImplementedError(
                f"rule labels ({self.rule!r}) are classifier-training data: "
                f"not in the torch port yet (ROADMAP.md, queue 1, item 12)")
        self.paths = list(self.paths)
        if self.classes is not None:
            self.classes = list(self.classes)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        raw = np.load(self.paths[idx])
        if self.time_stretch:
            pr_len, start = draw_stretch_params(raw.shape[-1], self.image_size, rng)
        else:
            pr_len, start = min(raw.shape[-1], self.image_size), 0
        k = int(rng.integers(-6, 7)) if self.pitch_shift else 0

        arr = raw.astype(np.float32) / NORM_SCALE - 1.0
        if self.time_stretch:
            arr = time_stretch_with_params(arr, self.image_size, pr_len, start)
        else:
            arr = arr[:, :, :self.image_size]
        if arr.shape[-1] < self.image_size:
            pad = self.image_size - arr.shape[-1]
            arr = np.pad(arr, ((0, 0), (0, 0), (0, pad)), constant_values=-1.0)
        if self.pitch_shift and k:
            arr = key_shift(arr, k)
        arr = piano_like_np(arr)

        out = {}
        if self.classes is not None:
            out["y"] = np.int64(self.classes[idx])
        return arr, out


def load_data(*, data_dir: str, batch_size: int, class_cond: bool = False,
              deterministic: bool = False, image_size: int = 1024,
              rule: Optional[str] = None, seed: int = 0) -> Iterator[Tuple[np.ndarray, dict]]:
    """Infinite generator of (batch (B, 3, 128, L), cond dict) pairs from
    the manifest ``data_dir`` (pr_datasets_all.py:26-87); augmentation and
    shuffling unless ``deterministic``."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size} (a zero "
                         f"batch makes the loader spin forever)")
    files, classes = load_manifest(data_dir)
    dataset = PianoRollDataset(
        paths=files, classes=classes if class_cond else None,
        image_size=image_size, rule=rule, pitch_shift=not deterministic,
        time_stretch=not deterministic)
    if len(dataset) == 0:
        raise ValueError(f"empty dataset from manifest {data_dir}")

    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    while True:
        if not deterministic:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset.__getitem__(j, rng) for j in order[i:i + batch_size]]
            batch = np.stack([it[0] for it in items])
            cond = {key: np.stack([it[1][key] for it in items])
                    for key in items[0][1]}
            yield batch, cond
