"""mgeval-style objective evaluation of generated MIDI.

A copy of ``rule_guided_music_tpu/eval/mgeval.py`` for the port, reading
through the port's ``data/midi_io``; scipy is imported as there.

Re-architecture of music_evaluation/{music_evaluator.py, mgeval/core.py,
mgeval/utils.py}: per-file absolute features, leave-one-out intra/inter-set
distance distributions, and KL divergence + Overlap Area per feature.

Features (the 7 used by the reference evaluator, music_evaluator.py:58-106):
  total_used_pitch, pitch_range, avg_IOI, total_pitch_class_histogram,
  avg_velocity, note_length (mean duration), note_density (notes/sec).

Beyond the runner's 7, the full published mgeval extractor surface
(mgeval/core.py:16-644, including the upstream-commented ones) is ported as
clean note-list programs: total_used_note, avg_pitch_shift,
note_length_hist, pitch_class_transition_matrix,
note_length_transition_matrix, and the bar-level extractors
(bar_used_pitch, bar_used_note, bar_pitch_class_histogram).  Documented
re-expression choices vs the reference's event-scan implementations:
  * bars are fixed-length in seconds (default 2.0 s = one 4/4 bar at
    120 bpm, the reference's default assumption) instead of parsed from
    TimeSignature events — this codec's MidiData carries seconds;
  * pitch-class transitions count consecutive-onset note pairs (sorted by
    start, ties by pitch) rather than pretty_midi's roll-based matrix;
  * note lengths quantize to the same 12 beat-length classes
    [full, half, quarter, 8th, 16th, dotted x4, triplets x3] by nearest
    duration, with the bar length fixed as above.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
from scipy import stats

from ..data.midi_io import MidiData, read_midi


# ---------------------------------------------------------------------------
# Per-file features (mgeval/core.py ports)
# ---------------------------------------------------------------------------


def total_used_pitch(midi: MidiData) -> float:
    return float(len({n.pitch for n in midi.notes}))


def pitch_range(midi: MidiData) -> float:
    if not midi.notes:
        return 0.0
    pitches = [n.pitch for n in midi.notes]
    return float(max(pitches) - min(pitches))


def avg_ioi(midi: MidiData) -> float:
    """Average inter-onset interval."""
    onsets = sorted({round(n.start, 6) for n in midi.notes})
    if len(onsets) < 2:
        return 0.0
    return float(np.mean(np.diff(onsets)))


def total_pitch_class_histogram(midi: MidiData) -> np.ndarray:
    hist = np.zeros(12)
    for n in midi.notes:
        hist[n.pitch % 12] += n.end - n.start
    s = hist.sum()
    return hist / s if s > 0 else hist


def avg_velocity(midi: MidiData) -> float:
    if not midi.notes:
        return 0.0
    return float(np.mean([n.velocity for n in midi.notes]))


def avg_note_length(midi: MidiData) -> float:
    if not midi.notes:
        return 0.0
    return float(np.mean([n.end - n.start for n in midi.notes]))


def note_density(midi: MidiData) -> float:
    end = midi.get_end_time()
    return float(len(midi.notes) / end) if end > 0 else 0.0


def total_used_note(midi: MidiData) -> float:
    """Note count (rhythm feature; mgeval core.py total_used_note)."""
    return float(len(midi.notes))


def avg_pitch_shift(midi: MidiData) -> float:
    """Mean |interval| between consecutive notes in onset order
    (mgeval core.py avg_pitch_shift)."""
    ordered = sorted(midi.notes, key=lambda n: (n.start, n.pitch))
    if len(ordered) < 2:
        return 0.0
    pitches = np.array([n.pitch for n in ordered], dtype=float)
    return float(np.mean(np.abs(np.diff(pitches))))


DEFAULT_BAR_SECONDS = 2.0        # one 4/4 bar at the reference's 120 bpm

# beat-length classes as fractions of a (4-beat) bar:
# [full, half, quarter, 8th, 16th, dot-half, dot-quarter, dot-8th,
#  dot-16th, half-triplet, quarter-triplet, 8th-triplet]
# (mgeval core.py note_length_hist hist_list, unit = bar/96)
_LENGTH_CLASSES = np.array(
    [96, 48, 24, 12, 6, 72, 36, 18, 9, 32, 16, 8], dtype=float) / 96.0


def _num_bars(midi: MidiData, bar_seconds: float) -> int:
    return max(int(round(midi.get_end_time() / bar_seconds)), 1)


def bar_used_pitch(midi: MidiData,
                   bar_seconds: float = DEFAULT_BAR_SECONDS) -> np.ndarray:
    """Distinct pitch count per bar; shape (num_bar,)."""
    num_bar = _num_bars(midi, bar_seconds)
    per_bar = [set() for _ in range(num_bar)]
    for n in midi.notes:
        idx = int(n.start / bar_seconds)
        if idx < num_bar:
            per_bar[idx].add(n.pitch)
    return np.array([len(s) for s in per_bar], dtype=float)


def bar_used_note(midi: MidiData,
                  bar_seconds: float = DEFAULT_BAR_SECONDS) -> np.ndarray:
    """Note count per bar; shape (num_bar,)."""
    num_bar = _num_bars(midi, bar_seconds)
    counts = np.zeros(num_bar)
    for n in midi.notes:
        idx = int(n.start / bar_seconds)
        if idx < num_bar:
            counts[idx] += 1
    return counts


def bar_pitch_class_histogram(
    midi: MidiData, bar_seconds: float = DEFAULT_BAR_SECONDS
) -> np.ndarray:
    """Duration-weighted pitch-class histogram per bar; shape (num_bar, 12).
    Notes straddling a bar boundary contribute the in-bar portion of their
    duration to each bar (the reference slices the piano roll per bar)."""
    num_bar = _num_bars(midi, bar_seconds)
    hist = np.zeros((num_bar, 12))
    for n in midi.notes:
        first = int(n.start / bar_seconds)
        last = int(np.ceil(n.end / bar_seconds))
        for b in range(first, min(last, num_bar)):
            lo, hi = b * bar_seconds, (b + 1) * bar_seconds
            overlap = min(n.end, hi) - max(n.start, lo)
            if overlap > 0:
                hist[b, n.pitch % 12] += overlap
    sums = hist.sum(axis=1, keepdims=True)
    return np.where(sums > 0, hist / np.maximum(sums, 1e-12), 0.0)


def _apply_matrix_normalize(mat: np.ndarray, normalize: int) -> np.ndarray:
    if normalize == 1:
        sums = mat.sum(axis=1)
        sums[sums == 0] = 1
        return mat / sums.reshape(-1, 1)
    if normalize == 2:
        total = mat.sum()
        return mat / total if total > 0 else mat
    return mat


def pitch_class_transition_matrix(
    midi: MidiData, normalize: int = 0
) -> np.ndarray:
    """12x12 ordered pitch-class transition counts between consecutive
    notes in onset order; normalize: 0 none, 1 by row, 2 by matrix sum."""
    ordered = sorted(midi.notes, key=lambda n: (n.start, n.pitch))
    mat = np.zeros((12, 12))
    for a, b in zip(ordered, ordered[1:]):
        mat[a.pitch % 12, b.pitch % 12] += 1
    return _apply_matrix_normalize(mat, normalize)


def _length_class(duration: float, bar_seconds: float) -> int:
    return int(np.abs(_LENGTH_CLASSES * bar_seconds - duration).argmin())


def note_length_hist(
    midi: MidiData, bar_seconds: float = DEFAULT_BAR_SECONDS,
    normalize: bool = True,
) -> np.ndarray:
    """12-bin histogram of note durations quantized to the beat-length
    classes; optionally normalized to sum 1."""
    hist = np.zeros(12)
    for n in midi.notes:
        hist[_length_class(n.end - n.start, bar_seconds)] += 1
    if normalize and hist.sum() > 0:
        return hist / hist.sum()
    return hist


def note_length_transition_matrix(
    midi: MidiData, bar_seconds: float = DEFAULT_BAR_SECONDS,
    normalize: int = 0,
) -> np.ndarray:
    """12x12 transition counts between consecutive notes' length classes
    (onset order); normalize: 0 none, 1 by row, 2 by matrix sum."""
    ordered = sorted(midi.notes, key=lambda n: (n.start, n.pitch))
    mat = np.zeros((12, 12))
    classes = [_length_class(n.end - n.start, bar_seconds) for n in ordered]
    for a, b in zip(classes, classes[1:]):
        mat[a, b] += 1
    return _apply_matrix_normalize(mat, normalize)


# This module's feature keys -> the reference music_evaluator attribute
# names (eval_uncond.py:12-21) for results-table compatibility.
ATTRIBUTE_ALIASES = {
    "avg_velocity": "mean_note_velocity",
    "note_length": "mean_note_duration",
}

FEATURES = {
    "total_used_pitch": total_used_pitch,
    "pitch_range": pitch_range,
    "avg_IOI": avg_ioi,
    "total_pitch_class_histogram": total_pitch_class_histogram,
    "avg_velocity": avg_velocity,
    "note_length": avg_note_length,
    "note_density": note_density,
    # fixed-dimension extractors beyond the reference runner's 7 — usable
    # in evaluate_sets (matrices flattened for the distance metrics)
    "total_used_note": total_used_note,
    "avg_pitch_shift": avg_pitch_shift,
    "note_length_hist": note_length_hist,
    "pitch_class_transition_matrix":
        lambda m: pitch_class_transition_matrix(m, normalize=2).ravel(),
    "note_length_transition_matrix":
        lambda m: note_length_transition_matrix(m, normalize=2).ravel(),
}

# the reference evaluator's exact feature set (music_evaluator.py:58-106) —
# evaluate_sets defaults to this so results stay runner-comparable
RUNNER_FEATURES = (
    "total_used_pitch", "pitch_range", "avg_IOI",
    "total_pitch_class_histogram", "avg_velocity", "note_length",
    "note_density",
)

# per-file instruments with data-dependent output length (one row per bar);
# not usable in set-level distance metrics
BAR_EXTRACTORS = {
    "bar_used_pitch": bar_used_pitch,
    "bar_used_note": bar_used_note,
    "bar_pitch_class_histogram": bar_pitch_class_histogram,
}


# ---------------------------------------------------------------------------
# Distance distributions + KL / Overlap Area (mgeval/utils.py ports)
# ---------------------------------------------------------------------------


def _feature_matrix(files: Sequence[str], feature: str) -> np.ndarray:
    vals = []
    for path in files:
        midi = read_midi(path)
        vals.append(np.atleast_1d(np.asarray(FEATURES[feature](midi), dtype=float)))
    return np.stack(vals)


def c_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distances from one sample to every sample of another set."""
    return np.linalg.norm(b - a[None], axis=-1)


def kl_dist(a: np.ndarray, b: np.ndarray, num_sample: int = 1000) -> float:
    """KL between Gaussian-KDE-smoothed distance distributions."""
    a, b = np.asarray(a, float).ravel(), np.asarray(b, float).ravel()
    if a.std() < 1e-12 or b.std() < 1e-12:
        return 0.0
    pdf_a = stats.gaussian_kde(a)
    pdf_b = stats.gaussian_kde(b)
    sample = np.linspace(
        min(a.min(), b.min()), max(a.max(), b.max()), num_sample
    )
    pa, pb = pdf_a(sample) + 1e-12, pdf_b(sample) + 1e-12
    return float(stats.entropy(pa, pb))


def overlap_area(a: np.ndarray, b: np.ndarray, num_sample: int = 1000) -> float:
    """Overlapping area of the two KDE-smoothed distributions."""
    a, b = np.asarray(a, float).ravel(), np.asarray(b, float).ravel()
    if a.std() < 1e-12 or b.std() < 1e-12:
        return 0.0
    pdf_a = stats.gaussian_kde(a)
    pdf_b = stats.gaussian_kde(b)
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    sample = np.linspace(lo, hi, num_sample)
    return float(
        np.minimum(pdf_a(sample), pdf_b(sample)).sum() * (hi - lo) / num_sample
    )


def evaluate_sets(
    generated_files: Sequence[str],
    reference_files: Sequence[str],
    features: Sequence[str] = RUNNER_FEATURES,
) -> Dict[str, Dict[str, float]]:
    """Absolute means + relative (intra/inter) KL and OA per feature
    (music_evaluator.py:108-221)."""
    results = {}
    for feature in features:
        gen = _feature_matrix(generated_files, feature)
        ref = _feature_matrix(reference_files, feature)
        n_gen, n_ref = len(gen), len(ref)

        # leave-one-out intra-set distances for the generated set
        intra = np.array([
            c_dist(gen[i], np.delete(gen, i, axis=0)).mean()
            for i in range(n_gen)
        ])
        inter = np.array([c_dist(gen[i], ref).mean() for i in range(n_gen)])
        intra_ref = np.array([
            c_dist(ref[i], np.delete(ref, i, axis=0)).mean()
            for i in range(n_ref)
        ])

        results[feature] = {
            "gen_mean": float(gen.mean()),
            "gen_std": float(gen.std()),
            "ref_mean": float(ref.mean()),
            "ref_std": float(ref.std()),
            "kl_divergence": kl_dist(intra, inter),
            "overlap_area": overlap_area(intra, inter),
            "ref_kl_divergence": kl_dist(intra_ref, inter),
            "ref_overlap_area": overlap_area(intra_ref, inter),
        }
    return results


def write_report(results: Dict[str, Dict[str, float]], path: str):
    """statistics.txt-style report (music_evaluation/results/statistics.txt)."""
    with open(path, "w") as f:
        for feature, stats_d in results.items():
            f.write(f"{feature}:\n")
            for k, v in stats_d.items():
                f.write(f"  {k}: {v:.4f}\n")
            f.write("\n")
