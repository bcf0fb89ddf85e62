"""Chord-progression and key analysis on torch tensors.

Port of ``rule_guided_music_tpu/rules/chord.py`` (see its docstring for the
algorithm and its measured divergence from the music21 oracle): key finding
by Pearson correlation against the 24 Krumhansl-Kessler profiles with the
relative major/minor re-vote, per-window triad (or seventh) template
matching, and the Roman-numeral degree table. Argmax ties break to the
first index, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BACKGROUND_THRESHOLD, OFF
from .tensor_rules import piano_like, pitch_class_sum

KEY_DICT = {
    "D major": 0, "g minor": 1, "B- major": 2, "G major": 3, "d minor": 4,
    "c# minor": 5, "F major": 6, "E- major": 7, "e minor": 8, "f# minor": 9,
    "C major": 10, "F# major": 11, "g# minor": 12, "A major": 13,
    "a minor": 14, "B major": 15, "A- major": 16, "b- minor": 17,
    "E major": 18, "c minor": 19, "b minor": 20, "e- minor": 21,
    "f minor": 22, "C# major": 23, "no key": 24,
}
IND2KEY = {v: k for k, v in KEY_DICT.items()}

_MAJOR_PC2KEY = [10, 23, 0, 7, 18, 6, 11, 3, 16, 13, 2, 15]
_MINOR_PC2KEY = [19, 5, 4, 21, 8, 22, 9, 1, 12, 14, 17, 20]

_KK_MAJOR = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_KK_MINOR = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])

_SEMITONE2DEGREE = np.array([1, 2, 2, 3, 3, 4, 4, 5, 6, 6, 7, 7])


def _build_key_profiles() -> np.ndarray:
    """(24, 12): rows 0-11 major keys by tonic pc, 12-23 minor."""
    profiles = np.zeros((24, 12))
    for tonic in range(12):
        profiles[tonic] = np.roll(_KK_MAJOR, tonic)
        profiles[12 + tonic] = np.roll(_KK_MINOR, tonic)
    return profiles


def _build_triad_templates() -> np.ndarray:
    """(36, 12) binary triads: [12 major, 12 minor, 12 diminished] by root."""
    templates = np.zeros((36, 12))
    for root in range(12):
        for i, third in enumerate([4, 3, 3]):
            fifth = 7 if i < 2 else 6
            row = i * 12 + root
            templates[row, root] = 1.0
            templates[row, (root + third) % 12] = 1.0
            templates[row, (root + fifth) % 12] = 1.0
    return templates


def _build_seventh_templates() -> np.ndarray:
    """(48, 12) seventh chords by root: [dom7, min7, maj7, half-dim7]."""
    qualities = [(4, 7, 10), (3, 7, 10), (4, 7, 11), (3, 6, 10)]
    templates = np.zeros((48, 12))
    for qi, ivs in enumerate(qualities):
        for root in range(12):
            row = qi * 12 + root
            templates[row, root] = 1.0
            for iv in ivs:
                templates[row, (root + iv) % 12] = 1.0
    return templates


_KEY_PROFILES = _build_key_profiles()
_TRIADS = _build_triad_templates()
_SEVENTHS = _build_seventh_templates()
_PROFILE_KEYIDX = np.array(_MAJOR_PC2KEY + _MINOR_PC2KEY)


def _const(a: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _active_notes(piano_roll: torch.Tensor) -> torch.Tensor:
    """(B, 128, L) binary active-note indicator from a normalized roll."""
    roll = piano_like(piano_roll[:, 0, :, :])
    roll = torch.where(roll < BACKGROUND_THRESHOLD, torch.full_like(roll, OFF), roll)
    roll = (roll + 1.0) / 2.0
    return (roll >= 1e-2).float()


def _chroma(active: torch.Tensor) -> torch.Tensor:
    """(B, 128, L) -> (B, 12, L) chroma."""
    return pitch_class_sum(active, axis=1)


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise Pearson correlation between (..., 12) vectors."""
    xm = x - x.mean(dim=-1, keepdim=True)
    ym = y - y.mean(dim=-1, keepdim=True)
    num = (xm * ym).sum(dim=-1)
    den = torch.sqrt((xm ** 2).sum(dim=-1) * (ym ** 2).sum(dim=-1)) + 1e-12
    return num / den


def _window_chroma(active: torch.Tensor, window_cols: int) -> torch.Tensor:
    """(B, 128, L) -> (B, W, 12) per-window chroma."""
    num_windows = active.shape[-1] // window_cols
    chroma_t = _chroma(active[..., : num_windows * window_cols])
    chroma_w = chroma_t.reshape(chroma_t.shape[0], 12, num_windows,
                                window_cols).sum(dim=-1)
    return chroma_w.transpose(1, 2)


def _template_scores(chroma_w: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Cosine similarity of each window's chroma with each template.

    The chroma holds note counts and the templates are 0/1, so the dot
    products are exact integers in float32 and are divided by the norms
    afterwards: templates that tie in exact arithmetic tie bit for bit, and
    the argmax takes the first of them, whatever the summation order.
    (The JAX package normalises first, so its float rounding can break such
    a tie either way; ROADMAP.md, "Faults".)
    """
    templates = _const(table, chroma_w.device)
    dots = torch.einsum("bwc,tc->bwt", chroma_w, templates)
    norms = torch.linalg.norm(templates, dim=-1)
    cnorm = torch.linalg.norm(chroma_w, dim=-1, keepdim=True) + 1e-12
    return dots / norms / cnorm


def _window_triads(active: torch.Tensor, window_cols: int):
    """Per-window triad match: (root_pc, quality 0=maj/1=min/2=dim, votable)."""
    chroma_w = _window_chroma(active, window_cols)
    best = torch.argmax(_template_scores(chroma_w, _TRIADS), dim=-1)
    empty = chroma_w.sum(dim=-1) < 0.5
    votable = (~empty) & ((chroma_w > 0.5).sum(dim=-1) >= 2)
    return best % 12, best // 12, votable


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx[:, None])[:, 0]


def classify_keys(piano_roll: torch.Tensor, fs: int = 100,
                  window_size: float = 1.28, disambiguate_relative: bool = True):
    """Krumhansl-Schmuckler key finding on the whole excerpt; returns
    (key_index (B,), correlation (B,), profile_row (B,))."""
    active = _active_notes(piano_roll)
    chroma = _chroma(active).sum(dim=-1)                       # (B, 12)
    profiles = _const(_KEY_PROFILES, piano_roll.device)
    corr = _pearson(chroma[:, None, :], profiles[None, :, :])  # (B, 24)
    best = torch.argmax(corr, dim=-1)

    window_cols = int(round(window_size * fs))
    if disambiguate_relative and active.shape[-1] >= window_cols:
        root, quality, votable = _window_triads(active, window_cols)
        maj_pc = torch.where(best < 12, best, (best + 3) % 12)
        min_pc = (maj_pc + 9) % 12
        n_maj = (votable & (quality == 0) & (root == maj_pc[:, None])).sum(dim=-1)
        n_min = (votable & (quality == 1) & (root == min_pc[:, None])).sum(dim=-1)
        first = torch.argmax(votable.int(), dim=-1)
        f_ok = _take(votable, first)
        f_root = _take(root, first)
        f_qual = _take(quality, first)
        s_maj = 2 * n_maj + (f_ok & (f_root == maj_pc) & (f_qual == 0)).long()
        s_min = 2 * n_min + (f_ok & (f_root == min_pc) & (f_qual == 1)).long()
        best = torch.where(s_min > s_maj, 12 + min_pc,
                           torch.where(s_maj > s_min, maj_pc, best))

    best_corr = _take(corr, best)
    key_idx = _const(_PROFILE_KEYIDX, piano_roll.device, torch.long)[best]
    is_empty = chroma.sum(dim=-1) < 0.5
    key_idx = torch.where(is_empty, torch.full_like(key_idx, KEY_DICT["no key"]),
                          key_idx)
    best_corr = torch.where(is_empty, torch.zeros_like(best_corr), best_corr)
    return key_idx, best_corr, best


def get_chords(piano_roll: torch.Tensor, given_key=None, fs: int = 100,
               window_size: float = 1.28, return_key: bool = False,
               templates: str = "triads"):
    """Roman-numeral chord tags per ``window_size`` window: (B, W) int32 in
    [0, 7]; optionally the detected key index and its correlation."""
    window_cols = int(round(window_size * fs))
    active = _active_notes(piano_roll)
    key_idx, key_corr, profile_row = classify_keys(
        piano_roll, fs=fs, window_size=window_size)
    if given_key is not None:
        profile_row = torch.as_tensor(given_key, dtype=torch.long,
                                      device=piano_roll.device).expand(
                                          profile_row.shape)

    chroma_w = _window_chroma(active, window_cols)            # (B, W, 12)
    table = (np.concatenate([_TRIADS, _SEVENTHS], axis=0)
             if templates == "sevenths" else _TRIADS)
    best_triad = torch.argmax(_template_scores(chroma_w, table), dim=-1)
    root_pc = best_triad % 12

    tonic_pc = profile_row % 12
    interval = (root_pc - tonic_pc[:, None]) % 12
    degree = _const(_SEMITONE2DEGREE, piano_roll.device, torch.long)[interval]

    empty = chroma_w.sum(dim=-1) < 0.5
    if given_key is None:
        empty = empty | (key_idx == KEY_DICT["no key"])[:, None]
    tags = torch.where(empty, torch.zeros_like(degree), degree).to(torch.int32)
    if return_key:
        return tags, key_idx, key_corr
    return tags
