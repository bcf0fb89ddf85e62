"""Plots of a chain's record and piano-roll images (``--record``).

The port's copy of ``rule_guided_music_tpu/utils/viz.py`` (reference
guided_diffusion/midi_util.py:{plot_record:241-249,
visualize_piano_roll:159-211}): host-side matplotlib, imported inside each
function, so nothing else needs it (the card's image has none).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def plot_record(values, title: str, save_dir: str):
    """Plot a per-step diagnostic series (t descending) to <dir>/<title>.png.

    ``values``: array of per-step scalars ordered from t=T-1 down to t_end
    (the sampler's record dict layout), or a list of (t, value) pairs.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = np.asarray(values)
    if values.ndim == 2 and values.shape[1] == 2:
        ts, ys = values[:, 0], values[:, 1]
    else:
        ts = np.arange(len(values))[::-1]
        ys = values
    plt.figure(figsize=(6, 3))
    plt.plot(ts, ys)
    plt.gca().invert_xaxis()
    plt.title(title)
    plt.xlabel("t")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{title}.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
    return path


def plot_records(records: Dict[str, np.ndarray], save_dir: str):
    """Plot every series in a sampler record dict (log_prob, loss_std, ...).

    Scalar-per-step series get line plots; the (steps, k, B) per-candidate
    loss matrix gets bar charts for a few representative steps (the
    reference's debug bar charts, gaussian_diffusion.py:622-632); the
    (steps, B, C, H, W) state stack is skipped here (dumped separately as
    piano-roll images by the caller).
    """
    paths = []
    for name, series in records.items():
        arr = np.asarray(series)
        safe = name.replace("/", "_")
        if name == "state":
            continue
        if name == "candidate_log_prob" and arr.ndim == 3:
            paths += plot_candidate_bars(arr, save_dir)
            continue
        if arr.ndim == 1 or (arr.ndim == 2 and arr.shape[1] == 2):
            paths.append(plot_record(arr, safe, save_dir))
    return paths


def plot_candidate_bars(candidate_log_prob: np.ndarray, save_dir: str,
                        num_steps: int = 4):
    """Bar-chart the k-candidate log-probs for a few steps (example 0)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = np.linspace(0, len(candidate_log_prob) - 1, num_steps,
                        dtype=int)
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for s in steps:
        vals = candidate_log_prob[s, :, 0]
        if not np.any(vals):
            continue  # unguided step (empty record)
        plt.figure(figsize=(4, 2.5))
        plt.bar(np.arange(len(vals)), vals)
        plt.title(f"candidate log-probs, scan step {s}")
        plt.xlabel("candidate")
        path = os.path.join(save_dir, f"candidates_step{s}.png")
        plt.tight_layout()
        plt.savefig(path, dpi=120)
        plt.close()
        paths.append(path)
    return paths


def save_piano_roll_image(roll: np.ndarray, path: str, vmax: int = 127):
    """Save a (128, T) or (C, 128, T) piano roll as an image
    (midi_util.py:75-80 behavior)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if roll.ndim == 3:
        roll = roll[0]
    width = max(roll.shape[-1] // 128 * 3, 3)
    plt.figure(figsize=(width, 3))
    plt.imshow(roll[::-1], vmin=0, vmax=vmax, aspect="auto")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()
    return path
