"""Synthetic structured rolls and the fixture npz reader.

Copied from ``rule_guided_music_tpu/utils/fixtures.py`` (``make_rolls``
unchanged); the reader returns flat parameter dicts, which is what the
port's ``convert.py`` takes.
"""

from __future__ import annotations

import numpy as np

# C-major scale pitches across the staff octaves
SCALE = [48, 50, 52, 53, 55, 57, 59, 60, 62, 64, 65, 67, 69, 71, 72]


def make_rolls(n: int, length: int = 1024, seed: int = 0) -> np.ndarray:
    """(n, 3, 128, length) normalized rolls: C-major arpeggio texture,
    ~3 simultaneous voices, a fresh chord every ~16 columns.

    Each roll commits to its own random 6-pitch subset of the scale, so the
    *per-sample* pitch histogram varies across the dataset — a learned
    model's samples then differ in pitch content, which is exactly the
    signal SCG candidate selection needs (an i.i.d.-chords dataset would
    make every sample's histogram identical by law of large numbers and
    leave guidance nothing to select on).

    Each roll also commits to a *density mode* (chord size 2-5, its own
    note rate): vertical/horizontal note density varies per sample at a
    scale that survives the f8 latent compression, giving nd-targeted SCG
    a real selection signal (pitch-class identity is sub-latent-row at f8
    and partly blurred by a small VAE, density is not)."""
    rng = np.random.default_rng(seed)
    rolls = np.full((n, 3, 128, length), -1.0, dtype=np.float32)
    for i in range(n):
        palette = rng.choice(SCALE, size=6, replace=False)
        voices = int(rng.integers(2, 6))            # per-roll density mode
        gap_lo = int(rng.integers(8, 16))
        t = 0
        while t < length - 16:
            chord = rng.choice(palette, size=min(voices, len(palette)),
                               replace=False)
            dur = int(rng.integers(12, 24))
            vel = rng.uniform(0.2, 0.6)
            for p in chord:
                rolls[i, 0, p, t:t + dur] = vel
                rolls[i, 1, p, t] = 1.0
            t += int(rng.integers(gap_lo, gap_lo + 8))
    return rolls


def load_fixture_npz(path: str):
    """Fixture .npz -> {'vae': flat, 'dit': flat, 'scale': float}; the flat
    dicts map Flax parameter paths ('params/a/b') to arrays, the input of
    ``convert.py``."""
    data = np.load(path)
    out = {part: {k[len(part) + 1:]: data[k] for k in data.files
                  if k.startswith(part + "/")}
           for part in ("vae", "dit")}
    out["scale"] = float(data["scale_factor"])
    return out
