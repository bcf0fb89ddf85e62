"""Seeded synthetic piano rolls, the benchmark's musical input: C-major
arpeggio texture, each roll with its own 6-pitch palette and density mode
(2-5 voices, its own note rate), so rule targets and SCG scores vary from
roll to roll. Normalized (n, 3, 128, length) float32 in [-1, 1]."""

import numpy as np

SCALE = [48, 50, 52, 53, 55, 57, 59, 60, 62, 64, 65, 67, 69, 71, 72]


def make_rolls(n: int, length: int, rng: np.random.Generator) -> np.ndarray:
    rolls = np.full((n, 3, 128, length), -1.0, dtype=np.float32)
    for i in range(n):
        palette = rng.choice(SCALE, size=6, replace=False)
        voices = int(rng.integers(2, 6))
        gap_lo = int(rng.integers(8, 16))
        t = 0
        while t < length - 16:
            chord = rng.choice(palette, size=min(voices, len(palette)), replace=False)
            dur = int(rng.integers(12, 24))
            vel = rng.uniform(0.2, 0.6)
            for p in chord:
                rolls[i, 0, p, t:t + dur] = vel
                rolls[i, 1, p, t] = 1.0
            t += int(rng.integers(gap_lo, gap_lo + 8))
    return rolls


def to_uint8(rolls: np.ndarray) -> np.ndarray:
    """The stored form the training loader reads: (x + 1) * 63.5, rounded."""
    return np.round((rolls + 1.0) * 63.5).astype(np.uint8)
