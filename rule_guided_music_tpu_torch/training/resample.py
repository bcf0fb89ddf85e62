"""Timestep schedule samplers: uniform and loss-second-moment importance.

A copy of ``rule_guided_music_tpu/training/resample.py`` (reference
guided_diffusion/resample.py), which imports nothing of JAX: host-side
numpy drawing from the caller's ``np.random.Generator``, so the same
generator state gives the same timesteps and weights in both packages.
``LossSecondMomentResampler`` keeps its history as a ring buffer per
timestep, filled a whole batch at a time (argsort and ranks within each
run of equal t); the RMS it samples by does not depend on slot order.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


def create_named_schedule_sampler(name: str, num_timesteps: int) -> "ScheduleSampler":
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(ABC):
    """Importance distribution over timesteps; unbiased via loss weights."""

    @abstractmethod
    def weights(self) -> np.ndarray:
        ...

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Returns (timesteps int32 (B,), loss weights float32 (B,))."""
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_all_losses(self, ts, losses):
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    """Importance-sample t proportional to sqrt(E[loss^2]) with a uniform
    floor, after a warmup of ``history_per_term`` observations per t.

    Same sampling distribution as the reference (resample.py:124-154) but a
    different implementation: the per-timestep history is a vectorized ring
    buffer — a whole batch of (t, loss) observations is scattered into the
    buffers in one shot (argsort + within-group ranks), instead of a Python
    loop that shifts each history array.  The RMS statistic is invariant to
    slot order, so ring semantics ("keep the most recent H losses per t")
    reproduce the reference's shift-buffer distribution exactly.
    """

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            [num_timesteps, history_per_term], dtype=np.float64
        )
        self._write_pos = np.zeros([num_timesteps], dtype=np.int64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        n, h = self.num_timesteps, self.history_per_term
        if not self._warmed_up():
            return np.ones([n], dtype=np.float64)
        rms = np.sqrt(
            np.einsum("th,th->t", self._loss_history, self._loss_history) / h
        )
        p = rms / rms.sum()
        u = self.uniform_prob
        return (1.0 - u) * p + u / n

    def update_with_all_losses(self, ts, losses):
        ts = np.asarray(ts, dtype=np.int64).ravel()
        losses = np.asarray(losses, dtype=np.float64).ravel()
        if ts.size == 0:
            return
        h = self.history_per_term
        order = np.argsort(ts, kind="stable")
        ts_s, losses_s = ts[order], losses[order]
        # rank of each observation within its run of equal timesteps, so
        # repeated t in one batch land in consecutive ring slots (later
        # observations overwrite older ones once a run exceeds h — the
        # "most recent h" invariant)
        idx = np.arange(ts_s.size)
        run_start = np.where(np.diff(ts_s, prepend=ts_s[0] - 1) != 0, idx, 0)
        rank = idx - np.maximum.accumulate(run_start)
        slots = (self._write_pos[ts_s] + rank) % h
        self._loss_history[ts_s, slots] = losses_s
        uniq, counts = np.unique(ts_s, return_counts=True)
        self._write_pos[uniq] = (self._write_pos[uniq] + counts) % h
        self._loss_counts[uniq] = np.minimum(self._loss_counts[uniq] + counts,
                                             h)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())
