"""Rotary position embeddings (partial-dim, interleaved-pair convention).

Port of ``rule_guided_music_tpu/ops/rotary.py:24-60``, which matches the
`rotary-embedding-torch` convention of the reference: for head dim D the
rotary dim is R = D // 2; frequencies are ``1 / 10000**(2i/R)``; rotation
acts on interleaved pairs (0,1), (2,3), ... of the first R dims; the other
D - R dims pass through.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RotaryTable(NamedTuple):
    cos: torch.Tensor  # (N, R) float32
    sin: torch.Tensor  # (N, R) float32
    rot_dim: int


def make_rotary_table(seq_len: int, rot_dim: int, theta: float = 10000.0,
                      device="cpu") -> RotaryTable:
    """Precompute cos/sin tables for positions [0, seq_len) (float64 on the
    host, float32 on ``device``)."""
    if rot_dim % 2:
        raise ValueError(f"rotary dim must be even, got {rot_dim}")
    freqs = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    angles = np.arange(seq_len, dtype=np.float64)[:, None] * freqs[None, :]
    angles = np.repeat(angles, 2, axis=-1)
    as_t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return RotaryTable(cos=as_t(np.cos(angles)), sin=as_t(np.sin(angles)),
                       rot_dim=rot_dim)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    pairs = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, table: RotaryTable) -> torch.Tensor:
    """Rotate x shaped (..., N, H, D) (the sequence axis third from last,
    the layout attention uses here), D >= rot_dim, in x's dtype."""
    rot_dim = table.cos.shape[-1]
    n = x.shape[-3]
    cos = table.cos[:n, None, :].to(x.dtype)
    sin = table.sin[:n, None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x_rot = x_rot * cos + _rotate_half_interleaved(x_rot) * sin
    return torch.cat([x_rot, x_pass], dim=-1)
