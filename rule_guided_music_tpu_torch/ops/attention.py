"""Scaled-dot-product attention dispatch over (B, N, H, D) tensors.

Port of ``rule_guided_music_tpu/ops/attention.py``. Every call goes through
the flash-attention wrapper: on a CUDA tensor it launches the hand-written
kernel (or raises), on a CPU tensor it computes the plain einsum version.
No library attention is called on this path.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, N, H, D) tensors; returns (B, N, H, D)."""
    return flash_attention(q, k, v)
