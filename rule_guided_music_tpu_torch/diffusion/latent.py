"""Latent <-> pixel bridges between the denoiser and the KL-VAE decoder.

Port of ``rule_guided_music_tpu/diffusion/latent.py:19-54``. The denoiser
works on (B, 4, 128, 16) latent images, 8 chunk latents of a 10.24 s excerpt
concatenated along time; chunk order is "1st second for all batch, 2nd
second for all batch, ..." (gaussian_diffusion.py:1347-1395).
"""

from __future__ import annotations

from typing import Callable

import torch


def latent_to_chunks(z: torch.Tensor) -> torch.Tensor:
    """(B, C, T, P) latent image -> (n*B, C, P, P) square chunk latents."""
    b, c, t, p = z.shape
    n = t // p
    z = z.permute(0, 1, 3, 2).reshape(b, c, p, n, p)      # (B, C, P, n, P)
    return z.permute(3, 0, 1, 2, 4).reshape(n * b, c, p, p)


def chunks_to_pixels(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n*B, C, H, W) decoded chunks -> (B, C, H, n*W) long piano roll."""
    nb, c, h, w = x.shape
    b = nb // n
    x = x.reshape(n, b, c, h, w).permute(1, 2, 3, 0, 4)   # (B, C, H, n, W)
    return x.reshape(b, c, h, n * w)


def make_decode_fn(vae_decode: Callable, scale_factor: float = 1.0) -> Callable:
    """Latent image -> long piano roll (reference :1347-1358);
    ``vae_decode(chunks)`` maps (N, 4, P, P) to (N, 3, 8P, 8P)."""

    def decode(z: torch.Tensor) -> torch.Tensor:
        n = z.shape[2] // z.shape[3]
        return chunks_to_pixels(vae_decode(latent_to_chunks(z / scale_factor)), n)

    return decode
