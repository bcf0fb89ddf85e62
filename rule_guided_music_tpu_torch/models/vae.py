"""KL-VAE (f8) decoder as ``nn.Module``s.

Port of the decode half of ``rule_guided_music_tpu/models/vae.py``
(taming/modules/diffusionmodules/model.py Decoder, klvae_pedal.py): ch 128,
ch_mult (1,2,2,4), 2 res-blocks, mid attention, GroupNorm(32, eps 1e-6) +
swish, mapping (4, 16, 16) chunk latents to (3, 128, 128) piano-roll chunks.
It runs NCHW, as PyTorch's convolutions want, and its submodules carry the
reference's torch names (``decoder.up.{level}.block.{i}.norm1``, ...), so a
``state_dict`` has the key layout of the reference's VAE checkpoints.

Every ResnetBlock ``norm1``/``norm2`` and the decoder's ``norm_out`` go
through ``ops.groupnorm_swish`` (the CUDA kernel on the card); the mid
``AttnBlock`` keeps a plain ``nn.GroupNorm`` and a plain matmul/softmax, as
the JAX package has no kernel there. The encoder waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm_swish import groupnorm_swish


def _num_groups(channels: int) -> int:
    """GroupNorm(32) in the reference; gcd(c, 32) for narrower test widths."""
    return 32 if channels % 32 == 0 else math.gcd(channels, 32)


class FusedNormSwish(nn.Module):
    """GroupNorm + swish; ``weight``/``bias`` named as ``nn.GroupNorm``'s."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = _num_groups(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm_swish(x, self.weight, self.bias, self.num_groups, 1e-6)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = FusedNormSwish(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = FusedNormSwish(out_channels)
        self.conv2 = _conv3(out_channels, out_channels)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(_num_groups(channels), channels, eps=1e-6)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)      # (B, HW, C)
        k = self.k(hn).reshape(b, c, h * w)                      # (B, C, HW)
        v = self.v(hn).reshape(b, c, h * w)
        attn = torch.bmm(q, k) * (c ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.bmm(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)


class _UpLevel(nn.Module):
    def __init__(self, blocks, upsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if upsample is not None:
            self.upsample = upsample


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = _conv3(z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = [None] * len(ch_mult)
        for i_level in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i_level]
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            levels[i_level] = _UpLevel(
                blocks, Upsample(block_in) if i_level != 0 else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = FusedNormSwish(block_in)
        self.conv_out = _conv3(block_in, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for block in level.block:
                h = block(h)
            if i_level != 0:
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """Decode half of the KL autoencoder: ``decode(z)`` maps
    (B, 4, H/8, W/8) NCHW latents to (B, 3, H, W) float32."""

    def __init__(self, embed_dim: int = 4, z_channels: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), num_res_blocks: int = 2,
                 out_ch: int = 3):
        super().__init__()
        self.decoder = Decoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               out_ch=out_ch, z_channels=z_channels)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).float()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)
