"""KL-VAE (f8) as ``nn.Module``s.

Port of ``rule_guided_music_tpu/models/vae.py`` (taming/modules/
diffusionmodules/model.py Encoder and Decoder, klvae_pedal.py): ch 128,
ch_mult (1,2,2,4), 2 res-blocks, mid attention, GroupNorm(32, eps 1e-6) +
swish. The decoder maps (4, 16, 16) chunk latents to (3, 128, 128)
piano-roll chunks, the encoder maps chunks to the 8 moments (mean and
log-variance) of the latent posterior. Both run NCHW, as PyTorch's
convolutions want, and their submodules carry the reference's torch names
(``decoder.up.{level}.block.{i}.norm1``, ``encoder.down.{level}.
downsample.conv``, ...), so a ``state_dict`` has the key layout of the
reference's VAE checkpoints.

Every ResnetBlock ``norm1``/``norm2`` and each ``norm_out`` go through
``ops.groupnorm_swish`` (the CUDA kernel on the card); the mid
``AttnBlock`` keeps a plain ``nn.GroupNorm`` and a plain matmul/softmax, as
the JAX package has no kernel there. :class:`AutoencoderKL` builds the
encoder only when asked (``encoder=True``): the decode-only paths keep
their memory. ``ScoringDecoder`` is the narrower decoder (ch=64) distilled
to rank SCG candidates.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm_swish import groupnorm_swish


def _num_groups(channels: int) -> int:
    """GroupNorm(32) in the reference; gcd(c, 32) for narrower test widths."""
    return 32 if channels % 32 == 0 else math.gcd(channels, 32)


class FusedNormSwish(nn.Module):
    """GroupNorm + swish; ``weight``/``bias`` named as ``nn.GroupNorm``'s.
    ``eps`` is the VAE's 1e-6 unless given (the UNet's is 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = _num_groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm_swish(x, self.weight, self.bias, self.num_groups, self.eps)


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


class Downsample(nn.Module):
    """Stride-2 3x3 conv after a (0, 1) pad on the right and bottom, as the
    reference pads; ``Conv2d(padding=...)`` pads symmetrically."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


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


class _DownLevel(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class Encoder(nn.Module):
    """(N, 3, H, W) chunks -> (N, 2 z_channels, H/8, W/8) moments (with
    ``double_z``)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4, double_z: bool = True):
        super().__init__()
        self.conv_in = _conv3(in_channels, ch)
        block_in = ch
        levels = []
        for i_level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            last = i_level == len(ch_mult) - 1
            levels.append(_DownLevel(blocks,
                                     None if last else Downsample(block_in)))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = FusedNormSwish(block_in)
        self.conv_out = _conv3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i_level, level in enumerate(self.down):
            for block in level.block:
                h = block(h)
            if i_level != len(self.down) - 1:
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h))


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


class DiagonalGaussian:
    """Diagonal Gaussian over latents from concatenated (mean, logvar)
    moments along ``dim`` (taming/modules/distributions/distributions.py:
    24-62)."""

    def __init__(self, moments: torch.Tensor, dim: int = 1):
        self.mean, logvar = torch.chunk(moments, 2, dim=dim)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar,
                               dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=dims)


class AutoencoderKL(nn.Module):
    """The KL autoencoder: ``decode(z)`` maps (B, 4, H/8, W/8) NCHW latents
    to (B, 3, H, W) float32; with ``encoder=True``, ``encode_moments(x)``
    maps (B, 3, H, W) to the (B, 8, H/8, W/8) float32 posterior moments."""

    def __init__(self, embed_dim: int = 4, z_channels: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), num_res_blocks: int = 2,
                 out_ch: int = 3, encoder: bool = False):
        super().__init__()
        self.ch = ch
        self.encoder = None
        if encoder:
            self.encoder = Encoder(ch=ch, ch_mult=ch_mult,
                                   num_res_blocks=num_res_blocks,
                                   in_channels=out_ch, z_channels=z_channels)
            self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.decoder = Decoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               out_ch=out_ch, z_channels=z_channels)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        if self.encoder is None:
            raise ValueError("this AutoencoderKL was built without its "
                             "encoder: pass encoder=True")
        x = x.to(self.quant_conv.weight.dtype)
        return self.quant_conv(self.encoder(x)).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).float()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)


class ScoringDecoder(AutoencoderKL):
    """Reduced-width decoder for SCG candidate scoring
    (``rule_guided_music_tpu/models/vae.py::ScoringDecoder``):
    ``post_quant_conv`` then the decoder at ch=64, distilled to match the
    full decoder's outputs. It only ranks candidates; the final decode
    stays full. Same NCHW ``decode`` as :class:`AutoencoderKL`, and the
    same parameter names."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4):
        super().__init__(embed_dim=z_channels, z_channels=z_channels, ch=ch,
                         ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         out_ch=out_ch)
