"""ADM UNet family of the pixel-space path.

Port of ``rule_guided_music_tpu/models/unet.py`` (reference
guided_diffusion/unet.py:407-694): the pixel-space denoiser
:class:`UNetModel` and the super-resolution :class:`SuperResModel`. The
state is the (3, 128, 128) roll at fs=12.5 itself, with no VAE.

NCHW throughout (the JAX package is NHWC inside and NCHW at its API).
Module names are the JAX tree's (``down_{l}_res_{i}.in_norm``,
``mid_attn.qkv``, ``up_{l}_upsample`` ...), so ``convert.unet_state_dict``
only renames leaves. Resampling: nearest 2x upsampling, 2x2 average
pooling, a stride-2 conv with padding 1, and for :class:`SuperResModel`
bilinear upsampling without corner alignment, as ``jax.image.resize``
computes them.

On the card both hand-written kernels run here. Attention goes through
``ops.attention.sdpa`` on strided (B, N, H, D) views of one qkv tensor,
so every ``AttentionBlock`` launches kernel 1 (at ``sample_pixel``'s
defaults: N=1024 with D=64, N=256 with D=96, N=64 with D=128). Every
GroupNorm that a SiLU follows directly computes exactly kernel 2's
function with eps 1e-5 and goes through it (``FusedNormSwish``):
``ResBlock.in_norm``, ``out_norm`` where the embedding is added before it
(``use_scale_shift_norm=False``), and the model's final ``out_norm``. The
scale-shift ``out_norm`` stays ``F.group_norm``, then the per-example
modulation, then ``F.silu``; the ``AttentionBlock`` norm has no SiLU after
it and stays ``F.group_norm``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from .layers import timestep_embedding
from .vae import FusedNormSwish, _num_groups

EPS = 1e-5


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def _zero(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    """ADM ResBlock with the timestep embedding as scale-shift norm
    conditioning or added before ``out_norm`` (unet.py:143-247); ``up`` or
    ``down`` resample after ``in_norm``."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_norm = FusedNormSwish(in_channels, eps=EPS)
        self.in_conv = _conv3(in_channels, out_channels)
        self.emb_proj = nn.Linear(
            emb_channels, out_channels * (2 if use_scale_shift_norm else 1))
        if use_scale_shift_norm:
            self.out_norm = nn.GroupNorm(_num_groups(out_channels), out_channels,
                                         eps=EPS)
        else:
            self.out_norm = FusedNormSwish(out_channels, eps=EPS)
        self.out_conv = _zero(_conv3(out_channels, out_channels))
        self.skip = (nn.Conv2d(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def _resample(self, v: torch.Tensor) -> torch.Tensor:
        if self.up:
            return _upsample(v)
        if self.down:
            return F.avg_pool2d(v, 2)
        return v

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self._resample(self.in_norm(x))
        x = self._resample(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + emb_out)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over a feature map (unet.py:259-305): heads
    of ``num_head_channels`` where given, else ``num_heads`` heads."""

    def __init__(self, channels: int, num_heads: int = 4,
                 num_head_channels: int = -1):
        super().__init__()
        self.heads = (num_heads if num_head_channels == -1
                      else max(channels // num_head_channels, 1))
        self.norm = nn.GroupNorm(_num_groups(channels), channels, eps=EPS)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = _zero(nn.Linear(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        h = self.norm(x).flatten(2).transpose(1, 2)                 # (B, N, C)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, c // self.heads)
        out = sdpa(*qkv.unbind(2))                                   # (B, N, H, D)
        out = self.proj(out.reshape(b, n, c))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class UNetModel(nn.Module):
    """ADM UNet denoiser (unet.py:407-677): ``model(x, t, y)`` on NCHW x,
    float32 NCHW out. ``attention_resolutions`` are downsample factors
    (the CLIs turn "32,16,8" into image_size // r)."""

    def __init__(self, in_channels: int = 3, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 8, 16),
                 channel_mult: Sequence[int] = (1, 1, 2, 3, 4),
                 num_classes: Optional[int] = None, num_heads: int = 4,
                 num_head_channels: int = -1, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = False):
        super().__init__()
        self.model_channels = model_channels
        self.levels = len(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.resblock_updown = resblock_updown
        emb = model_channels * 4
        self.time_embed_0 = nn.Linear(model_channels, emb)
        self.time_embed_2 = nn.Linear(emb, emb)
        self.label_emb = (nn.Embedding(num_classes, emb)
                          if num_classes is not None else None)
        self.conv_in = _conv3(in_channels, model_channels)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(cin, cout, emb, use_scale_shift_norm,
                                           **kw))
            return cout

        def attn(name, c):
            if ds in attention_resolutions:
                self.add_module(name, AttentionBlock(c, num_heads,
                                                     num_head_channels))

        def resample(name, c, **kw):
            if resblock_updown:
                res(name, c, c, **kw)
            else:
                self.add_module(name, _conv3(c, c, stride=2 if "down" in kw else 1))

        ch, ds, skips = model_channels, 1, [model_channels]
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                ch = res(f"down_{level}_res_{i}", ch, model_channels * mult)
                attn(f"down_{level}_attn_{i}", ch)
                skips.append(ch)
            if level != self.levels - 1:
                resample(f"down_{level}_downsample", ch, down=True)
                skips.append(ch)
                ds *= 2
        res("mid_res_1", ch, ch)
        self.mid_attn = AttentionBlock(ch, num_heads, num_head_channels)
        res("mid_res_2", ch, ch)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                ch = res(f"up_{level}_res_{i}", ch + skips.pop(),
                         model_channels * mult)
                attn(f"up_{level}_attn_{i}", ch)
            if level != 0:
                resample(f"up_{level}_upsample", ch, up=True)
                ds //= 2
        self.out_norm = FusedNormSwish(ch, eps=EPS)
        self.out_conv = _zero(_conv3(ch, out_channels))

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """ResBlock ``name``, then its attention block where there is one."""
        h = getattr(self, name.replace("_attn_", "_res_"))(h, emb)
        attn = getattr(self, name, None)
        return attn(h) if attn is not None else h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        emb = self.time_embed_0(
            timestep_embedding(t, self.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if self.label_emb is not None and y is not None:
            emb = emb + self.label_emb(y.long())
        h = self.conv_in(x.to(dtype))
        hs = [h]
        for level in range(self.levels):
            for i in range(self.num_res_blocks):
                h = self._block(f"down_{level}_attn_{i}", h, emb)
                hs.append(h)
            if level != self.levels - 1:
                down = getattr(self, f"down_{level}_downsample")
                h = down(h, emb) if self.resblock_updown else down(h)
                hs.append(h)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h, emb)), emb)
        for level in reversed(range(self.levels)):
            for i in range(self.num_res_blocks + 1):
                h = self._block(f"up_{level}_attn_{i}",
                                torch.cat([h, hs.pop()], dim=1), emb)
            if level != 0:
                up = getattr(self, f"up_{level}_upsample")
                h = up(h, emb) if self.resblock_updown else up(_upsample(h))
        return self.out_conv(self.out_norm(h)).float()


class SuperResModel(nn.Module):
    """A UNet conditioned on a low-resolution roll, upsampled bilinearly
    to x's size and concatenated as channels (unet.py:677-694); ``unet``
    takes ``in_channels`` = x's channels + the low-res roll's."""

    def __init__(self, unet: UNetModel):
        super().__init__()
        self.unet = unet

    def forward(self, x: torch.Tensor, t: torch.Tensor, low_res: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        low = F.interpolate(low_res, size=x.shape[2:], mode="bilinear",
                            align_corners=False)
        return self.unet(torch.cat([x, low.to(x.dtype)], dim=1), t, y)
