"""Building blocks of the DiT denoisers (rotary and 2-D) as ``nn.Module``s.

Port of ``rule_guided_music_tpu/models/layers.py``. Submodules carry the
reference's torch names (``x_embedder.MLP.0``, ``t_embedder.mlp.2``,
``blocks.{i}.adaLN_modulation.1``, ``attn.qkv`` ...), so a ``state_dict`` of
the port has the key layout of the reference's DiT checkpoints
(guided_diffusion/dit.py). A module computes in the dtype of its parameters:
cast the model with ``.to(torch.bfloat16)`` for bf16 serving. The 2-D DiT
patchifies with ``PatchEmbed`` (or ``FlattenNorm``) and adds the numpy
sin-cos tables below.

Attention keeps the (B, N, H, D) layout of the JAX package and goes through
``ops.attention.sdpa``, so on the card every block launches the CUDA
flash-attention kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.rotary import RotaryTable, apply_rotary
from ..parallel.comm import Axis, copy_to, gather, gather_split, reduce_from, shard

_ONE = Axis(None)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift, broadcast over tokens."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings, cos-first, float32 (dit.py:46-65)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size), nn.SiLU(),
            nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(emb.to(_dtype(self)))


class LabelEmbedder(nn.Module):
    """Class-label embedding; one extra (null) row when dropout_prob > 0.
    Under ``train=True`` each label becomes the null label with probability
    ``dropout_prob`` (classifier-free guidance's label dropout, JAX
    layers.py:78-100): ``drop``, a bool (B,) mask, where the caller gives
    one, else drawn from ``generator``."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        if train and self.dropout_prob > 0:
            if drop is None:
                drop = torch.rand(labels.shape, generator=generator,
                                  device=labels.device) < self.dropout_prob
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels.long())


class FlattenPatchify1D(nn.Module):
    """(B, C, H, W) -> (B, H*W/patch, hidden): each token covers ``patch``
    consecutive (pitch, channel) cells of one time step (dit.py:200-227);
    256 tokens of 32 features for the (4, 128, 16) latent."""

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int = 8):
        super().__init__()
        self.patch_size = patch_size
        self.MLP = nn.Sequential(
            nn.Linear(in_channels * patch_size, 256), nn.SiLU(),
            nn.Linear(256, hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, h * w // self.patch_size,
                                          self.patch_size * c)
        return self.MLP(x)


class FlattenNorm(nn.Module):
    """Whole-time-step flatten: (B, C, H, W) -> (B, H, hidden), each token
    one row's C * W cells (dit.py:177-197)."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.MLP = nn.Sequential(nn.Linear(in_features, 256), nn.SiLU(),
                                 nn.Linear(256, hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        return self.MLP(x.permute(0, 2, 1, 3).reshape(b, h, c * w))


class PatchEmbed(nn.Module):
    """2-D patchify by a conv with kernel = stride = patch (dit.py:107-174):
    NCHW in, (B, N, hidden) out, tokens in row-major grid order."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention with optional rotary (dit.py:234-288).

    ``tp`` (a model :class:`Axis`, set by ``parallel.mesh``): ``qkv.weight``
    holds this rank's 3C/tp rows and ``proj.weight`` its C/tp columns. The
    qkv rows are q, k and v of every head in turn, so the column-parallel
    outputs are gathered over the axis and each rank keeps its own H/tp
    heads of q, k and v; the kernel gets them as plain local tensors, and
    the row-parallel projection's partial sums are all-reduced before the
    bias. ``seq`` (sequence parallelism): this rank's N/seq tokens come
    in; q, k and v are gathered over the axis to the whole sequence for
    the kernel, and this rank's query rows are kept."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.tp = self.seq = _ONE

    def forward(self, x: torch.Tensor,
                rotary: Optional[RotaryTable] = None) -> torch.Tensor:
        b, n, c = x.shape
        heads, tp = self.num_heads, self.tp
        qkv = gather_split(self.qkv(copy_to(x, tp)), tp, -1)
        qkv = shard(qkv.reshape(b, n, 3, heads, c // heads), tp, 3)
        qkv = gather_split(qkv, self.seq, 1)
        q, k, v = qkv.unbind(2)                               # (B, N, H, D)
        if rotary is not None:
            q, k = apply_rotary(q, rotary), apply_rotary(k, rotary)
        out = shard(sdpa(q, k, v), self.seq, 1)
        out = out.reshape(b, n, -1)
        if tp.size == 1:
            return self.proj(out)
        return reduce_from(F.linear(out, self.proj.weight), tp) + self.proj.bias


class Mlp(nn.Module):
    """``fc2(gelu(fc1(x)))``; with ``tp``, fc1 column-parallel and fc2
    row-parallel (its partial sums all-reduced before the bias)."""

    def __init__(self, hidden_size: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(hidden_size * mlp_ratio)
        self.fc1 = nn.Linear(hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, hidden_size)
        self.tp = _ONE

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp.size == 1:
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        h = F.gelu(self.fc1(copy_to(x, tp)), approximate="tanh")
        return reduce_from(F.linear(h, self.fc2.weight), tp) + self.fc2.bias


def _modulation(module: nn.Module, c: torch.Tensor, n: int):
    """The adaLN chunks: ``adaLN_modulation(c).chunk(n)``; with ``tp`` the
    linear holds this rank's rows and its outputs are gathered."""
    tp = module.tp
    return gather(module.adaLN_modulation(copy_to(c, tp)), tp, -1).chunk(n, dim=-1)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block (dit.py:291-336): the 6-way modulation
    is zero-initialised, so a fresh block is the identity."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.attn = Attention(hidden_size, num_heads)
        self.norm2 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.mlp = Mlp(hidden_size, mlp_ratio)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)
        self.tp = _ONE

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                rotary: Optional[RotaryTable] = None) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = _modulation(self, c, 6)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(self.norm1(x), shift_msa, scale_msa), rotary)
        x = x + gate_mlp[:, None, :] * self.mlp(
            modulate(self.norm2(x), shift_mlp, scale_mlp))
        return x


class FinalLayer(nn.Module):
    """Zero-initialised adaLN output head (dit.py:339-376)."""

    def __init__(self, hidden_size: int, out_features: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.linear = nn.Linear(hidden_size, out_features)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))
        for lin in (self.linear, self.adaLN_modulation[1]):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)
        self.tp = _ONE

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = _modulation(self, c, 2)
        return self.linear(modulate(self.norm_final(x), shift, scale))



class ClassifierHead(nn.Sequential):
    """The classifier head's bottleneck MLP: Linear to hidden/4, SiLU,
    Linear to the classes (layers.py:282-296). The JAX head starts with an
    affine LayerNorm (eps 1e-6); the reference's checkpoints keep that norm
    beside this MLP (``norm`` and ``classifier_head.{0,2}``), so the
    classifier owns it under that name and applies it first."""

    def __init__(self, hidden_size: int, num_classes: int):
        super().__init__(nn.Linear(hidden_size, hidden_size // 4), nn.SiLU(),
                         nn.Linear(hidden_size // 4, num_classes))


# fixed sin-cos positional tables (dit.py:839-886), numpy float64


def get_1d_sincos_pos_embed(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", positions.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    grid = np.stack(np.meshgrid(gw, gh), axis=0)  # w first, as the reference
    grid = grid.reshape([2, 1, grid_h, grid_w])
    emb_h = get_1d_sincos_pos_embed(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)
