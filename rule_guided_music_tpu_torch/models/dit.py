"""DiTRotary, the flagship denoiser, and its registry.

Port of ``rule_guided_music_tpu/models/dit.py::DiTRotary`` (reference
dit.py:538-634). Forward contract as there: ``model(x, t, y)`` with x NCHW
``(B, C, H, W)`` (latents ``(B, 4, 128, 16)``), t the denoiser's timestep
values, y optional class labels; output NCHW float32 with 2C channels when
``learn_sigma``. The classifiers and the 2-D DiT wait for later slices.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.rotary import RotaryTable, make_rotary_table
from .layers import (
    DiTBlock,
    FinalLayer,
    FlattenPatchify1D,
    LabelEmbedder,
    TimestepEmbedder,
)


def _as_hw(input_size) -> Tuple[int, int]:
    if isinstance(input_size, int):
        return (input_size, input_size)
    if len(input_size) == 1:
        return (input_size[0], input_size[0])
    return tuple(input_size)


class DiTRotary(nn.Module):
    """1-D-patchified DiT with rotary attention (DiTRotary_XL_8: 28 blocks,
    1152 wide, 16 heads of 72)."""

    def __init__(self, input_size: Sequence[int] = (128, 16), patch_size: int = 8,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 3,
                 learn_sigma: bool = False):
        super().__init__()
        self.input_size = _as_hw(input_size)
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.x_embedder = FlattenPatchify1D(in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = (LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
                           if num_classes else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size * self.out_channels)
        self._rotary: Dict[tuple, RotaryTable] = {}

    def rotary_table(self, seq_len: int, device) -> RotaryTable:
        key = (seq_len, str(device))
        if key not in self._rotary:
            head_dim = self.hidden_size // self.num_heads
            self._rotary[key] = make_rotary_table(seq_len, int(head_dim * 0.5),
                                                  device=device)
        return self._rotary[key]

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor = None) -> torch.Tensor:
        dtype = self.final_layer.linear.weight.dtype
        b, _, h, w = x.shape
        tokens = self.x_embedder(x.to(dtype))
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y)
        rotary = self.rotary_table(h * w // self.patch_size, x.device)
        for block in self.blocks:
            tokens = block(tokens, c, rotary)
        out = self.final_layer(tokens, c)
        # unpatchify: (B, N, patch*C) -> (B, C, H', W) (dit.py:608-616)
        out = out.reshape(b, -1, w, self.out_channels)
        return out.permute(0, 3, 1, 2).float()


def _rot(depth, hidden, patch, heads):
    return lambda **kw: DiTRotary(depth=depth, hidden_size=hidden,
                                  patch_size=patch, num_heads=heads, **kw)


DiT_models = {
    "DiTRotary_XL_8": _rot(28, 1152, 8, 16),
    "DiTRotary_S_8": _rot(12, 384, 8, 6),
    "DiTRotary_XS_8": _rot(2, 64, 8, 2),
}
