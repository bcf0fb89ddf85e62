"""DiTRotary, the flagship denoiser, the 2-D DiT, and their registry.

Port of ``rule_guided_music_tpu/models/dit.py::DiTRotary`` (reference
dit.py:538-634) and ``::DiT`` (reference dit.py:379-535). Forward
contract as there: ``model(x, t, y)`` with x NCHW ``(B, C, H, W)``
(latents ``(B, 4, 128, 16)``), t the denoiser's timestep
values, y optional class labels; output NCHW float32 with 2C channels when
``learn_sigma``. ``DiTRotaryClassifier`` (dit.py:250-308) is the
noise-aware classifier of classifier guidance: ``model(x, t)`` gives float32
logits, or ``(key_logits, chord_logits)`` for the chord variant. The 2-D
``DiT`` (pixel space, ``scripts/pixel/cfg_sample_pixel.py``) patchifies
by a conv and adds a fixed sin-cos position table. ``ops.quant.quantize_``
makes the trunk of either denoiser int8. ``DiTClassifier`` (dit.py:
198-247) is the time-conditioned CLS-token classifier of pixel-space
classifier training: the 2-D DiT's embedding and table, no labels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.rotary import RotaryTable, make_rotary_table
from ..parallel.comm import Axis, gather, shard
from .layers import (
    ClassifierHead,
    DiTBlock,
    FinalLayer,
    FlattenNorm,
    FlattenPatchify1D,
    LabelEmbedder,
    PatchEmbed,
    TimestepEmbedder,
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
)


def _as_hw(input_size) -> Tuple[int, int]:
    if isinstance(input_size, int):
        return (input_size, input_size)
    if len(input_size) == 1:
        return (input_size[0], input_size[0])
    return tuple(input_size)


class _RotaryTables:
    """Rotary tables over ``int(head_dim * 0.5)`` dims, one per (sequence
    length, device), made at first use."""

    def rotary_table(self, seq_len: int, device) -> RotaryTable:
        key = (seq_len, str(device))
        if key not in self._rotary:
            head_dim = self.hidden_size // self.num_heads
            self._rotary[key] = make_rotary_table(seq_len, int(head_dim * 0.5),
                                                  device=device)
        return self._rotary[key]


class DiTRotary(_RotaryTables, nn.Module):
    """1-D-patchified DiT with rotary attention (DiTRotary_XL_8: 28 blocks,
    1152 wide, 16 heads of 72). ``train=True`` turns on the label dropout
    (``generator`` or ``drop`` as :class:`LabelEmbedder` takes them);
    ``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, as JAX's ``nn.remat`` per block), where a
    gradient is being taken."""

    def __init__(self, input_size: Sequence[int] = (128, 16), patch_size: int = 8,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 3,
                 learn_sigma: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
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
        self.seq = Axis(None)        # parallel.mesh.sequence_parallel

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.final_layer.linear.weight.dtype
        b, _, h, w = x.shape
        tokens = self.x_embedder(x.to(dtype))
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y, train, generator, drop)
        rotary = self.rotary_table(h * w // self.patch_size, x.device)
        remat = self.remat and torch.is_grad_enabled()
        tokens = shard(tokens, self.seq, 1)
        for block in self.blocks:
            if remat:
                tokens = checkpoint(block, tokens, c, rotary, use_reentrant=False)
            else:
                tokens = block(tokens, c, rotary)
        out = self.final_layer(gather(tokens, self.seq, 1), c)
        # unpatchify: (B, N, patch*C) -> (B, C, H', W) (dit.py:608-616)
        out = out.reshape(b, -1, w, self.out_channels)
        return out.permute(0, 3, 1, 2).float()


class DiT(nn.Module):
    """2-D DiT with a fixed sin-cos position table (dit.py:379-535).

    ``patchify``: conv patches of ``patch_size`` squared (``x_embedder.
    proj``) and the 2-D table over the patch grid; otherwise one token per
    row of the input (``FlattenNorm``, its width W = ``patch_size``) and
    the 1-D table over the rows. The table is a non-persistent buffer in
    float64, cast to the tokens' dtype as JAX casts it, so it is in no
    ``state_dict``. ``train=True`` turns on the label dropout, as in
    :class:`DiTRotary`."""

    def __init__(self, input_size: Sequence[int] = (32, 32), patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 3,
                 learn_sigma: bool = False, patchify: bool = True):
        super().__init__()
        self.input_size = _as_hw(input_size)
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.patchify = patchify
        _embed_2d(self, in_channels, hidden_size, patch_size, patchify)
        out_features = patch_size * (patch_size if patchify else 1) * self.out_channels
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = (LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
                           if num_classes else None)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, out_features)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.final_layer.linear.weight.dtype
        b = x.shape[0]
        h, w = self.input_size
        tokens = self.x_embedder(x.to(dtype))
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            c = c + self.y_embedder(y, train, generator, drop)
        for block in self.blocks:
            tokens = block(tokens, c)
        out = self.final_layer(tokens, c)
        oc = self.out_channels
        if self.patchify:
            p = self.patch_size
            out = out.reshape(b, h // p, w // p, p, p, oc)
            out = torch.einsum("nhwpqc->nchpwq", out).reshape(b, oc, h, w)
        else:
            out = out.reshape(b, out.shape[1], oc, -1).permute(0, 2, 1, 3)
        return out.float()


def _embed_2d(module, in_channels, hidden_size, patch_size, patchify):
    """The 2-D DiT's token embedding and its sin-cos table (a
    non-persistent float64 buffer) on ``module``."""
    h, w = module.input_size
    if patchify:
        module.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        pos = get_2d_sincos_pos_embed(hidden_size, h // patch_size, w // patch_size)
    else:
        module.x_embedder = FlattenNorm(in_channels * w, hidden_size)
        pos = get_1d_sincos_pos_embed(hidden_size, np.arange(h, dtype=np.float32))
    module.register_buffer("pos_embed", torch.as_tensor(pos)[None],
                           persistent=False)


class DiTClassifier(nn.Module):
    """Time-conditioned classifier on a CLS token (dit.py:198-247): the 2-D
    DiT's tokens (conv patches and the 2-D table, or one token a row and
    the 1-D table), a CLS token in front (N = patches + 1: 4097 for
    DiT-S/2-cls on the (3, 128, 128) roll), ``DiTBlock``s without rotary
    and the classifier head on CLS. ``model(x, t)`` gives float32 logits.
    Names as :class:`DiTRotaryClassifier`'s: ``cls_token``, ``norm`` and
    ``classifier_head``, so ``convert.classifier_state_dict`` converts
    JAX's tree."""

    def __init__(self, input_size: Sequence[int] = (128, 16), patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0, num_classes: int = 9,
                 patchify: bool = True):
        super().__init__()
        self.input_size = _as_hw(input_size)
        self.hidden_size = hidden_size
        _embed_2d(self, in_channels, hidden_size, patch_size, patchify)
        self.cls_token = nn.Parameter(torch.randn(1, 1, hidden_size) * 1e-6)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.classifier_head = ClassifierHead(hidden_size, num_classes)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dtype = self.cls_token.dtype
        b = x.shape[0]
        tokens = self.x_embedder(x.to(dtype))
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1).to(tokens.dtype),
                            tokens], dim=1)
        c = self.t_embedder(t)
        for block in self.blocks:
            tokens = block(tokens, c)
        return self.classifier_head(self.norm(tokens[:, 0])).float()


class DiTRotaryClassifier(_RotaryTables, nn.Module):
    """Rotary classifier on a CLS token (dit.py:250-308): 256 patch tokens
    plus CLS, so N = 257, with rotary over all 257 positions; the head reads
    CLS. The chord variant adds a 25-way key head on CLS, and its ``head``
    reads the mean of each of the H // W windows of patch tokens (8 for the
    (4, 128, 16) latent). Names are the reference's: ``cls_token``,
    ``norm``/``classifier_head`` and ``norm_key``/``classifier_head_key``."""

    def __init__(self, input_size: Sequence[int] = (128, 16), patch_size: int = 8,
                 in_channels: int = 4, hidden_size: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, num_classes: int = 9,
                 chord: bool = False):
        super().__init__()
        self.input_size = _as_hw(input_size)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.chord = chord
        self.x_embedder = FlattenPatchify1D(in_channels, hidden_size, patch_size)
        self.cls_token = nn.Parameter(torch.randn(1, 1, hidden_size) * 1e-6)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        self.classifier_head = ClassifierHead(hidden_size, num_classes)
        if chord:
            self.norm_key = nn.LayerNorm(hidden_size, eps=1e-6)
            self.classifier_head_key = ClassifierHead(hidden_size, 25)
        self._rotary: Dict[tuple, RotaryTable] = {}

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        dtype = self.cls_token.dtype
        b, _, h, w = x.shape
        tokens = self.x_embedder(x.to(dtype))
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        c = self.t_embedder(t)
        rotary = self.rotary_table(tokens.shape[1], x.device)
        for block in self.blocks:
            tokens = block(tokens, c, rotary)
        if not self.chord:
            return self.classifier_head(self.norm(tokens[:, 0])).float()
        key_logits = self.classifier_head_key(self.norm_key(tokens[:, 0]))
        windows = tokens[:, 1:].reshape(b, h // w, -1, self.hidden_size).mean(dim=-2)
        chord_logits = self.classifier_head(self.norm(windows))
        return key_logits.float(), chord_logits.float()


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's (and the reference DiT's) initialisation of a
    DiT or a DiT classifier built for training: Xavier-uniform linear and
    patch-conv weights (fans over the receptive field, as flax's) and zero
    biases, N(0, 0.02^2) for the timestep MLP and the label table,
    N(0, 1e-6^2) for a classifier's CLS token, and the adaLN-Zero
    modulations and the final linear at zero (JAX layers.py)."""
    def xavier(w):
        receptive = w[0, 0].numel() if w.dim() > 2 else 1
        fan_out, fan_in = w.shape[0] * receptive, w[0].numel()
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        w.copy_((torch.rand(w.shape, generator=generator, device=w.device)
                 * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            xavier(m.weight)
            if m.bias is not None:
                m.bias.zero_()
    normal = lambda w, std=0.02: w.copy_(std * torch.randn(
        w.shape, generator=generator, device=w.device))
    for lin in (model.t_embedder.mlp[0], model.t_embedder.mlp[2]):
        normal(lin.weight)
    if getattr(model, "y_embedder", None) is not None:
        normal(model.y_embedder.embedding_table.weight)
    if hasattr(model, "cls_token"):
        normal(model.cls_token, 1e-6)
    zero = [b.adaLN_modulation[1] for b in model.blocks]
    if hasattr(model, "final_layer"):
        zero += [model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    for lin in zero:
        lin.weight.zero_()
        lin.bias.zero_()
    return model


def _dit(depth, hidden, patch, heads):
    return lambda **kw: DiT(depth=depth, hidden_size=hidden, patch_size=patch,
                            num_heads=heads, **kw)


def _rot(depth, hidden, patch, heads):
    return lambda **kw: DiTRotary(depth=depth, hidden_size=hidden,
                                  patch_size=patch, num_heads=heads, **kw)


def _cls(depth, hidden, patch, heads):
    return lambda **kw: DiTClassifier(depth=depth, hidden_size=hidden,
                                      patch_size=patch, num_heads=heads, **kw)


def _rot_cls(depth, hidden, patch, heads, chord=False):
    return lambda **kw: DiTRotaryClassifier(depth=depth, hidden_size=hidden,
                                            patch_size=patch, num_heads=heads,
                                            chord=chord, **kw)


DiT_models = {
    "DiT-XL/2": _dit(28, 1152, 2, 16), "DiT-XL/4": _dit(28, 1152, 4, 16),
    "DiT-XL/8": _dit(28, 1152, 8, 16),
    "DiT-L/2": _dit(24, 1024, 2, 16), "DiT-L/4": _dit(24, 1024, 4, 16),
    "DiT-L/8": _dit(24, 1024, 8, 16),
    "DiT-B/2": _dit(12, 768, 2, 12), "DiT-B/4": _dit(12, 768, 4, 12),
    "DiT-B/8": _dit(12, 768, 8, 12),
    "DiT-S/2": _dit(12, 384, 2, 6), "DiT-S/4": _dit(12, 384, 4, 6),
    "DiT-S/8": _dit(12, 384, 8, 6),
    "DiTRotary_B_16": _rot(12, 768, 16, 12),
    # the default light rollout denoiser (scripts/distill_scoring_rollout.py)
    "DiTRotary_B_8": _rot(12, 768, 8, 12),
    "DiTRotary_XL_16": _rot(28, 1152, 16, 16),
    "DiTRotary_XL_8": _rot(28, 1152, 8, 16),
    "DiTRotary_S_8": _rot(12, 384, 8, 6),
    "DiTRotary_XS_8": _rot(2, 64, 8, 2),
    # pixel-space classifiers (JAX dit.py:347-349)
    "DiT-B/4-cls": _cls(12, 768, 4, 12), "DiT-B/8-cls": _cls(12, 768, 8, 12),
    "DiT-S/4-cls": _cls(12, 384, 4, 6), "DiT-S/2-cls": _cls(12, 384, 2, 6),
    "DiT-XS/2-cls": _cls(4, 384, 2, 6),
    # classifiers of classifier guidance (widths of JAX dit.py:350-353)
    "DiTRotary-XS/8-cls": _rot_cls(4, 384, 8, 6),
    "DiTRotary-S/8-cls": _rot_cls(12, 384, 8, 6),
    "DiTRotary-S/8-chord-cls": _rot_cls(12, 384, 8, 6, chord=True),
    "DiTRotary-B/8-cls": _rot_cls(12, 768, 8, 12),
}
