"""Musical rule programs on torch tensors: pitch-class histogram and note
density.

Port of ``rule_guided_music_tpu/rules/tensor_rules.py`` (reference
music_rule_guidance/music_rules.py:23-94), batched over the (k*B) SCG
candidates on the device. Every function takes normalized piano rolls
(B, C, 128, L) in [-1, 1] (background -1) and returns (B, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import BACKGROUND_THRESHOLD, MAX_PIANO, MIN_PIANO, OFF

VERTICAL_ND_BOUNDS = [1.29, 2.7578125, 3.61, 4.4921875, 5.28125, 6.1171875, 7.22]
VERTICAL_ND_CENTER = [0.56, 2.0239, 3.1839, 4.0511, 4.8867, 5.6992, 6.6686, 7.77]
HORIZONTAL_ND_BOUNDS = [1.8, 2.6, 3.2, 3.6, 4.4, 4.8, 5.8]
HORIZONTAL_ND_CENTER = [1.4, 2.2000, 2.9, 3.4, 4.0, 4.6, 5.3, 6.3]


def piano_like(x: torch.Tensor) -> torch.Tensor:
    """Pitches outside the 88-key range (axis -2) set to background."""
    n_pitch = x.shape[-2]
    idx = torch.arange(n_pitch, device=x.device)
    in_range = ((idx >= MIN_PIANO) & (idx <= MAX_PIANO)).reshape(n_pitch, 1)
    return torch.where(in_range, x, torch.full_like(x, OFF))


def pitch_class_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Fold a 128-pitch axis into 12 pitch classes (segment sum mod 12)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    pad = (-n) % 12
    folded = F.pad(x, (0, pad)).reshape(x.shape[:-1] + ((n + pad) // 12, 12))
    return folded.sum(dim=-2).movedim(-1, axis)


def total_pitch_class_histogram(piano_roll: torch.Tensor) -> torch.Tensor:
    """Normalized 12-bin pitch-class histogram of channel 0."""
    roll = piano_like(piano_roll[:, 0, :, :])
    roll = (roll + 1.0) / 2.0
    hist = pitch_class_sum(roll.sum(dim=-1), axis=-1)        # (B, 12)
    return hist / (hist.sum(dim=-1, keepdim=True) + 1e-12)


def _nearest_resize_time(roll: torch.Tensor, new_len: int) -> torch.Tensor:
    """Nearest-neighbour resize of the last axis (interpolate 'nearest')."""
    old_len = roll.shape[-1]
    idx = torch.arange(new_len, device=roll.device) * old_len // new_len
    return roll[..., idx]


def _binary_notes(piano_roll: torch.Tensor) -> torch.Tensor:
    roll = piano_like(piano_roll)
    roll = torch.where(roll < BACKGROUND_THRESHOLD, torch.full_like(roll, OFF), roll)
    roll = (roll + 1.0) / 2.0
    return (roll >= 1e-2).to(piano_roll.dtype)


def note_density(piano_roll: torch.Tensor, interval: int = 128,
                 quantize_factor: int = 1,
                 horizontal_scale: float = 5.0) -> torch.Tensor:
    """Vertical + horizontal note density per ``interval``-column window;
    returns (B, 2 * L/interval) (music_rules.py:46-83)."""
    roll = piano_roll[:, :1, :, :]
    if quantize_factor != 1:
        roll = _nearest_resize_time(roll, roll.shape[-1] // quantize_factor)
        interval = interval // quantize_factor
    binary = _binary_notes(roll)                              # (B,1,128,L)
    batch = binary.shape[0]
    vertical_per_col = binary.sum(dim=2)                      # (B,1,L)
    diff = torch.diff(F.pad(binary, (1, 1)), dim=-1).clamp(min=0.0)
    horizontal_per_col = diff.sum(dim=2)[:, :, :-1]
    horizontal_per_col = (horizontal_per_col != 0.0).to(binary.dtype)
    vertical = vertical_per_col.reshape(batch, 1, -1, interval).mean(dim=-1)
    horizontal = (horizontal_per_col.reshape(batch, 1, -1, interval).sum(dim=-1)
                  / horizontal_scale)
    return torch.cat([vertical, horizontal], dim=-1)[:, 0, :]


def note_density_class(piano_roll: torch.Tensor, interval: int = 128,
                       quantize_factor: int = 1,
                       horizontal_scale: float = 1.0) -> torch.Tensor:
    """Bucketized note-density classes (torch.bucketize(right=False),
    i.e. searchsorted side='left')."""
    nd = note_density(piano_roll, interval=interval,
                      quantize_factor=quantize_factor,
                      horizontal_scale=horizontal_scale)
    vt_bounds = torch.tensor(VERTICAL_ND_BOUNDS, dtype=nd.dtype, device=nd.device)
    hr_bounds = torch.tensor(HORIZONTAL_ND_BOUNDS, dtype=nd.dtype,
                             device=nd.device) / horizontal_scale
    half = nd.shape[-1] // 2
    vt_cls = torch.searchsorted(vt_bounds, nd[:, :half].contiguous(), right=False)
    hr_cls = torch.searchsorted(hr_bounds, nd[:, half:].contiguous(), right=False)
    return torch.cat([vt_cls, hr_cls], dim=-1)


def soft_note_density(piano_roll: torch.Tensor, interval: int = 128,
                      horizontal_scale: float = 5.0, threshold: float = 0.05,
                      sharpness: float = 200.0) -> torch.Tensor:
    """Differentiable note density: sigmoids replace the thresholds."""
    roll = piano_like(piano_roll[:, :1, :, :])
    batch = roll.shape[0]
    active = torch.sigmoid(((roll + 1.0) / 2.0 - threshold) * sharpness)
    vertical_per_col = active.sum(dim=2)
    diff = torch.diff(F.pad(active, (1, 1)), dim=-1)
    onset_strength = torch.relu(diff).sum(dim=2)[:, :, :-1]
    horizontal_per_col = torch.tanh(onset_strength * 2.0)
    vertical = vertical_per_col.reshape(batch, 1, -1, interval).mean(dim=-1)
    horizontal = (horizontal_per_col.reshape(batch, 1, -1, interval).sum(dim=-1)
                  / horizontal_scale)
    return torch.cat([vertical, horizontal], dim=-1)[:, 0, :]


def soft_pitch_histogram(piano_roll: torch.Tensor, threshold: float = 0.05,
                         sharpness: float = 200.0) -> torch.Tensor:
    """Differentiable pitch-class histogram over a soft active-note mask."""
    roll = piano_like(piano_roll[:, 0, :, :])
    active = torch.sigmoid(((roll + 1.0) / 2.0 - threshold) * sharpness)
    hist = pitch_class_sum(active.sum(dim=-1), axis=-1)
    return hist / (hist.sum(dim=-1, keepdim=True) + 1e-12)
