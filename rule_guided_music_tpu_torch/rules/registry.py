"""Rule and loss registries, the SCG selection / reporting contract.

Port of ``rule_guided_music_tpu/rules/registry.py`` (reference
music_rule_guidance/rule_maps.py:5-38), name for name, so YAML configs of
the reference work unchanged. Every rule maps (B, C, 128, L) -> (B, D).
"""

from __future__ import annotations

from functools import partial

import torch

from . import chord, tensor_rules

FUNC_DICT = {
    "pitch_hist": tensor_rules.total_pitch_class_histogram,
    "note_density": tensor_rules.note_density,
    "note_density_hr_1": partial(tensor_rules.note_density, horizontal_scale=1.0),
    "note_density_hr_2": partial(tensor_rules.note_density, horizontal_scale=2.0),
    "note_density_class": tensor_rules.note_density_class,
    "chord_progression": chord.get_chords,
    "note_density_pixel": partial(tensor_rules.note_density, interval=16),
    "chord_progression_pixel": partial(chord.get_chords, fs=12.5, window_size=1.28),
    "note_density_soft": tensor_rules.soft_note_density,
    "pitch_hist_soft": tensor_rules.soft_pitch_histogram,
}


def mse_loss_mean(gen_rule: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((gen_rule.float() - target.float()) ** 2).mean(dim=-1)


def zero_one_loss_mean(gen_rule: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (gen_rule != target).float().mean(dim=-1)


def zero_one_loss_sum(gen_rule: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (gen_rule != target).float().sum(dim=-1)


LOSS_DICT = {
    "pitch_hist": mse_loss_mean,
    "note_density": mse_loss_mean,
    "note_density_hr_1": mse_loss_mean,
    "note_density_hr_2": mse_loss_mean,
    "note_density_class": zero_one_loss_mean,
    "chord_progression": zero_one_loss_mean,
    "note_density_pixel": mse_loss_mean,
    "chord_progression_pixel": zero_one_loss_mean,
    "note_density_soft": mse_loss_mean,
    "pitch_hist_soft": mse_loss_mean,
}
