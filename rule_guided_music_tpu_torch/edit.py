"""Excerpt-editing CLI of the PyTorch port: regenerate a latent-time slice
of an excerpt under rule guidance.

    python -m rule_guided_music_tpu_torch.edit \\
        --config_path scripts/configs/edit/nd_scg_given_target.yml \\
        --data_dir <prefix> --batch_size 2 --num_samples 2 \\
        --timestep_respacing 100

Counterpart of ``scripts/edit.py``: reads an edit YAML (``edit:`` with
``source``, ``noise_level``, ``l_start``, ``l_end``), takes the source
excerpt (one batch of ``<data_dir>_test_cls_<class_label>.csv`` for
``source: dataset``, else the MIDI file it names, padded with silence to
10.24 s), encodes it with the KL-VAE's encoder, and runs the YAML's chain
from the encoded excerpt noised to step ``noise_level - 1``, with x0
replaced by the excerpt outside the slice [l_start, l_end) and the
guidance and SCG applied to the slice alone. ``noise_level`` counts steps
of the respaced chain (``--timestep_respacing``) and must lie inside it.
Targets are resolved on the source's editable slice
(:func:`resolve_edit_targets`). It writes ``sample_*.midi``, the source
as ``gt/sample_*.midi``, and ``results.csv`` / ``summary.csv`` scored on
the editable slice, under ``--out_dir``. ``--cfg`` makes the denoiser
classifier-free guided with weight ``--w``. ``--device cpu`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import pipeline
from .config import sampler_config_from_yaml
from .constants import NORM_SCALE
from .data.datasets import load_data
from .data.midi_io import read_midi
from .data.pianoroll import (finalize_decoded_sample, midi_to_roll,
                             save_piano_roll_midi)
from .rules.registry import FUNC_DICT
from .rules.tensor_rules import (HORIZONTAL_ND_BOUNDS, HORIZONTAL_ND_CENTER,
                                 VERTICAL_ND_BOUNDS, VERTICAL_ND_CENTER)
from .sample_rule import add_model_args, build, finish, save_batch


def _nd_tables(nd_bins, hr_scale: int, device):
    """(vertical bounds, horizontal bounds, vertical centres, horizontal
    centres): the file's, already in rule units, or the reference's tables
    with the horizontal ones divided by ``hr_scale``."""
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    if nd_bins is not None:
        return [as_t(nd_bins[k]) for k in ("vertical_bounds", "horizontal_bounds",
                                           "vertical_centers", "horizontal_centers")]
    return [as_t(VERTICAL_ND_BOUNDS), as_t(HORIZONTAL_ND_BOUNDS) / hr_scale,
            as_t(VERTICAL_ND_CENTER), as_t(HORIZONTAL_ND_CENTER) / hr_scale]


def resolve_edit_targets(config, gt_partial: torch.Tensor, batch_size: int,
                         rng: np.random.Generator,
                         nd_bins_file: str = "") -> dict:
    """Targets for the editable slice ``gt_partial`` (B, 3, 128, L)
    (scripts/edit.py:45-123; reference edit.py:186-253). A note-density
    target that is an int shifts the source's vertical class by it; a null
    one shifts both classes by draws from ``rng`` in {-1, 0, 1}; either
    maps the shifted classes to their centres, by ``searchsorted`` over
    the bound tables (``nd_bins_file``: a JSON of dataset-derived
    ``{vertical,horizontal}_{bounds,centers}`` in rule units). A list is
    taken as given (horizontal values divided by the hr scale); a given
    pitch histogram is normalized; any other null rule is measured on the
    source."""
    nd_bins = None
    if nd_bins_file:
        with open(nd_bins_file) as f:
            nd_bins = json.load(f)
    device = gt_partial.device
    model_rules = {}
    target_rules = vars(config.target_rules)
    for rule_name, val in target_rules.items():
        if "horizontal" in rule_name:
            continue
        if "vertical" in rule_name:
            hr_nd = target_rules[rule_name.replace("vertical", "horizontal")]
            if "_hr_" in rule_name:
                hr_scale = int(rule_name.split("_hr_")[-1])
                nd_name = f"note_density_hr_{hr_scale}"
            else:
                hr_scale = 5
                nd_name = "note_density"
            orig_rule = FUNC_DICT[nd_name](gt_partial)
            if isinstance(val, int) or val is None:
                vt_bounds, hr_bounds, vt_center, hr_center = _nd_tables(
                    nd_bins, hr_scale, device)
                if isinstance(val, int):
                    v_shift, h_shift = val, 0
                else:
                    v_shift = int(rng.integers(-1, 2))
                    h_shift = int(rng.integers(-1, 2))
                half = orig_rule.shape[-1] // 2
                vt_cls = torch.clamp(torch.searchsorted(
                    vt_bounds, orig_rule[:, :half].contiguous()) + v_shift, 0, 7)
                hr_cls = torch.clamp(torch.searchsorted(
                    hr_bounds, orig_rule[:, half:].contiguous()) + h_shift, 0, 7)
                target = torch.cat([vt_center[vt_cls], hr_center[hr_cls]], dim=-1)
            else:
                row = list(val) + [x / hr_scale for x in hr_nd]
                target = torch.tensor(row, dtype=torch.float32,
                                      device=device)[None].repeat(batch_size, 1)
            model_rules[nd_name] = target
        elif "pitch" in rule_name and val is not None:
            v = torch.tensor(val, dtype=torch.float32, device=device)
            model_rules[rule_name] = (v / (v.sum() + 1e-12))[None].repeat(
                batch_size, 1)
        elif val is not None:
            dtype = torch.int32 if "chord" in rule_name else torch.float32
            model_rules[rule_name] = torch.tensor(
                val, dtype=dtype, device=device)[None].repeat(batch_size, 1)
        else:
            model_rules[rule_name] = FUNC_DICT[rule_name](gt_partial)
    return model_rules


def load_source(args, source: str, length: int) -> np.ndarray:
    """The excerpt to edit as (B, 3, 128, length) normalized rolls: one
    batch of the test set for ``source: dataset``, else the MIDI file
    ``source`` rasterized at ``--fs``, padded with -1 (silence) or cut to
    ``length`` and repeated over the batch."""
    if source == "dataset":
        gt, _ = next(load_data(
            data_dir=f"{args.data_dir}_test_cls_{args.class_label}.csv",
            batch_size=args.batch_size, class_cond=True, image_size=length))
        return gt
    roll = midi_to_roll(read_midi(source), fs=args.fs)
    gt = roll[None].astype(np.float32) / NORM_SCALE - 1.0
    pad = max(length - gt.shape[3], 0)
    gt = np.pad(gt, ((0, 0), (0, 0), (0, 0), (0, pad)),
                constant_values=-1.0)[:, :, :, :length]
    return np.tile(gt, (args.batch_size, 1, 1, 1))


def create_argparser() -> argparse.ArgumentParser:
    p = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
    p.add_argument("--nd_bins_file", default="",
                   help="JSON of dataset-derived note-density class tables")
    p.set_defaults(num_samples=16, batch_size=4)
    return p


def main(argv=None) -> list:
    args = create_argparser().parse_args(argv)
    run = build(args, encoder=True)
    config = run.config
    edit = getattr(config, "edit", None)
    if edit is None:
        raise ValueError(f"{args.config_path} has no edit: block")
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch", "edit",
        os.path.splitext(os.path.basename(args.config_path))[0]
        + f"_cls_{args.class_label}")
    gt_dir = os.path.join(out_dir, "gt")

    gt = torch.as_tensor(load_source(args, getattr(edit, "source", None),
                                     run.gen_shape[2] * 8), device=run.device)
    gt_latent = pipeline.encode_rolls(run.vae, gt, args.scale_factor)
    l_start, l_end = edit.l_start, edit.l_end
    mask = torch.ones_like(gt_latent)
    mask[:, :, l_start:l_end, :] = 0.0
    cols = slice(l_start * 8, l_end * 8)
    rules = resolve_edit_targets(config, gt[..., cols], args.batch_size,
                                 np.random.default_rng(args.seed),
                                 nd_bins_file=args.nd_bins_file)
    sampler_config = sampler_config_from_yaml(
        config, learn_sigma=args.learn_sigma, record=args.record,
        rule_names=list(rules))

    arr_gt = finalize_decoded_sample(gt.cpu().numpy(), threshold=-2.0)
    y = run.y.cpu().numpy() if run.y is not None else None
    results = []
    for count in range(0, args.num_samples, args.batch_size):
        latents, _ = pipeline.generate(
            run.denoiser, run.vae, run.tables, sampler_config, run.gen_shape,
            rules, y=run.y, generator=run.generator,
            classifier_metas=run.classifier_metas,
            num_classes=args.num_classes, class_cond=args.class_cond,
            use_decode=run.use_decode, scale_factor=args.scale_factor,
            edit_gt=gt_latent, edit_mask=mask, cfg=args.cfg, w=args.w)
        if args.save_files:
            save_piano_roll_midi(arr_gt, gt_dir, args.fs, y=y, save_ind=count)
        save_batch(args, run, latents, rules, out_dir, count, results, cols)
    finish(args, results, out_dir)
    return results


if __name__ == "__main__":
    main()
