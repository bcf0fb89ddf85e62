"""Rule-guided generation CLI of the PyTorch port (SCG, classifier
guidance and the serving stack).

    python -m rule_guided_music_tpu_torch.sample_rule \\
        --config_path scripts/configs/cond_table/all/scg_classifier_all.yml \\
        --batch_size 2 --num_samples 2 --timestep_respacing 10

    python -m rule_guided_music_tpu_torch.sample_rule \\
        --config_path scripts/configs_serving/scg_sde20_pre4.yml \\
        --scoring_features_path assets/scoring_features_ch64.npz \\
        --scoring_decoder_path assets/scoring_decoder_ch64.npz \\
        --scoring_rollout DiTRotary_B_8 --scoring_rollout_path <npz> ...

Counterpart of ``scripts/sample_rule.py``: reads the same guidance YAMLs and
SCG, scoring and reuse flags, builds DiTRotary (``--model``), the
KL-VAE decoder, the YAML's classifiers and the light scoring models in bf16
on the card (random weights with a warning where a path of the trajectory
model, the decoder or a classifier is empty or names no file), runs the
guided chain, decodes, and writes
``sample_{i}_y_{label}.midi`` and ``results.csv`` (per-sample rule values
and losses, the chord rules' detected key; rewritten after every batch)
under ``--out_dir``, then ``summary.csv`` (mean and sample std of each loss
column). Targets come from the YAML when it gives them; a YAML with
null targets takes them from synthetic ``make_rolls`` excerpts (the test-set
loader is not ported yet, see ROADMAP.md). ``--device cpu`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from dataclasses import replace

import numpy as np
import torch

from . import pipeline
from .config import load_config, sampler_config_from_yaml
from .constants import BACKGROUND_THRESHOLD
from .data.pianoroll import finalize_decoded_sample, save_piano_roll_midi
from .diffusion.schedule import make_schedule
from .rules.chord import IND2KEY
from .rules.registry import FUNC_DICT, LOSS_DICT
from .utils.fixtures import make_rolls


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--out_dir", default="")
    p.add_argument("--data_dir", default="")
    p.add_argument("--model", default="DiTRotary_XL_8")
    p.add_argument("--model_path", default="")
    p.add_argument("--vae_path", default="")
    p.add_argument("--vae_arch", default="",
                   help='JSON AutoencoderKL overrides, e.g. \'{"ch": 32, '
                        '"ch_mult": [1,1,2,2], "num_res_blocks": 1}\'')
    p.add_argument("--num_samples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--scale_factor", type=float, default=1.0)
    p.add_argument("--fs", type=int, default=100)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--class_label", type=int, default=1)
    p.add_argument("--class_cond", type=str2bool, default=True)
    p.add_argument("--learn_sigma", type=str2bool, default=False)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", default="linear")
    p.add_argument("--timestep_respacing", default="")
    p.add_argument("--rescale_timesteps", type=str2bool, default=False)
    p.add_argument("--image_size", type=int, nargs="+", default=[128, 16])
    p.add_argument("--in_channels", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record", type=str2bool, default=False)
    p.add_argument("--save_files", type=str2bool, default=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    # light scoring models: they only rank SCG candidates
    p.add_argument("--scoring_decoder_path", default="")
    p.add_argument("--scoring_features_path", default="")
    p.add_argument("--scoring_rollout", default="",
                   help="registry name of the rollout denoiser, e.g. DiTRotary_B_8")
    p.add_argument("--scoring_rollout_path", default="")
    # the JAX CLI's chain segments; > 1 is refused here (see main)
    p.add_argument("--segments", type=int, default=0)
    # >= 0 overrides the YAML's sampling.reuse_interval (0/1 turn reuse off);
    # >= -1 overrides sampling.reuse_t_max
    p.add_argument("--reuse_interval", type=int, default=-1)
    p.add_argument("--reuse_t_max", type=int, default=-2)
    return p


def rule_results(generated: torch.Tensor, rules) -> list:
    """Per-sample rule values and losses: the ``results.csv`` rows of
    ``pipeline.eval_rule_loss``, columns in its order; chord rules add the
    detected key (``.key_str``) and its correlation (``.key_corr``)."""
    rows = [dict() for _ in range(generated.shape[0])]
    for name, target in rules.items():
        cols = {"target_rule": target.tolist()}
        if "chord" in name:
            gen, key_idx, corr = FUNC_DICT[name](generated, return_key=True)
            cols["key_str"] = [IND2KEY[int(k)] for k in key_idx]
            cols["key_corr"] = corr.tolist()
        else:
            gen = FUNC_DICT[name](generated)
        cols["gen_rule"] = gen.tolist()
        cols["loss"] = LOSS_DICT[name](gen, target).tolist()
        for i, row in enumerate(rows):
            row.update({f"{name}.{col}": vals[i] for col, vals in cols.items()})
    return rows


def write_results(path: str, rows: list) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def summarize_losses(rows: list) -> list:
    """(Attr, Mean, Std) of each ``.loss`` column, Std with ddof=1 (NaN for
    one row), as ``pipeline.summarize_losses`` computes them with pandas."""
    out = []
    for col in [c for c in rows[0] if ".loss" in c]:
        vals = np.array([r[col] for r in rows], dtype=np.float64)
        std = vals.std(ddof=1) if len(vals) > 1 else float("nan")
        out.append((col, float(vals.mean()), float(std)))
    return out


def write_summary(path: str, summary: list) -> None:
    """``summary.csv`` in the layout pandas' ``to_csv`` gives it: an unnamed
    index column, then Attr, Mean, Std; NaN as an empty field."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["", "Attr", "Mean", "Std"])
        for i, (col, mean, std) in enumerate(summary):
            writer.writerow([i, col, mean, "" if np.isnan(std) else std])


def classifier_metas_from_config(guidance, *, input_size, in_channels, dtype,
                                 device) -> list:
    """The cond_fn terms of the YAML's ``guidance.cond_fn`` block: with
    ``guidance.nn``, one classifier each; without, rule-based terms."""
    cond = getattr(guidance, "cond_fn", None)
    if cond is None:
        return []
    models = [None] * len(cond.fns)
    if getattr(guidance, "nn", False):
        models = pipeline.build_classifier_bundles(
            cond.classifiers, input_size=input_size, in_channels=in_channels,
            dtype=dtype, device=device)
    return [pipeline.ClassifierSpecMeta(
                fn=fn, rule_name=cond.rule_names[i],
                scale=float(cond.classifier_scales[i]), model=models[i])
            for i, fn in enumerate(cond.fns)]


def main(argv=None) -> list:
    args = create_argparser().parse_args(argv)
    if args.segments > 1:
        raise ValueError(
            "--segments > 1 is JAX-only: it keeps each lax.scan dispatch short "
            "under RPC deadlines, and this eager loop launches every step on "
            "its own, so the port runs the chain whole")
    if args.data_dir:
        raise NotImplementedError("--data_dir: the test-set loader is not in "
                                  "the torch port yet (ROADMAP.md)")
    device = pipeline.resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    config = load_config(args.config_path)
    sampling = getattr(config, "sampling", None)
    # the YAML's respacing applies to DDIM and to DPM-Solver++
    if getattr(sampling, "use_ddim", False) or \
            str(getattr(sampling, "sampler", "") or "") == "dpmpp":
        args.timestep_respacing = getattr(sampling, "timestep_respacing",
                                          args.timestep_respacing)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch",
        os.path.splitext(os.path.basename(args.config_path))[0]
        + f"_cls_{args.class_label}")

    denoiser = pipeline.create_denoiser(
        args.model, input_size=args.image_size, in_channels=args.in_channels,
        num_classes=args.num_classes, learn_sigma=args.learn_sigma,
        model_path=args.model_path, dtype=dtype, device=device)
    vae = pipeline.create_vae(
        args.vae_path, arch=json.loads(args.vae_arch) if args.vae_arch else None,
        dtype=dtype, device=device)
    tables = make_schedule(args.noise_schedule, args.diffusion_steps,
                           args.timestep_respacing,
                           args.rescale_timesteps).tables(device)

    target_rules = vars(config.target_rules)
    if all(v is not None for v in target_rules.values()):
        rules = pipeline.resolve_given_targets(target_rules, args.batch_size,
                                               device=device)
    else:
        if "vertical_nd" in target_rules:
            target_rules["note_density"] = None
            target_rules.pop("vertical_nd")
            target_rules.pop("horizontal_nd")
        print("WARNING: the YAML gives no targets: taking them from synthetic "
              "make_rolls excerpts")
        excerpts = torch.as_tensor(make_rolls(args.batch_size, seed=args.seed),
                                   device=device)
        rules = pipeline.extract_targets_from_rolls(list(target_rules), excerpts)
    sampler_config = sampler_config_from_yaml(
        config, learn_sigma=args.learn_sigma, record=args.record,
        rule_names=list(rules))
    # each flag overrides on its own, so restating one keeps the YAML's other
    if args.reuse_interval >= 0:
        sampler_config = replace(sampler_config,
                                 reuse_interval=args.reuse_interval)
    if args.reuse_t_max >= -1:
        sampler_config = replace(sampler_config, reuse_t_max=args.reuse_t_max)
    scoring = pipeline.ScoringBundle.create(
        decoder_path=args.scoring_decoder_path,
        features_path=args.scoring_features_path,
        rollout=args.scoring_rollout, rollout_path=args.scoring_rollout_path,
        input_size=args.image_size, in_channels=args.in_channels,
        num_classes=args.num_classes, learn_sigma=args.learn_sigma,
        dtype=dtype, device=device)

    classifier_metas = classifier_metas_from_config(
        config.guidance, input_size=args.image_size,
        in_channels=args.in_channels, dtype=dtype, device=device)

    y = None
    if args.class_cond:
        y = torch.full((args.batch_size,), args.class_label, dtype=torch.long,
                       device=device)
    gen_shape = (args.batch_size, args.in_channels, *args.image_size)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    use_decode = bool(getattr(config.guidance, "vae", True))

    results = []
    count = 0
    while count < args.num_samples:
        latents, _ = pipeline.generate(
            denoiser, vae, tables, sampler_config, gen_shape, rules, y=y,
            generator=generator, classifier_metas=classifier_metas,
            scoring=scoring, num_classes=args.num_classes,
            class_cond=args.class_cond, use_decode=use_decode,
            scale_factor=args.scale_factor)
        rolls = pipeline.decode_rolls(vae, latents, args.scale_factor)
        arr = finalize_decoded_sample(rolls.cpu().numpy(), BACKGROUND_THRESHOLD)
        if args.save_files:
            save_piano_roll_midi(arr, out_dir, args.fs,
                                 y=y.cpu().numpy() if y is not None else None,
                                 save_ind=count)
        generated = torch.as_tensor(arr.astype(np.float32) / 63.5 - 1.0,
                                    device=device)
        results += rule_results(generated, rules)
        if args.save_files:
            os.makedirs(out_dir, exist_ok=True)
            write_results(os.path.join(out_dir, "results.csv"), results)
        count += args.batch_size
        print(f"created {count} samples")

    summary = summarize_losses(results)
    if args.save_files:
        write_summary(os.path.join(out_dir, "summary.csv"), summary)
    for col, mean, std in summary:
        print(f"{col}: mean {mean:.4f} std {std:.4f}")
    return results


if __name__ == "__main__":
    main()
