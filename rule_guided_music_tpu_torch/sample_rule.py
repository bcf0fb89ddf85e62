"""Rule-guided generation CLI of the PyTorch port (SCG, classifier and
DPS guidance, CFG, DiffCollage long form, and the serving stack).

    python -m rule_guided_music_tpu_torch.sample_rule \\
        --config_path scripts/configs/cond_table/all/scg_classifier_all.yml \\
        --data_dir <prefix> --batch_size 2 --num_samples 2 \\
        --timestep_respacing 10

    python -m rule_guided_music_tpu_torch.sample_rule \\
        --config_path scripts/configs/cond_demo/demo1.yml --record True

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
null targets measures them on one batch of the test set
``<data_dir>_test_cls_<class_label>.csv`` (a manifest of ``.npy`` rolls,
drawn as the JAX CLI draws it: shuffled and augmented unless
``--deterministic`` or ``--record``), or, with no ``--data_dir``, on
synthetic ``make_rolls`` excerpts, with a warning. DPS YAMLs
(``guidance.method: dps``) differentiate through the denoiser, and through
the decoder where ``guidance.vae`` is on and ``guidance.nn`` off.
A YAML with ``sampling.diff_collage`` (``scripts/configs/cond_demo/``)
generates the long latent its ``dc:`` block gives, stitched from
128-column windows, with SCG per ``dc.base`` window where the YAML sets
one. ``--cfg`` makes the denoiser classifier-free guided with weight
``--w``. ``--quant w8a8`` or ``--quant w8a16`` serves the trajectory
denoiser with an int8 trunk (``ops/quant.py``). ``--vae ''`` builds no
VAE: the chain runs without decoding and the DiT's output is saved as the
rolls, as the JAX script does. ``--record`` writes the last batch's per-step record to
``record.pkl`` and plots it (the plots need matplotlib);
``--record_states`` adds six decoded intermediate states as piano-roll
images. ``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from . import pipeline
from .config import collage_from_config, load_config, sampler_config_from_yaml
from .constants import BACKGROUND_THRESHOLD, NORM_SCALE
from .data.datasets import load_data
from .data.pianoroll import finalize_decoded_sample, save_piano_roll_midi
from .diffusion.schedule import make_schedule
from .rules.chord import IND2KEY
from .rules.registry import FUNC_DICT, LOSS_DICT
from .utils.fixtures import make_rolls
from .utils.tables import summarize_losses, write_summary, write_table


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_chain_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every generation CLI shares: the models, the chain, the
    batch and the outputs."""
    p.add_argument("--out_dir", default="")
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
    p.add_argument("--class_cond", type=str2bool, default=False)
    p.add_argument("--learn_sigma", type=str2bool, default=False)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", default="linear")
    p.add_argument("--timestep_respacing", default="")
    p.add_argument("--rescale_timesteps", type=str2bool, default=False)
    p.add_argument("--image_size", type=int, nargs="+", default=[128, 16])
    p.add_argument("--in_channels", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    return p


def add_cfg_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Classifier-free guidance (``--cfg``) with weight ``--w``, for the
    CLIs that pass them on to :func:`pipeline.generate`."""
    p.add_argument("--cfg", type=str2bool, default=False)
    p.add_argument("--w", type=float, default=4.0)
    return p


def add_model_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags the guided generation and edit CLIs share: the YAML, the
    test set, the record, :func:`add_chain_args` and
    :func:`add_cfg_args`."""
    p.add_argument("--config_path", required=True)
    p.add_argument("--data_dir", default="")
    add_cfg_args(add_chain_args(p))
    p.add_argument("--record", type=str2bool, default=False)
    p.add_argument("--save_files", type=str2bool, default=True)
    return p


def create_argparser() -> argparse.ArgumentParser:
    p = add_model_args(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
    p.add_argument("--vae", default="kl/f8-all-onset",
                   help="'' builds no VAE: the chain runs without decoding "
                        "and the DiT's output is saved as the rolls")
    p.add_argument("--deterministic", type=str2bool, default=False,
                   help="test-set batch without shuffling or augmentation")
    p.add_argument("--record_states", type=str2bool, default=False,
                   help="with --record, also decode six intermediate states")
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
    # int8 serving of the DiT trunk's matmuls: w8a8 or w8a16 ('' = off)
    p.add_argument("--quant", default="")
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


def build_models(args, *, encoder: bool = False, labels: bool = False,
                 quant: str = "", vae: bool = True) -> SimpleNamespace:
    """What every generation CLI builds from :func:`add_chain_args`'
    flags: the device and dtype, the denoiser (its trunk int8 where
    ``quant`` names a mode), the KL-VAE (with its encoder where
    ``encoder``; None without ``vae``), the schedule's tables, the noise
    generator and the labels (where ``class_cond`` or ``labels``; None
    otherwise)."""
    device = pipeline.resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    y = None
    if args.class_cond or labels:
        y = torch.full((args.batch_size,), args.class_label, dtype=torch.long,
                       device=device)
    return SimpleNamespace(
        device=device, dtype=dtype, y=y,
        gen_shape=(args.batch_size, args.in_channels, *args.image_size),
        denoiser=pipeline.create_denoiser(
            args.model, input_size=args.image_size,
            in_channels=args.in_channels, num_classes=args.num_classes,
            learn_sigma=args.learn_sigma, model_path=args.model_path,
            dtype=dtype, device=device, quant=quant),
        vae=pipeline.create_vae(
            args.vae_path,
            arch=json.loads(args.vae_arch) if args.vae_arch else None,
            encoder=encoder, dtype=dtype, device=device) if vae else None,
        tables=make_schedule(args.noise_schedule, args.diffusion_steps,
                             args.timestep_respacing,
                             args.rescale_timesteps).tables(device),
        generator=torch.Generator(device=device).manual_seed(args.seed))


def build(args, *, encoder: bool = False, quant: str = "",
          vae: bool = True) -> SimpleNamespace:
    """What the guided generation and edit CLIs build alike from their
    flags and the YAML: :func:`build_models` (after the YAML's respacing;
    ``quant`` and ``vae`` as there), the config, the YAML's cond_fn terms
    and its decode switch (off without a VAE)."""
    pipeline.resolve_device(args.device)     # no card: refuse before reading
    config = load_config(args.config_path)
    sampling = getattr(config, "sampling", None)
    # the YAML's respacing applies to DDIM and to DPM-Solver++
    if getattr(sampling, "use_ddim", False) or \
            str(getattr(sampling, "sampler", "") or "") == "dpmpp":
        args.timestep_respacing = getattr(sampling, "timestep_respacing",
                                          args.timestep_respacing)
    run = build_models(args, encoder=encoder, quant=quant, vae=vae)
    run.config = config
    run.classifier_metas = classifier_metas_from_config(
        config.guidance, input_size=args.image_size,
        in_channels=args.in_channels, dtype=run.dtype, device=run.device)
    run.use_decode = bool(getattr(config.guidance, "vae", True)) and vae
    return run


def save_midi(args, run, latents, out_dir: str, count: int,
              save: bool = True) -> np.ndarray:
    """Decode a batch to uint8 rolls (without a VAE, the latents are the
    rolls) and, where ``save``, write them as
    ``sample_<count + i>[_y_<label>].midi``; returns the rolls."""
    rolls = latents if run.vae is None else pipeline.decode_rolls(
        run.vae, latents, args.scale_factor)
    arr = finalize_decoded_sample(rolls.cpu().numpy(), BACKGROUND_THRESHOLD)
    if save:
        y = run.y.cpu().numpy() if run.y is not None else None
        save_piano_roll_midi(arr, out_dir, args.fs, y=y, save_ind=count)
    return arr


def save_batch(args, run, latents, rules, out_dir: str, count: int,
               results: list, cols: slice = slice(None)) -> np.ndarray:
    """Decode a batch, write its MIDI files, score its rolls' columns
    ``cols`` against ``rules`` into ``results`` and rewrite
    ``results.csv``; returns the uint8 rolls."""
    arr = save_midi(args, run, latents, out_dir, count, save=args.save_files)
    generated = torch.as_tensor(arr.astype(np.float32) / NORM_SCALE - 1.0,
                                device=run.device)
    results += rule_results(generated[..., cols], rules)
    if args.save_files:
        os.makedirs(out_dir, exist_ok=True)
        write_table(os.path.join(out_dir, "results.csv"), results)
    print(f"created {count + args.batch_size} samples")
    return arr


def save_record(records, out_dir: str, vae, scale_factor: float):
    """Write a chain's ``records`` (name -> per-step values) to
    ``<out_dir>/record.pkl`` as numpy arrays, ``state`` left out, and
    decode the first example's state at six steps spread over the chain
    (``--record_states``). Returns (the pickled dict, {step: uint8 roll}
    of the decoded states, empty without states)."""
    rec_np = {k: v.cpu().numpy() for k, v in records.items() if k != "state"}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "record.pkl"), "wb") as f:
        pickle.dump(rec_np, f)
    states = records.get("state")
    if states is None:
        return rec_np, {}
    idx = np.linspace(0, len(states) - 1, 6, dtype=int)
    rolls = pipeline.decode_rolls(vae, states[torch.as_tensor(idx), 0],
                                  scale_factor)
    arr = finalize_decoded_sample(rolls.cpu().numpy(), BACKGROUND_THRESHOLD)
    return rec_np, dict(zip(idx.tolist(), arr))


def write_record(records, out_dir: str, vae, scale_factor: float) -> None:
    """``save_record``, then the record's plots and the decoded states as
    ``state_step<i>.png`` piano-roll images (matplotlib)."""
    from .utils.viz import plot_records, save_piano_roll_image

    rec_np, states = save_record(records, out_dir, vae, scale_factor)
    plot_records(rec_np, out_dir)
    for step, roll in states.items():
        save_piano_roll_image(roll, os.path.join(out_dir, f"state_step{step}.png"))
    print(f"wrote per-step diagnostics to {out_dir}/record.pkl")


def finish(args, results: list, out_dir: str) -> None:
    """Write ``summary.csv`` and print each loss's mean and std."""
    summary = summarize_losses(results)
    if args.save_files:
        write_summary(os.path.join(out_dir, "summary.csv"), summary)
    for col, mean, std in summary:
        print(f"{col}: mean {mean:.4f} std {std:.4f}")


def main(argv=None) -> list:
    args = create_argparser().parse_args(argv)
    if args.segments > 1:
        raise ValueError(
            "--segments > 1 is JAX-only: it keeps each lax.scan dispatch short "
            "under RPC deadlines, and this eager loop launches every step on "
            "its own, so the port runs the chain whole")
    run = build(args, quant=args.quant, vae=bool(args.vae))
    config, device = run.config, run.device
    collage, run.gen_shape = collage_from_config(
        config, args.batch_size, args.in_channels, args.image_size)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch",
        os.path.splitext(os.path.basename(args.config_path))[0]
        + f"_cls_{args.class_label}")

    target_rules = vars(config.target_rules)
    if all(v is not None for v in target_rules.values()):
        rules = pipeline.resolve_given_targets(target_rules, args.batch_size,
                                               device=device)
    else:
        if "vertical_nd" in target_rules:
            target_rules["note_density"] = None
            target_rules.pop("vertical_nd")
            target_rules.pop("horizontal_nd")
        if args.data_dir:
            manifest = f"{args.data_dir}_test_cls_{args.class_label}.csv"
            print(f"extracting targets from test set {manifest}")
            excerpts, _ = next(load_data(
                data_dir=manifest, batch_size=args.batch_size, class_cond=True,
                deterministic=bool(args.record or args.deterministic),
                image_size=run.gen_shape[2] * 8))
        else:
            print("WARNING: the YAML gives no targets and no --data_dir is "
                  "given: taking them from synthetic make_rolls excerpts")
            excerpts = make_rolls(args.batch_size, length=run.gen_shape[2] * 8,
                                  seed=args.seed)
        rules = pipeline.extract_targets_from_rolls(
            list(target_rules), torch.as_tensor(excerpts, device=device))
    sampler_config = sampler_config_from_yaml(
        config, learn_sigma=args.learn_sigma, record=args.record,
        record_states=args.record_states, rule_names=list(rules))
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
        dtype=run.dtype, device=device)

    results = []
    for count in range(0, args.num_samples, args.batch_size):
        latents, records = pipeline.generate(
            run.denoiser, run.vae, run.tables, sampler_config, run.gen_shape,
            rules, y=run.y, generator=run.generator,
            classifier_metas=run.classifier_metas, scoring=scoring,
            num_classes=args.num_classes, class_cond=args.class_cond,
            use_decode=run.use_decode, scale_factor=args.scale_factor,
            collage=collage, cfg=args.cfg, w=args.w)
        save_batch(args, run, latents, rules, out_dir, count, results)
    finish(args, results, out_dir)
    if args.record:
        write_record(records, out_dir, run.vae, args.scale_factor)
    return results


if __name__ == "__main__":
    main()
