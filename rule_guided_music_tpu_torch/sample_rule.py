"""Rule-guided generation CLI of the PyTorch port (SCG path).

    python -m rule_guided_music_tpu_torch.sample_rule \\
        --config_path scripts/configs/cond_table/all/scg.yml \\
        --batch_size 2 --num_samples 2 --timestep_respacing 10

Counterpart of ``scripts/sample_rule.py``: reads the same guidance YAMLs and
SCG flags, builds DiTRotary (``--model``) and the KL-VAE decoder in bf16 on
the card (random weights with a warning when ``--model_path``/``--vae_path``
are empty), runs the guided chain, decodes, writes ``sample_{i}_y_{label}
.midi`` and ``results.csv`` (per-sample rule values and losses) under
``--out_dir``. Targets come from the YAML when it gives them; a YAML with
null targets takes them from synthetic ``make_rolls`` excerpts (the test-set
loader is not ported yet, see ROADMAP.md). ``--device cpu`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from . import pipeline
from .config import load_config, sampler_config_from_yaml
from .constants import BACKGROUND_THRESHOLD
from .data.pianoroll import finalize_decoded_sample, save_piano_roll_midi
from .diffusion.schedule import make_schedule
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
    return p


def rule_results(generated: torch.Tensor, rules) -> list:
    """Per-sample rule values and losses (the ``results.csv`` columns of
    ``pipeline.eval_rule_loss``)."""
    rows = [dict() for _ in range(generated.shape[0])]
    for name, target in rules.items():
        gen = FUNC_DICT[name](generated)
        loss = LOSS_DICT[name](gen, target)
        for i, row in enumerate(rows):
            row[f"{name}.target_rule"] = target[i].tolist()
            row[f"{name}.gen_rule"] = gen[i].tolist()
            row[f"{name}.loss"] = float(loss[i])
    return rows


def main(argv=None) -> list:
    args = create_argparser().parse_args(argv)
    if args.data_dir:
        raise NotImplementedError("--data_dir: the test-set loader is not in "
                                  "the torch port yet (ROADMAP.md)")
    device = pipeline.resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    config = load_config(args.config_path)
    sampling = getattr(config, "sampling", None)
    if getattr(sampling, "use_ddim", False):
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
            generator=generator, num_classes=args.num_classes,
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
        count += args.batch_size
        print(f"created {count} samples")

    if args.save_files:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(results[0]))
            writer.writeheader()
            writer.writerows(results)
        for col in [c for c in results[0] if c.endswith(".loss")]:
            vals = np.array([r[col] for r in results])
            print(f"{col}: mean {vals.mean():.4f} std {vals.std(ddof=1) if len(vals) > 1 else 0.0:.4f}")
    return results


if __name__ == "__main__":
    main()
