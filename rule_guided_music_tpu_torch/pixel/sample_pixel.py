"""Pixel-space sampling with the ADM UNet denoiser, to MIDI (no VAE, fs=12.5).

    python -m rule_guided_music_tpu_torch.pixel.sample_pixel --scg True \\
        --timestep_respacing 10

Counterpart of ``scripts/pixel/sample_pixel.py``, with its flags and
defaults: the UNet (128 channels, channel_mult (1,1,2,3,4), 2 res blocks,
attention at 32, 16 and 8, i.e. at downsample factors image_size // r) on
(3, 128, 128) rolls, B=2, class-conditional on ``--class_label``. The roll
is the diffusion state, so nothing is decoded: ``--scg`` selects among
``--scg_k`` candidates per step by ``note_density_pixel`` (target 2.0 on
every interval), on every step of a DDPM chain. Rolls are written as
``sample_{i}_y_{label}.midi`` at ``--fs`` under ``--out_dir`` (the JAX
script's logger directory, ``--dir``). Random UNet weights with a warning
where ``--model_path`` (a JAX npz of flat parameters, or a torch
state_dict) is empty. ``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import pipeline
from ..config import GuidanceConfig, SCGConfig, SamplerConfig
from ..constants import BACKGROUND_THRESHOLD
from ..data.pianoroll import finalize_decoded_sample, save_piano_roll_midi
from ..diffusion.sampling import sample_loop, torch_noise_fn
from ..diffusion.schedule import make_schedule
from ..sample_rule import str2bool


def add_pixel_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags both pixel CLIs share (the JAX scripts' and
    ``diffusion_defaults``'), and the port's ``--out_dir``/``--device``."""
    p.add_argument("--out_dir", default="")
    p.add_argument("--model_path", default="")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--fs", type=float, default=12.5)
    p.add_argument("--image_size", type=int, nargs="+", default=[128, 128])
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--class_label", type=int, default=1)
    p.add_argument("--class_cond", type=str2bool, default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--learn_sigma", type=str2bool, default=False)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", default="linear")
    p.add_argument("--timestep_respacing", default="")
    p.add_argument("--rescale_timesteps", type=str2bool, default=False)
    p.add_argument("--device", default="cuda")
    return p


def create_argparser() -> argparse.ArgumentParser:
    p = add_pixel_args(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
    p.add_argument("--num_channels", type=int, default=128)
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--attention_resolutions", default="32,16,8")
    p.add_argument("--scg", type=str2bool, default=False)
    p.add_argument("--scg_k", type=int, default=4)
    return p


def tables_and_noise(args, device):
    """The respaced schedule's tables and the seeded noise of a pixel CLI.
    ``--rescale_timesteps`` is parsed and left unused, as the JAX pixel
    scripts build their schedule without it."""
    tables = make_schedule(args.noise_schedule, args.diffusion_steps,
                           args.timestep_respacing).tables(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return tables, torch_noise_fn(gen, device)


def build(args) -> SimpleNamespace:
    """The UNet in bf16 (the JAX script's fixed compute dtype) on
    ``--device``, the chain's tables, config, rules and labels, and the
    noise."""
    device = pipeline.resolve_device(args.device)
    width = args.image_size[-1]
    model = pipeline.create_unet(
        args.model_path, dtype=torch.bfloat16, device=device,
        in_channels=args.in_channels, model_channels=args.num_channels,
        out_channels=args.in_channels, num_res_blocks=args.num_res_blocks,
        attention_resolutions=tuple(
            width // int(r) for r in args.attention_resolutions.split(",")),
        num_classes=args.num_classes if args.class_cond else None)
    tables, noise_fn = tables_and_noise(args, device)
    rules, scg, guidance = {}, None, None
    if args.scg:
        rules["note_density_pixel"] = torch.full(
            (args.batch_size, 2 * width // 16), 2.0, device=device)
        scg = SCGConfig(num_samples=args.scg_k,
                        weights=(("note_density_pixel", 1.0),))
        guidance = GuidanceConfig(method="no_guidance", schedule=True,
                                  t_start=tables.num_timesteps, t_end=0)
    y = None
    if args.class_cond:
        y = torch.full((args.batch_size,), args.class_label, dtype=torch.long,
                       device=device)
    return SimpleNamespace(
        device=device, model=model, tables=tables, noise_fn=noise_fn, y=y,
        rules=rules, config=SamplerConfig(sampler="ddpm", guidance=guidance,
                                          scg=scg),
        shape=(args.batch_size, args.in_channels, *args.image_size),
        # pixel space: the state is already a roll; the decode is identity
        decode_fn=(lambda v: v) if args.scg else None)


def sample_batch(run) -> torch.Tensor:
    """One batch of normalized rolls (B, C, H, W), float32."""
    with torch.no_grad():
        rolls, _ = sample_loop(lambda x, t, y: run.model(x, t, y), run.shape,
                               run.tables, run.config, noise_fn=run.noise_fn,
                               y=run.y, rules=run.rules, decode_fn=run.decode_fn)
    return rolls


def save_rolls(args, rolls: torch.Tensor, y, out_dir: str, count: int) -> np.ndarray:
    """Write a batch as MIDI at ``--fs``; returns the uint8 rolls."""
    arr = finalize_decoded_sample(rolls.cpu().numpy(), BACKGROUND_THRESHOLD)
    save_piano_roll_midi(arr, out_dir, args.fs,
                         y=y.cpu().numpy() if y is not None else None,
                         save_ind=count)
    print(f"created {count + args.batch_size} pixel samples")
    return arr


def main(argv=None) -> np.ndarray:
    args = create_argparser().parse_args(argv)
    out_dir = args.out_dir or os.path.join("loggings", "torch", "pixel_demo",
                                           "sample")
    run = build(args)
    arrs = [save_rolls(args, sample_batch(run), run.y, out_dir, count)
            for count in range(0, args.num_samples, args.batch_size)]
    print("sampling complete")
    return np.concatenate(arrs)


if __name__ == "__main__":
    main()
