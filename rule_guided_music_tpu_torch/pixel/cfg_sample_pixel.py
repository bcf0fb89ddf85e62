"""Pixel-space class-conditional / CFG sampling with the 2-D DiT, to MIDI.

    python -m rule_guided_music_tpu_torch.pixel.cfg_sample_pixel \\
        --sampler dpmpp --timestep_respacing 20

Counterpart of ``scripts/pixel/cfg_sample_pixel.py``, with its flags and
defaults: ``DiT-B/8`` on (3, 128, 128) rolls (256 tokens of 12 heads of
64), B=2, labels ``--class_label``, classifier-free guidance
(1 + w) eps_c - w eps_null with w=4 where ``--cfg`` and ``--class_cond``
hold, on a DDPM, DDIM (``--use_ddim``) or DPM-Solver++ (``--sampler
dpmpp``) chain, in bf16 unless ``--bf16 False``. Rolls are written as
``sample_{i}_y_{label}.midi`` at ``--fs`` under ``--out_dir``. Random
weights with a warning where ``--model_path`` is empty. ``--device cpu``
runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import pipeline
from ..config import SamplerConfig
from ..diffusion.guidance import make_model_fn
from ..diffusion.sampling import sample_loop
from ..sample_rule import str2bool
from .sample_pixel import add_pixel_args, save_rolls, tables_and_noise


def create_argparser() -> argparse.ArgumentParser:
    p = add_pixel_args(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
    p.add_argument("--model", default="DiT-B/8")
    p.add_argument("--cfg", type=str2bool, default=True)
    p.add_argument("--w", type=float, default=4.0)
    p.add_argument("--use_ddim", type=str2bool, default=False)
    p.add_argument("--sampler", default="", choices=["", "ddpm", "ddim", "dpmpp"],
                   help="'' follows --use_ddim")
    p.add_argument("--bf16", type=str2bool, default=True)
    return p


def build(args) -> SimpleNamespace:
    """The 2-D DiT on ``--device``, the CFG denoiser closure, the chain's
    tables and config, the labels and the noise."""
    device = pipeline.resolve_device(args.device)
    model = pipeline.create_denoiser(
        args.model, input_size=args.image_size, in_channels=args.in_channels,
        num_classes=args.num_classes, learn_sigma=args.learn_sigma,
        model_path=args.model_path,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    tables, noise_fn = tables_and_noise(args, device)
    return SimpleNamespace(
        device=device, model=model, tables=tables, noise_fn=noise_fn,
        model_fn=make_model_fn(model, args.num_classes, args.class_cond,
                               cfg=args.cfg, w=args.w),
        config=SamplerConfig(
            sampler=args.sampler or ("ddim" if args.use_ddim else "ddpm"),
            eta=1.0),
        y=torch.full((args.batch_size,), args.class_label, dtype=torch.long,
                     device=device),
        shape=(args.batch_size, args.in_channels, *args.image_size))


def sample_batch(run) -> torch.Tensor:
    """One batch of normalized rolls (B, C, H, W), float32."""
    with torch.no_grad():
        rolls, _ = sample_loop(run.model_fn, run.shape, run.tables, run.config,
                               noise_fn=run.noise_fn, y=run.y)
    return rolls


def main(argv=None) -> np.ndarray:
    args = create_argparser().parse_args(argv)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch", "pixel_demo", f"cfg_w{args.w}_cls_{args.class_label}")
    run = build(args)
    arrs = [save_rolls(args, sample_batch(run), run.y, out_dir, count)
            for count in range(0, args.num_samples, args.batch_size)]
    print("sampling complete")
    return np.concatenate(arrs)


if __name__ == "__main__":
    main()
