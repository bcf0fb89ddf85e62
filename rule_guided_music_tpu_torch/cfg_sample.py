"""Class-conditional sampling with classifier-free guidance, to MIDI.

    python -m rule_guided_music_tpu_torch.cfg_sample --w 4 --sampler dpmpp \
        --timestep_respacing 20

Counterpart of ``scripts/cfg_sample.py`` (reference
scripts/cfg_sample.py:26-160), with its flags and defaults: no rules and no
SCG, the denoiser guided as (1 + w) eps_c - w eps_null where ``--cfg`` and
``--class_cond`` hold, on a DDPM, DDIM (``--use_ddim``) or DPM-Solver++
(``--sampler dpmpp``) chain, decoded and written as ``sample_*.midi``
under ``--out_dir``. Random weights with a warning where a path is empty.
``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os

from . import pipeline
from .config import SamplerConfig
from .diffusion.gaussian import ModelVarType
from .sample_rule import (add_cfg_args, add_chain_args, build_models, save_midi,
                          str2bool)


def create_argparser() -> argparse.ArgumentParser:
    p = add_cfg_args(add_chain_args(
        argparse.ArgumentParser(description=__doc__.split("\n")[0])))
    p.add_argument("--clip_denoised", type=str2bool, default=False)
    p.add_argument("--use_ddim", type=str2bool, default=False)
    p.add_argument("--sampler", default="", choices=["", "ddpm", "ddim", "dpmpp"],
                   help="'' follows --use_ddim")
    p.set_defaults(num_samples=16, batch_size=4, scale_factor=1.2465,
                   cfg=True)
    return p


def main(argv=None) -> None:
    args = create_argparser().parse_args(argv)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch", "cfg_demo", f"w{args.w}_cls_{args.class_label}")
    run = build_models(args, labels=True)
    config = SamplerConfig(
        sampler=args.sampler or ("ddim" if args.use_ddim else "ddpm"), eta=1.0,
        var_type=(ModelVarType.LEARNED_RANGE if args.learn_sigma
                  else ModelVarType.FIXED_LARGE),
        clip_denoised=args.clip_denoised)
    for count in range(0, args.num_samples, args.batch_size):
        latents, _ = pipeline.generate(
            run.denoiser, run.vae, run.tables, config, run.gen_shape, {},
            y=run.y, generator=run.generator, num_classes=args.num_classes,
            class_cond=args.class_cond, use_decode=False,
            scale_factor=args.scale_factor, cfg=args.cfg, w=args.w)
        save_midi(args, run, latents, out_dir, count)
        print(f"created {count + args.batch_size} samples")


if __name__ == "__main__":
    main()
