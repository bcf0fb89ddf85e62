"""Unguided long-form generation by DiffCollage score stitching.

    python -m rule_guided_music_tpu_torch.diffcollage_sample \
        --dc_type circle --num_img 3 --overlap_size 64

Counterpart of ``scripts/diffcollage_sample.py`` (reference
scripts/diffcollage_sample.py:27-170), with its flags and defaults: the
denoiser stitched over overlapping 128-column latent windows
(``--dc_type`` circle or linear, ``--num_img`` windows, ``--overlap_size``
columns; the defaults give 256 latent columns, 20.48 s), optionally
classifier-free guided (``--cfg``, ``--w``), one long MIDI file per sample
under ``--out_dir``. Random weights with a warning where a path is empty.
``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os

from . import pipeline
from .config import SamplerConfig, collage_geometry
from .diffusion.gaussian import ModelVarType
from .sample_rule import (add_cfg_args, add_chain_args, build_models, save_midi,
                          str2bool)


def create_argparser() -> argparse.ArgumentParser:
    p = add_cfg_args(add_chain_args(
        argparse.ArgumentParser(description=__doc__.split("\n")[0])))
    p.add_argument("--use_ddim", type=str2bool, default=False)
    p.add_argument("--dc_type", default="circle", choices=["circle", "linear"])
    p.add_argument("--num_img", type=int, default=3)
    p.add_argument("--overlap_size", type=int, default=64)
    p.set_defaults(num_samples=4, batch_size=2, scale_factor=1.2465,
                   class_cond=False)
    return p


def main(argv=None) -> None:
    args = create_argparser().parse_args(argv)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch", "dc_demo", f"{args.dc_type}_n{args.num_img}")
    run = build_models(args, labels=True)
    collage, shape = collage_geometry(
        args.dc_type == "circle", args.num_img, args.overlap_size,
        args.batch_size, args.in_channels, args.image_size)
    config = SamplerConfig(
        sampler="ddim" if args.use_ddim else "ddpm", eta=1.0,
        var_type=(ModelVarType.LEARNED_RANGE if args.learn_sigma
                  else ModelVarType.FIXED_LARGE))
    for count in range(0, args.num_samples, args.batch_size):
        latents, _ = pipeline.generate(
            run.denoiser, run.vae, run.tables, config, shape, {}, y=run.y,
            generator=run.generator, num_classes=args.num_classes,
            class_cond=args.class_cond, use_decode=False,
            scale_factor=args.scale_factor, collage=collage, cfg=args.cfg,
            w=args.w)
        save_midi(args, run, latents, out_dir, count)
        print(f"created {count + args.batch_size} long samples "
              f"({shape[2] * 8 / args.fs:.1f}s each)")


if __name__ == "__main__":
    main()
