"""Pixel-space DiT diffusion training (fs=12.5, 128 x 128 rolls, no VAE).

    python -m rule_guided_music_tpu_torch.pixel.train_dit_pixel --data_dir train.csv

Counterpart of ``scripts/pixel/train_dit_pixel.py``, with its flags and
defaults: the 2-D ``DiT-B/8`` (256 tokens of 12 heads of 64) on
(3, 128, 128) rolls, batch 16, lr 1e-4, AdamW, EMA 0.9999, bf16 compute
over fp32 parameters, 3 labels with label dropout 0.1, through the port's
``TrainLoop`` with no encoder (``vae_encode=None``), JAX's DiT
initialisation from ``--seed``. ``--learn_sigma True`` selects
``LEARNED_RANGE`` and ``RESCALED_MSE``; ``--resume True`` restores the
newest checkpoint under ``loggings/<dir>/checkpoints``. ``--device``
defaults to cuda and raises where there is no card. ``--dp``/``--fsdp``/
``--tp`` take ``train_dit.build_mesh``'s mesh over the launched ranks
(the DiT's heads and MLP tensor-parallel over ``--tp``).
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import pipeline
from ..config import add_dict_to_argparser, diffusion_defaults
from ..models.dit import DiT_models, init_weights_
from ..train_dit import build_mesh, idle
from ..training.train_loop import TrainLoop
from ..utils import logger
from .train_unet_pixel import pixel_loop


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        project="music-pixel-diffusion", dir="", data_dir="", model="DiT-B/8",
        schedule_sampler="uniform", lr=1e-4, weight_decay=0.0, lr_anneal_steps=0,
        batch_size=16, microbatch=-1, ema_rate="0.9999", log_interval=10,
        save_interval=10000, image_size=[128, 128], in_channels=3, num_classes=3,
        class_cond=True, class_dropout_prob=0.1, bf16=True, resume=False, seed=0,
        max_steps=-1, dp=0, fsdp=1, tp=1,
    )
    defaults.update(diffusion_defaults())
    defaults["device"] = "cuda"
    return add_dict_to_argparser(
        argparse.ArgumentParser(description=__doc__.split("\n")[0]), defaults)


def main(argv=None) -> TrainLoop:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    mesh = build_mesh(args, device)
    logger.configure(args=args)
    if idle(mesh):
        return None
    with torch.device(device):
        model = DiT_models[args.model](
            input_size=tuple(args.image_size), in_channels=args.in_channels,
            num_classes=args.num_classes if args.class_cond else 0,
            class_dropout_prob=args.class_dropout_prob, learn_sigma=args.learn_sigma)
    init_weights_(model, torch.Generator(device=device).manual_seed(args.seed)).train()
    n_params = sum(p.numel() for p in model.parameters())
    logger.log(f"pixel DiT {args.model}: {n_params / 1e6:.1f}M params")
    loop = pixel_loop(args, model, device, mesh)
    if args.resume:
        latest = TrainLoop.latest_checkpoint(os.path.join(logger.get_dir(),
                                                          "checkpoints"))
        if latest:
            loop.restore(latest)
    logger.log("training pixel-space DiT...")
    loop.run_loop(max_steps=args.max_steps if args.max_steps > 0 else None)
    return loop


if __name__ == "__main__":
    main()
