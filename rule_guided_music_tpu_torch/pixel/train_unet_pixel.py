"""Pixel-space UNet diffusion training (fs=12.5, 128 x 128 rolls, no VAE).

    python -m rule_guided_music_tpu_torch.pixel.train_unet_pixel --data_dir train.csv

Counterpart of ``scripts/pixel/train_unet_pixel.py``, with its flags and
defaults: the ADM UNet (128 channels, channel_mult (1, 1, 2, 3, 4), two
res-blocks a level, attention at 32, 16 and 8 pixels with 4 heads,
scale-shift norm, 3 labels) on (3, 128, 128) rolls, batch 16, lr 1e-4,
AdamW, EMA 0.9999, bf16 compute over fp32 parameters, through the port's
``TrainLoop`` with no encoder (``vae_encode=None``): the loader's rolls are
x0. ``--learn_sigma True`` doubles the output channels and trains with
``LEARNED_RANGE`` and ``RESCALED_MSE``. The UNet drops no label (JAX's
trainer calls it as ``model(x, t, y)``); its weights start from flax's
default initialisation from ``--seed``, as JAX's (``init_unet_weights_``).
Logs and
``checkpoints/step_NNNNNN`` go to ``loggings/<dir>/``. ``--device``
defaults to cuda and raises where there is no card. ``--dp``/``--fsdp``/
``--tp`` take ``train_dit.build_mesh``'s mesh over the launched ranks,
each rank loading its rows of the global batch.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import pipeline
from ..config import add_dict_to_argparser, diffusion_defaults
from ..data.datasets import load_data
from ..diffusion import gaussian as gd
from ..diffusion.schedule import make_schedule
from ..models.unet import UNetModel, init_unet_weights_
from ..parallel.mesh import batch_axis
from ..train_dit import build_mesh, idle
from ..training.resample import create_named_schedule_sampler
from ..training.train_loop import TrainConfig, TrainLoop
from ..utils import logger


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        project="music-pixel-diffusion", dir="", data_dir="",
        schedule_sampler="uniform", lr=1e-4, weight_decay=0.0, lr_anneal_steps=0,
        batch_size=16, microbatch=-1, ema_rate="0.9999", log_interval=10,
        save_interval=10000, image_size=[128, 128], in_channels=3,
        num_channels=128, num_res_blocks=2, num_heads=4,
        attention_resolutions="32,16,8", use_scale_shift_norm=True,
        num_classes=3, class_cond=True, bf16=True, seed=0, max_steps=-1,
        dp=0, fsdp=1, tp=1,
    )
    defaults.update(diffusion_defaults())
    defaults["device"] = "cuda"
    return add_dict_to_argparser(
        argparse.ArgumentParser(description=__doc__.split("\n")[0]), defaults)


def pixel_train_config(args) -> TrainConfig:
    """The TrainConfig of both pixel denoiser trainers: no encoder, the
    learned variance where ``learn_sigma``."""
    learned = args.learn_sigma
    return TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps, ema_rate=float(args.ema_rate),
        microbatch=args.microbatch, encode_rep=1, log_interval=args.log_interval,
        save_interval=args.save_interval,
        var_type=(gd.ModelVarType.LEARNED_RANGE if learned
                  else gd.ModelVarType.FIXED_LARGE),
        loss_type=gd.LossType.RESCALED_MSE if learned else gd.LossType.MSE)


def pixel_loop(args, model, device, mesh=None) -> TrainLoop:
    """A TrainLoop over the manifest's rolls (``image_size[-1]`` columns,
    labels where ``class_cond``; this rank's rows of the batch on a
    ``mesh``), checkpoints under the run directory."""
    tables = make_schedule(args.noise_schedule, args.diffusion_steps).tables(device)
    shards = batch_axis(mesh)
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size // shards.size,
                     class_cond=args.class_cond, image_size=args.image_size[-1],
                     shard=shards.rank, num_shards=shards.size, seed=args.seed)
    return TrainLoop(
        model=model, tables=tables, data=data, config=pixel_train_config(args),
        vae_encode=None,
        schedule_sampler=create_named_schedule_sampler(args.schedule_sampler,
                                                       tables.num_timesteps),
        checkpoint_dir=os.path.join(logger.get_dir(), "checkpoints"), seed=args.seed,
        compute_dtype=torch.bfloat16 if args.bf16 else None, mesh=mesh)


def main(argv=None) -> TrainLoop:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    mesh = build_mesh(args, device)
    logger.configure(args=args)
    if idle(mesh):
        return None
    with torch.device(device):
        model = UNetModel(
            in_channels=args.in_channels, model_channels=args.num_channels,
            out_channels=args.in_channels * (2 if args.learn_sigma else 1),
            num_res_blocks=args.num_res_blocks,
            attention_resolutions=tuple(args.image_size[-1] // int(r)
                                        for r in args.attention_resolutions.split(",")),
            num_classes=args.num_classes if args.class_cond else None,
            num_heads=args.num_heads, use_scale_shift_norm=args.use_scale_shift_norm)
    init_unet_weights_(model, torch.Generator(device=device).manual_seed(args.seed)).train()
    loop = pixel_loop(args, model, device, mesh)
    logger.log("training pixel-space UNet...")
    loop.run_loop(max_steps=args.max_steps if args.max_steps > 0 else None)
    return loop


if __name__ == "__main__":
    main()
