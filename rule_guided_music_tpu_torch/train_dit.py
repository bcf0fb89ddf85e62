"""Latent DiT training CLI.

    python -m rule_guided_music_tpu_torch.train_dit --data_dir train.csv

Counterpart of ``scripts/train_dit.py`` (reference scripts/train_dit.py),
with its flags and defaults: DiTRotary_XL_8 on (128, 16) latents, lr 1e-4,
AdamW, EMA 0.9999, bf16 compute over fp32 parameters, class-conditional
on 3 labels with label dropout 0.1; the loader feeds ``batch_size //
encode_rep`` rolls of ``pr_image_size`` columns, which the production
KL-VAE encoder (``--vae_path``, random weights with a warning where
empty) turns into ``encode_rep`` overlapping latent excerpts each, and
the labels are repeated to match. Logs and checkpoints go to
``loggings/<dir>/``; ``--resume True`` restores the newest checkpoint
there, ``--resume_checkpoint`` a given one. ``--device`` defaults to
cuda and raises where there is no card; ``--device cpu`` runs the plain
versions on the CPU. ``--optimizer adafactor`` takes the port's
Adafactor (``training/adafactor.py``).

``--dp/--fsdp/--tp`` lay the ranks out as a ("data", "fsdp", "model")
mesh (:func:`build_mesh`; ``parallel.mesh``): launch one process a rank,
e.g. ``torchrun --nproc-per-node 4 -m rule_guided_music_tpu_torch.train_dit
--dp 2 --fsdp 2`` (``--device cpu`` for gloo ranks on the CPU). Each rank
loads its own rows of the global ``--batch_size``: shard = its (data,
fsdp) coordinate, num_shards = data * fsdp. Rank 0 writes the logs and
the checkpoints, which resume on any mesh.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from . import pipeline
from .config import add_dict_to_argparser, diffusion_defaults
from .data.datasets import load_data
from .diffusion import gaussian as gd
from .diffusion.schedule import make_schedule
from .models.dit import DiT_models, init_weights_
from .parallel.mesh import (batch_axis, check_factors, launched_world, make_mesh,
                            maybe_init_distributed)
from .training.resample import create_named_schedule_sampler
from .training.train_loop import TrainConfig, TrainLoop, make_eval_sampling_fn
from .utils import logger


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        project="music-diffusion", dir="", data_dir="", eval_data_dir="",
        model="DiTRotary_XL_8", schedule_sampler="uniform", lr=1e-4,
        weight_decay=0.0, lr_anneal_steps=0, batch_size=32, microbatch=-1,
        ema_rate="0.9999", log_interval=10, save_interval=10000,
        keep_checkpoints=0, eval_interval=-1, eval_sample_batch_size=16,
        resume_checkpoint="", resume=False, image_size=[128, 16], in_channels=4,
        num_classes=3, class_cond=True, class_dropout_prob=0.1, vae_path="",
        vae_arch="", scale_factor=1.2465, pr_image_size=2560, encode_rep=4,
        shift_size=4, microbatch_encode=-1, embed_model_name="kl/f8-all-onset",
        fs=100, bf16=True, seed=0, max_steps=-1, profile_step=-1, remat=False,
        optimizer="adamw", ema_dtype="float32", dp=0, fsdp=1, tp=1,
        device="cuda",
    )
    defaults.update(diffusion_defaults())   # scripts/train_dit.py takes them too
    return add_dict_to_argparser(
        argparse.ArgumentParser(description=__doc__.split("\n")[0]), defaults)


def build_mesh(args, device):
    """The ("data", "fsdp", "model") mesh over the launched ranks, or None
    for the single-process path (one rank and no mesh flag). ``--dp 0``
    (default) gives the data axis the ranks that are left. With no mesh
    flag on several ranks, the largest count of ranks that divides the
    global batch takes part (data-parallel), as JAX's auto mode takes a
    prefix of the devices; the ranks left over stand idle (their mesh has
    no coordinate). Every rank calls it."""
    explicit = args.dp > 0 or args.fsdp > 1 or args.tp > 1
    if explicit:        # refuse a layout the ranks cannot take before joining
        check_factors(launched_world(), args.dp or None, args.fsdp, args.tp)
    if not maybe_init_distributed(device, force=explicit):
        return None
    n = dist.get_world_size()
    if n == 1 and not explicit:
        return None
    if not explicit:
        use = max(d for d in range(1, n + 1) if args.batch_size % d == 0)
        if use < n:
            logger.log(f"build_mesh: batch_size {args.batch_size} not divisible "
                       f"by {n} ranks; data-parallel over {use} of them")
        return make_mesh(dp=use, device=device, ranks=range(use))
    mesh = make_mesh(dp=args.dp or None, fsdp=args.fsdp, tp=args.tp, device=device)
    batch_span = mesh.size(0) * mesh.size(1)
    assert args.batch_size % batch_span == 0, (
        f"global batch_size ({args.batch_size}) must be divisible by the "
        f"batch-sharded mesh extent data*fsdp = {batch_span}")
    return mesh


def idle(mesh) -> bool:
    """This rank is outside the mesh (auto mode's left-over ranks)."""
    return mesh is not None and mesh.get_coordinate() is None


def main(argv=None) -> TrainLoop:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    mesh = build_mesh(args, device)
    logger.configure(args=args)
    if idle(mesh):
        logger.log("this rank is outside the mesh: idle")
        return None
    logger.log("creating model and diffusion...")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.device(device):
        model = DiT_models[args.model](
            input_size=tuple(args.image_size), in_channels=args.in_channels,
            num_classes=args.num_classes, learn_sigma=args.learn_sigma,
            class_dropout_prob=args.class_dropout_prob, remat=args.remat)
    init_weights_(model, gen).train()
    n_params = sum(p.numel() for p in model.parameters())
    logger.log(f"model {args.model}: {n_params / 1e6:.1f}M params")
    tables = make_schedule(args.noise_schedule, args.diffusion_steps).tables(device)
    vae = pipeline.create_vae(
        args.vae_path, arch=json.loads(args.vae_arch) if args.vae_arch else None,
        encoder=True, device=device)

    if args.batch_size < args.encode_rep or args.batch_size % args.encode_rep:
        raise ValueError(
            f"batch_size ({args.batch_size}) must be a positive multiple of "
            f"encode_rep ({args.encode_rep}): the loader yields "
            f"batch_size/encode_rep rolls, each re-chunked into encode_rep "
            f"training windows (train_util.py:403-429)")
    shards = batch_axis(mesh)
    if (args.batch_size // shards.size) % args.encode_rep:
        raise ValueError(
            f"each rank's batch ({args.batch_size} / {shards.size}) must be a "
            f"multiple of encode_rep ({args.encode_rep})")
    rolls = args.batch_size // shards.size // args.encode_rep
    data = load_data(data_dir=args.data_dir, batch_size=rolls,
                     class_cond=args.class_cond, image_size=args.pr_image_size,
                     shard=shards.rank, num_shards=shards.size, seed=args.seed)
    eval_data = None
    if args.eval_data_dir:
        eval_data = load_data(data_dir=args.eval_data_dir, batch_size=rolls,
                              class_cond=args.class_cond,
                              image_size=args.pr_image_size, shard=shards.rank,
                              num_shards=shards.size, seed=args.seed + 1)
    learned = args.learn_sigma
    config = TrainConfig(
        lr=args.lr, optimizer=args.optimizer, ema_dtype=args.ema_dtype,
        weight_decay=args.weight_decay, lr_anneal_steps=args.lr_anneal_steps,
        ema_rate=float(args.ema_rate), microbatch=args.microbatch,
        encode_rep=args.encode_rep, shift_size=args.shift_size,
        scale_factor=args.scale_factor, log_interval=args.log_interval,
        save_interval=args.save_interval, keep_checkpoints=args.keep_checkpoints,
        eval_interval=args.eval_interval, profile_step=args.profile_step,
        var_type=(gd.ModelVarType.LEARNED_RANGE if learned
                  else gd.ModelVarType.FIXED_LARGE),
        loss_type=gd.LossType.RESCALED_MSE if learned else gd.LossType.MSE)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    eval_fn = None
    if args.eval_interval > 0:
        eval_fn = make_eval_sampling_fn(
            model, tables, vae=vae, sample_batch_size=args.eval_sample_batch_size,
            num_classes=args.num_classes if args.class_cond else 0,
            in_channels=args.in_channels, image_size=tuple(args.image_size),
            fs=args.fs, scale_factor=args.scale_factor, compute_dtype=compute_dtype)
    loop = TrainLoop(
        model=model, tables=tables, data=data, config=config,
        vae_encode=vae.encode_moments,
        schedule_sampler=create_named_schedule_sampler(args.schedule_sampler,
                                                       tables.num_timesteps),
        checkpoint_dir=os.path.join(logger.get_dir(), "checkpoints"),
        eval_fn=eval_fn, eval_data=eval_data, seed=args.seed,
        compute_dtype=compute_dtype, mesh=mesh)
    if args.resume_checkpoint:
        loop.restore(args.resume_checkpoint)
    elif args.resume:
        latest = TrainLoop.latest_checkpoint(
            os.path.join(logger.get_dir(), "checkpoints"))
        if latest:
            loop.restore(latest)
    logger.log("training...")
    loop.run_loop(max_steps=args.max_steps if args.max_steps > 0 else None)
    return loop


if __name__ == "__main__":
    main()
