"""KL-VAE training CLI over 1.28 s piano-roll chunks.

    python -m rule_guided_music_tpu_torch.train_vae --chunk_dir chunks/

Counterpart of ``scripts/train_vae.py`` (reference taming/main.py with
configs/pr/kl/f8-all-onset.yaml), with its flags and defaults: the f8
AutoencoderKL (embed 4), L1 + 1e-2 KL, Adam (0.5, 0.9) at base_lr x
batch, batches of 128 (3, 128, 128) chunks (``.npy`` files of
``--chunk_dir``) normalized to [-1, 1], bf16 compute over fp32
parameters; ``--disc_weight`` adds the patch-GAN and ``--perceptual_weight``
LPIPS (``--lpips_vgg_path``/``--lpips_lins_path``: torch files, loaded
directly; seeded random weights with a warning without them). Logs go to
``loggings/<dir>/``, the VAE's state dict every ``save_interval`` steps
to ``checkpoints/vae<step>/state.pt`` there. ``--device`` defaults to cuda
and raises where there is no card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from . import pipeline
from .constants import NORM_SCALE
from .models.vae import AutoencoderKL
from .training.perceptual import LPIPS
from .training.vae_train import NLayerDiscriminator, VAETrainConfig, make_vae_train_steps
from .utils import logger


def chunk_batches(chunk_dir, batch_size, seed=0):
    """Endless batches of ``batch_size`` chunk files, reshuffled every pass
    by a numpy generator seeded with ``seed``, as float32 in [-1, 1]."""
    files = sorted(glob.glob(os.path.join(chunk_dir, "*.npy")))
    if not files:
        raise SystemExit(f"no .npy chunks in {chunk_dir}")
    rng = np.random.default_rng(seed)
    while True:
        rng.shuffle(files)
        for i in range(0, len(files) - batch_size + 1, batch_size):
            batch = np.stack([np.load(f) for f in files[i:i + batch_size]])
            yield batch.astype(np.float32) / NORM_SCALE - 1.0


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chunk_dir", required=True)
    parser.add_argument("--dir", default="vae_train")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--base_lr", type=float, default=4.5e-6)
    parser.add_argument("--kl_weight", type=float, default=1e-2)
    parser.add_argument("--disc_weight", type=float, default=0.0)
    parser.add_argument("--perceptual_weight", type=float, default=0.0)
    parser.add_argument("--lpips_vgg_path", default="",
                        help="torch VGG16 features .pt for the LPIPS term")
    parser.add_argument("--lpips_lins_path", default="",
                        help="taming vgg.pth linear heads for LPIPS")
    parser.add_argument("--iterations", type=int, default=100000)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--save_interval", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    """Train; returns the VAE and one dict per step: its losses and "ms",
    the step's host wall time, loading the batch included (it ends reading
    the losses, so the device has finished)."""
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    logger.configure(args=args)
    torch.manual_seed(args.seed)
    with torch.device(device):
        vae = AutoencoderKL(encoder=True)
    config = VAETrainConfig(lr=args.base_lr * args.batch_size,
                            kl_weight=args.kl_weight, disc_weight=args.disc_weight,
                            perceptual_weight=args.perceptual_weight)
    disc = lpips = None
    if args.disc_weight > 0:
        torch.manual_seed(7)
        with torch.device(device):
            disc = NLayerDiscriminator()
    if args.perceptual_weight > 0:
        torch.manual_seed(7)
        with torch.device(device):
            lpips = LPIPS()
        if args.lpips_vgg_path and args.lpips_lins_path:
            load = lambda p: torch.load(p, map_location=device, weights_only=True)
            lpips.load_torch(load(args.lpips_vgg_path), load(args.lpips_lins_path))
        else:
            logger.log("WARNING: perceptual term with random LPIPS weights "
                       "(pass --lpips_vgg_path/--lpips_lins_path)")
    _, _, ae_step, disc_step = make_vae_train_steps(
        vae, config, disc, lpips=lpips, compute_dtype=torch.bfloat16)

    data = chunk_batches(args.chunk_dir, args.batch_size, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    history = []
    for step in range(args.iterations):
        t0 = time.perf_counter()
        batch = torch.as_tensor(next(data), device=device)
        aux = ae_step(batch, step, generator=gen)
        if disc_step is not None and step >= config.disc_start:
            aux.update(disc_step(batch, generator=gen))
        aux = {k: float(v) for k, v in aux.items()}
        history.append({**aux, "ms": 1e3 * (time.perf_counter() - t0)})
        for k, v in aux.items():
            logger.logkv_mean(k, v)
        if step % args.log_interval == 0:
            logger.logkv("step", step)
            logger.dumpkvs()
        if step % args.save_interval == 0 and step > 0:
            path = os.path.join(os.path.abspath(logger.get_dir()), "checkpoints",
                                f"vae{step:06d}")
            os.makedirs(path, exist_ok=True)
            torch.save(vae.state_dict(), os.path.join(path, "state.pt"))
            logger.log(f"saved {path}")
    return vae, history


if __name__ == "__main__":
    main()
