"""Latent std -> scale_factor over a dataset.

    python -m rule_guided_music_tpu_torch.compute_std --data_dir <manifest.csv> [--device cuda]

Counterpart of ``scripts/compute_std.py`` (reference compute_std.py), with
its flags plus ``--device``: the production KL-VAE with its encoder (bf16;
``--vae_path``, else Flax-initialised random weights from seed 1, the JAX
bundle's init key) encodes ``--num_batches`` deterministic loader batches
of ``--batch_size`` rolls of ``--image_size`` columns (``get_kl_input``
with scale_factor 1 and no recombination: the posterior mode of every
chunk); the mean of the batches' population stds is the latent std, and
scale_factor = 1 / std (the released value is 1.2465). Prints the JAX
script's line and returns (std, scale_factor).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import pipeline
from .data.datasets import load_data
from .training.distill import flax_init_
from .training.train_loop import get_kl_input


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--vae_path", default="")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_batches", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    vae = pipeline.create_vae(args.vae_path, encoder=True, dtype=torch.float32,
                              device=device)
    if not args.vae_path:
        flax_init_(vae, 1)
    vae = vae.to(torch.bfloat16)
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size,
                     class_cond=False, deterministic=True,
                     image_size=args.image_size, prefetch=0)
    stds = []
    for _ in range(args.num_batches):
        batch, _ = next(data)
        z = get_kl_input(vae.encode_moments, torch.as_tensor(batch, device=device),
                         scale_factor=1.0, recombine=False)
        stds.append(float(z.std(correction=0)))
    std = float(np.mean(stds))
    print(f"latent std: {std:.4f}  ->  scale_factor = {1.0 / std:.4f}")
    return std, 1.0 / std


if __name__ == "__main__":
    main()
