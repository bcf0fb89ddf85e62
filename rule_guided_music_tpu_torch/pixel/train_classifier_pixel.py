"""Noise-aware rule-classifier training on pixel rolls (fs=12.5, no VAE).

    python -m rule_guided_music_tpu_torch.pixel.train_classifier_pixel \\
        --data_dir train.csv --rule note_density_pixel

Counterpart of ``scripts/pixel/train_classifier_pixel.py``, with its
flags and defaults: ``DiT-S/2-cls`` (4096 patches of 2 x 2 and a CLS
token: N = 4097, 6 heads of 64) on (3, 128, 128) rolls with ``*_pixel``
rule labels (chord tags at fs 12.5), batch 32, AdamW (lr 3e-4, weight
decay 0.05), bf16 compute over fp32 parameters. The rolls are x0; the
step and the loop are ``classifier_train_aug``'s (t below
``no_high_noise``, ``q_sample``, MSE or key + chord CE, JAX's log keys,
``checkpoints/model{step:06d}.pt``). ``--device`` defaults to cuda and
raises where there is no card.
"""

from __future__ import annotations

import argparse

from .. import pipeline
from ..classifier_train_aug import build_classifier, train_classifier
from ..config import add_dict_to_argparser, diffusion_defaults
from ..data.datasets import load_data
from ..parallel.mesh import maybe_init_distributed
from ..utils import logger


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        project="music-pixel-classifier", dir="", data_dir="",
        classifier_name="DiT-S/2-cls", rule="note_density_pixel", num_classes=16,
        iterations=10000, lr=3e-4, weight_decay=0.05, batch_size=32,
        image_size=[128, 128], in_channels=3, no_high_noise=0, log_interval=10,
        save_interval=5000, bf16=True, seed=0,
    )
    defaults.update(diffusion_defaults())
    defaults["device"] = "cuda"
    return add_dict_to_argparser(
        argparse.ArgumentParser(description=__doc__.split("\n")[0]), defaults)


def main(argv=None):
    """Returns (model, history)."""
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    maybe_init_distributed(device)    # RGM_MULTIHOST=1 or torchrun
    logger.configure(args=args)
    model = build_classifier(args, device)
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size,
                     class_cond=False, image_size=args.image_size[-1],
                     rule=args.rule, seed=args.seed)
    return model, train_classifier(args, model, data, lambda rolls: rolls, device)


if __name__ == "__main__":
    main()
