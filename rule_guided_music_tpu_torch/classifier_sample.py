"""Classifier-guided sampling with one rule classifier, no SCG.

    python -m rule_guided_music_tpu_torch.classifier_sample \
        --rule pitch_hist --target 1,0,0,0,0,0,0,0,0,0,0,0

Counterpart of ``scripts/classifier_sample.py`` (the reference's older
path), with its flags and defaults: one noise-aware classifier
(``--classifier_name``, ``--classifier_num_classes``; its weights from
``--classifier_path`` where the file exists, else seeded random weights
with a warning) guides the chain by the Sohl-Dickstein mean shift of an
MSE (or, with ``--xentropy``, cross-entropy) log-prob of ``--rule``
against ``--target`` (comma-separated values), scaled by
``--classifier_scale``. Writes ``sample_*.midi``, ``results.csv`` and
``summary.csv`` under ``--out_dir``. ``--device cpu`` runs the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import torch

from . import pipeline
from .config import GuidanceConfig, SamplerConfig
from .diffusion.gaussian import ModelVarType
from .sample_rule import (add_chain_args, build_models, finish, save_batch,
                          str2bool)


def create_argparser() -> argparse.ArgumentParser:
    p = add_chain_args(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
    p.add_argument("--classifier_name", default="DiTRotary-S/8-cls")
    p.add_argument("--classifier_path", default="")
    p.add_argument("--classifier_num_classes", type=int, default=12)
    p.add_argument("--classifier_scale", type=float, default=400.0)
    p.add_argument("--rule", default="pitch_hist")
    p.add_argument("--target", default="1,0,0,0,0,0,0,0,0,0,0,0")
    p.add_argument("--xentropy", type=str2bool, default=False)
    p.add_argument("--use_ddim", type=str2bool, default=False)
    p.add_argument("--sampler", default="", choices=["", "ddpm", "ddim", "dpmpp"],
                   help="'' follows --use_ddim")
    # results.csv and summary.csv are always written, as by the JAX script
    p.set_defaults(num_samples=16, batch_size=4, scale_factor=1.2465,
                   class_cond=False, save_files=True)
    return p


def main(argv=None) -> list:
    args = create_argparser().parse_args(argv)
    out_dir = args.out_dir or os.path.join(
        "loggings", "torch", "classifier_demo",
        f"{args.rule}_cls_{args.class_label}")
    run = build_models(args, labels=True)
    classifier = pipeline.build_classifier_bundles(
        SimpleNamespace(names=[args.classifier_name],
                        num_classes=[args.classifier_num_classes],
                        paths=[args.classifier_path]),
        input_size=args.image_size, in_channels=args.in_channels,
        dtype=run.dtype, device=run.device)[0]
    fn = "grad_nn_zt_xentropy" if args.xentropy else "grad_nn_zt_mse"
    metas = [pipeline.ClassifierSpecMeta(fn=fn, rule_name=args.rule,
                                         scale=args.classifier_scale,
                                         model=classifier)]
    config = SamplerConfig(
        sampler=args.sampler or ("ddim" if args.use_ddim else "ddpm"), eta=1.0,
        var_type=(ModelVarType.LEARNED_RANGE if args.learn_sigma
                  else ModelVarType.FIXED_LARGE),
        guidance=GuidanceConfig(method="classifier_guidance", schedule=False))
    target = torch.tensor([float(v) for v in args.target.split(",")],
                          device=run.device)
    rules = {args.rule: target[None].repeat(args.batch_size, 1)}
    results = []
    for count in range(0, args.num_samples, args.batch_size):
        latents, _ = pipeline.generate(
            run.denoiser, run.vae, run.tables, config, run.gen_shape, rules,
            y=run.y, generator=run.generator, classifier_metas=metas,
            num_classes=args.num_classes, class_cond=args.class_cond,
            use_decode=False, scale_factor=args.scale_factor)
        save_batch(args, run, latents, rules, out_dir, count, results)
    finish(args, results, out_dir)
    return results


if __name__ == "__main__":
    main()
