"""Noise-aware rule-classifier training on latents.

    python -m rule_guided_music_tpu_torch.classifier_train_aug \\
        --data_dir train.csv --rule note_density

Counterpart of ``scripts/classifier_train_aug.py`` (reference
scripts/classifier_train_aug.py:32-304), with its flags and defaults:
``DiTRotary-S/8-cls`` on (4, 128, 16) latents, batch 32, AdamW (lr 3e-4,
weight decay 0.05, optax's other defaults), no EMA and no schedule, bf16
compute over fp32 parameters. The loader gives ``batch_size //
encode_rep`` rolls of ``pr_image_size`` columns with their rule labels
(time stretch and pitch shift on); the production KL-VAE encoder
(``--vae_path``, random weights with a warning where empty) turns them into
latent excerpts under ``no_grad`` (``get_kl_input``), and the labels are
repeated to match. t is drawn from ``np.random.default_rng(seed)`` below
``no_high_noise`` (all steps where 0), x_t = ``q_sample(x0, t, noise)``,
and the classifier reads it at ``model_t[t]``. The loss is the summed
squared error against the rule's value, or for a ``chord`` rule the key
(25-way) plus per-window chord cross-entropies. Logs JAX's keys (``loss``,
``mse`` or ``key_loss``, ``chord_loss``, ``key_acc``, ``chord_acc``) under
``loggings/<dir>/``; every ``save_interval`` steps (not step 0) the
state_dict goes to ``checkpoints/model{step:06d}.pt``, which
``pipeline.load_weights(..., "cls")`` reads back. ``--device`` defaults to
cuda and raises where there is no card; ``--device cpu`` runs the plain
versions on the CPU. The step (:func:`classifier_step`) takes its t and
noise as arguments; ``pixel/train_classifier_pixel.py`` shares it and the
loop (:func:`train_classifier`).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import pipeline
from .config import add_dict_to_argparser, diffusion_defaults
from .data.datasets import load_data
from .diffusion import gaussian as gd
from .diffusion.schedule import Tables, make_schedule
from .models.dit import DiT_models, init_weights_
from .parallel.mesh import maybe_init_distributed
from .training.train_loop import TrainConfig, get_kl_input, make_optimizer
from .utils import logger


def create_argparser() -> argparse.ArgumentParser:
    defaults = dict(
        project="music-classifier", dir="", data_dir="",
        classifier_name="DiTRotary-S/8-cls", rule="note_density", num_classes=16,
        iterations=10000, lr=3e-4, weight_decay=0.05, batch_size=32,
        image_size=[128, 16], in_channels=4, vae_path="", scale_factor=1.2465,
        pr_image_size=1024, encode_rep=1, shift_size=4, no_high_noise=0,
        log_interval=10, save_interval=5000, bf16=True, seed=0,
    )
    defaults.update(diffusion_defaults())
    defaults["device"] = "cuda"
    return add_dict_to_argparser(
        argparse.ArgumentParser(description=__doc__.split("\n")[0]), defaults)


def classifier_loss(model: torch.nn.Module, tables: Tables, x0: torch.Tensor,
                    t: torch.Tensor, labels: Dict[str, torch.Tensor],
                    noise: torch.Tensor, rule: str,
                    compute_dtype: Optional[torch.dtype] = None):
    """(loss, aux) of one batch: x_t = q_sample(x0, t, noise) read at
    ``model_t[t]``; the summed squared error against ``labels[rule]``, or
    for a chord rule the key and chord cross-entropies (JAX's loss_fn)."""
    x_t = gd.q_sample(tables, x0, t, noise)
    with torch.autocast(x0.device.type, dtype=compute_dtype or torch.float32,
                        enabled=compute_dtype is not None):
        out = model(x_t, tables.model_t[t])
    if "chord" in rule:
        key_logits, chord_logits = out
        key_labels, chord_labels = labels["key"].long(), labels["chord"].long()
        key_loss = F.cross_entropy(key_logits, key_labels)
        chord_loss = F.cross_entropy(chord_logits.reshape(-1, chord_logits.shape[-1]),
                                     chord_labels.reshape(-1))
        with torch.no_grad():
            aux = {"key_loss": key_loss.detach(), "chord_loss": chord_loss.detach(),
                   "key_acc": (key_logits.argmax(-1) == key_labels).float().mean(),
                   "chord_acc": (chord_logits.argmax(-1) == chord_labels).float().mean()}
        return key_loss + chord_loss, aux
    loss = ((out - labels[rule].float()) ** 2).sum(-1).mean()
    return loss, {"mse": loss.detach()}


def classifier_step(model, optimizer, tables, x0, t, labels, noise, rule,
                    compute_dtype=None):
    """One train step: the loss, its gradient, one optimizer update.
    Returns (loss, aux), both detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux = classifier_loss(model, tables, x0, t, labels, noise, rule,
                                compute_dtype)
    loss.backward()
    optimizer.step()
    return loss.detach(), aux


def build_classifier(args, device) -> torch.nn.Module:
    """The registry classifier, fp32 parameters on ``device``, JAX's
    initialisation from ``--seed``, in train mode."""
    with torch.device(device):
        model = DiT_models[args.classifier_name](
            input_size=tuple(args.image_size), in_channels=args.in_channels,
            num_classes=args.num_classes)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return init_weights_(model, gen).train()


def train_classifier(args, model: torch.nn.Module, data,
                     to_x0: Callable, device) -> Dict[str, list]:
    """The loop of both classifier trainers: ``to_x0(batch)`` turns the
    loader's rolls into the model's x0 (the encoded latents, or the rolls);
    labels are repeated to x0's batch. Returns the logged values and each
    step's host ms, loading included."""
    tables = make_schedule(args.noise_schedule, args.diffusion_steps).tables(device)
    optimizer = make_optimizer(TrainConfig(lr=args.lr, weight_decay=args.weight_decay),
                               model.parameters())
    compute_dtype = torch.bfloat16 if args.bf16 else None
    rng_np = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    max_t = args.no_high_noise if args.no_high_noise > 0 else tables.num_timesteps
    history = {"loss": [], "ms": []}
    logger.log(f"training classifier for rule '{args.rule}'...")
    for step in range(args.iterations):
        t0 = time.perf_counter()
        batch, cond = next(data)
        x0 = to_x0(torch.as_tensor(np.asarray(batch, dtype=np.float32), device=device))
        rep = x0.shape[0] // batch.shape[0]
        labels = {k: torch.as_tensor(np.repeat(np.asarray(v), rep, axis=0),
                                     device=device) for k, v in cond.items()}
        t = torch.as_tensor(rng_np.integers(0, max_t, size=(x0.shape[0],)),
                            dtype=torch.long, device=device)
        noise = torch.randn(x0.shape, generator=gen, device=device)
        loss, aux = classifier_step(model, optimizer, tables, x0, t, labels, noise,
                                    args.rule, compute_dtype)
        logger.logkv_mean("loss", float(loss))
        for k, v in aux.items():
            logger.logkv_mean(k, float(v))
        history["loss"].append(float(loss))
        history["ms"].append(1e3 * (time.perf_counter() - t0))
        if step % args.log_interval == 0:
            logger.logkv("step", step)
            logger.dumpkvs()
        if step % args.save_interval == 0 and step > 0:
            path = os.path.join(os.path.abspath(logger.get_dir()), "checkpoints",
                                f"model{step:06d}.pt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(model.state_dict(), path)
            logger.log(f"saved {path}")
    return history


def main(argv=None):
    """Returns (model, history)."""
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    maybe_init_distributed(device)    # RGM_MULTIHOST=1 or torchrun
    logger.configure(args=args)
    model = build_classifier(args, device)
    vae = pipeline.create_vae(args.vae_path, encoder=True, device=device)
    data = load_data(data_dir=args.data_dir,
                     batch_size=args.batch_size // args.encode_rep,
                     class_cond=False, image_size=args.pr_image_size,
                     rule=args.rule, seed=args.seed)

    def encode(batch):
        return get_kl_input(vae.encode_moments, batch, scale_factor=args.scale_factor,
                            shift_size=args.shift_size)

    return model, train_classifier(args, model, data, encode, device)


if __name__ == "__main__":
    main()
