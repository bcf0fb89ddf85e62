"""Distill a rule-feature head for SCG candidate ranking.

    python -m rule_guided_music_tpu_torch.distill_scoring_features [--device cuda]

Counterpart of ``scripts/distill_scoring_features.py``, with its flags and
defaults plus ``--device``. The head (``models.scoring_head.
RuleFeatureHead``) predicts the three rule features straight from x̂0
latents, so the guided step ranks its candidates with no decode. The
teacher is the full decode followed by ``FUNC_DICT`` at the deployment
operating point (inputs N(0, latent_std^2), latent_std = 1 /
scale_factor). The loss mirrors the SCG selection weights: 40 * MSE on
pitch_hist + MSE on note_density + cross-entropy of the chord-tag logits.
Adam follows a cosine decay to 0 over ``--steps``, read at the update's
count before it increments, as ``optax.cosine_decay_schedule``: update i
uses lr * (1 + cos(pi * i / steps)) / 2, the first the full lr.

Metrics on held-out groups of k latents: ``ph_mse``, ``nd_mse``,
``chord_acc`` (tag accuracy), and SCG selection agreement under the
40 / 1 / 1 weights, with the chord loss the share of mismatched windows.
Writes the head as an npz of its Flax tree and ``agreement``, always
float32. ``main`` returns what it measured and the trained head.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import pipeline
from .diffusion.latent import make_decode_fn
from .models.scoring_head import RuleFeatureHead
from .rules.registry import FUNC_DICT
from .training.distill import (TrainLog, autocast, flax_init_, softmax_targets,
                               str2bool, teacher_vae, uniform_targets, write_npz)

RULES = ("pitch_hist", "note_density", "chord_progression")
WEIGHTS = {"pitch_hist": 40.0, "note_density": 1.0, "chord_progression": 1.0}
ERRORS = ("ph_mse", "nd_mse", "chord_acc")


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vae_path", default="")
    parser.add_argument("--teacher_ch", type=int, default=128,
                        help="teacher VAE width (reduce for CPU smoke tests)")
    parser.add_argument("--ch", type=int, default=64)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--latent_t", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--latent_std", type=float, default=1.0 / 1.2465,
                        help="std of the head-input latent dist "
                             "(default 1/scale_factor = deployment point)")
    parser.add_argument("--agree_groups", type=int, default=32,
                        help="k-candidate groups for selection agreement")
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--out", default="loggings/scoring_features/ch{ch}.npz")
    parser.add_argument("--bf16", type=str2bool, default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def build(args, device):
    """(teacher AutoencoderKL decoder, head), float32 on ``device``; init
    seeds 1 and 3, the JAX script's keys."""
    teacher = teacher_vae(args.teacher_ch, args.vae_path)
    head = flax_init_(RuleFeatureHead(ch=args.ch, depth=args.depth), 3)
    return teacher.to(device).eval().requires_grad_(False), head.to(device)


def make_teacher_features(teacher, bf16: bool):
    """Latent image -> long roll (scale_factor 1: the inputs are already
    at the operating point) -> the three rules' ``FUNC_DICT`` features."""
    decode = make_decode_fn(teacher.decode)

    @torch.no_grad()
    def features(z_img):
        with autocast(z_img.device, bf16):
            roll = decode(z_img)
        return {name: FUNC_DICT[name](roll) for name in RULES}
    return features


def cosine_decay(steps: int):
    """``optax.cosine_decay_schedule(1, steps)`` as a LambdaLR factor of the
    update count."""
    return lambda count: 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))


def make_optimizer(head, lr: float, steps: int):
    optimizer = torch.optim.Adam(head.parameters(), lr=lr)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, cosine_decay(steps))


def loss_terms(head, z, tgt, bf16: bool):
    """(40 ph + nd + ce, (ph, nd, ce))."""
    with autocast(z.device, bf16):
        out = head(z)
    ph = ((out["pitch_hist"] - tgt["pitch_hist"]) ** 2).mean()
    nd = ((out["note_density"] - tgt["note_density"]) ** 2).mean()
    logits = out["chord_logits"].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt["chord_progression"].long().reshape(-1))
    return 40.0 * ph + nd + ce, (ph, nd, ce)


def make_step(head, optimizer, scheduler, bf16: bool):
    """One update at the schedule's current lr, then the count moves on;
    returns (loss, (ph, nd, ce))."""
    def step(z, tgt):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_terms(head, z, tgt, bf16)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.detach(), tuple(a.detach() for a in aux)
    return step


def selection_total(feats: Dict[str, torch.Tensor],
                    targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(k,) weighted selection loss; the chord loss is the share of
    windows whose tag differs."""
    total = 0.0
    for name in RULES:
        gen, tgt = feats[name], targets[name]
        if name == "chord_progression":
            loss = (gen != tgt).float().mean(-1)
        else:
            loss = ((gen - tgt) ** 2).mean(-1)
        total = total + WEIGHTS[name] * loss
    return total


@torch.no_grad()
def group_scores(teacher_features, head, z_img, targets, bf16: bool):
    """(teacher's total, head's total, feature errors) of one group."""
    t_feats = teacher_features(z_img)
    with autocast(z_img.device, bf16):
        h_feats = head.features(z_img)
    errs = {
        "ph_mse": ((t_feats["pitch_hist"] - h_feats["pitch_hist"]) ** 2).mean(),
        "nd_mse": ((t_feats["note_density"] - h_feats["note_density"]) ** 2).mean(),
        "chord_acc": (t_feats["chord_progression"]
                      == h_feats["chord_progression"]).float().mean(),
    }
    return selection_total(t_feats, targets), selection_total(h_feats, targets), errs


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    teacher, head = build(args, device)
    shape = (args.batch, 4, args.latent_t, 16)
    w = args.latent_t // 16
    print(f"feature head ch={args.ch} depth={args.depth}: "
          f"{sum(p.numel() for p in head.parameters())/1e6:.2f}M params")
    teacher_features = make_teacher_features(teacher, args.bf16)
    step = make_step(head, *make_optimizer(head, args.lr, args.steps), args.bf16)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    log = TrainLog(every=50)
    for i in range(args.steps):
        z = torch.randn(shape, generator=gen, device=device) * args.latent_std
        loss, aux = step(z, teacher_features(z))
        loss = float(loss)
        ph, nd, ce = (float(a) for a in aux)
        log.step(i, loss, f"loss {loss:.4f} (ph {ph:.5f} nd {nd:.4f} "
                          f"chord_ce {ce:.4f})")

    head.eval()
    agree = 0
    errs_acc = {k: [] for k in ERRORS}
    for _ in range(args.agree_groups):
        z_img = torch.randn((args.k,) + shape[1:], generator=gen,
                            device=device) * args.latent_std
        targets = {
            "pitch_hist": softmax_targets(gen, args.k, 12, device),
            "note_density": uniform_targets(gen, args.k, 2 * w, device),
            "chord_progression": torch.randint(0, 8, (w,), generator=gen,
                                               device=device)[None].repeat(args.k, 1),
        }
        tf, th, errs = group_scores(teacher_features, head, z_img, targets, args.bf16)
        agree += int(torch.argmin(tf)) == int(torch.argmin(th))
        for k, v in errs.items():
            errs_acc[k].append(float(v))
    agreement = agree / args.agree_groups
    print(f"selection agreement (k={args.k}, {args.agree_groups} groups): "
          f"{agreement:.3f}")
    for k, v in errs_acc.items():
        print(f"feature error [{k}]: {np.mean(v):.5f}")

    out_path = args.out.format(ch=args.ch)
    write_npz(out_path, head, "head", agreement)
    return dict(losses=log.logged, step_ms=log.step_ms, agreement=agreement,
                errors={k: float(np.mean(v)) for k, v in errs_acc.items()},
                out=out_path, student=head, teacher=teacher)


if __name__ == "__main__":
    main()
