"""Distill a reduced-width scoring decoder for SCG candidate selection.

    python -m rule_guided_music_tpu_torch.distill_scoring_decoder [--device cuda]

Counterpart of ``scripts/distill_scoring_decoder.py``, with its flags and
defaults plus ``--device``. The guided SCG step decodes its k candidates
only to rank them by rule loss; this trains a narrower ``ScoringDecoder``
(default ch=64) to match the full decoder (``--teacher_ch``, default 128)
with an L1 loss on latents N(0, latent_std^2) of (batch, 4, 16, 16), Adam
at ``--lr``, then measures what matters:

  * the per-rule MSE between light- and full-decoded rule vectors, and
  * SCG selection agreement: over ``--agree_groups`` groups of k latents
    (k, 4, 128, 16), the share where both decoders pick the same argmin of
    40 * pitch_hist + note_density against random targets.

Writes the student as an npz of its Flax tree and ``agreement``
(``training/distill.write_npz``), which ``pipeline.ScoringBundle.create``
and the JAX package both load. Without ``--vae_path`` the teacher is a
Flax-initialised random VAE, seeded. ``main`` returns what it measured and
the trained student.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from . import pipeline
from .diffusion.latent import make_decode_fn
from .models.vae import ScoringDecoder
from .rules.registry import FUNC_DICT
from .training.distill import (TrainLog, autocast, flax_init_, softmax_targets,
                               str2bool, teacher_vae, uniform_targets, write_npz)

RULES = ("pitch_hist", "note_density")


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vae_path", default="")
    parser.add_argument("--teacher_ch", type=int, default=128,
                        help="teacher VAE width (reduce for CPU smoke tests)")
    parser.add_argument("--ch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-3)
    # deployment feeds the scoring decoder x0 / scale_factor, so the
    # operating input std is ~1/1.2465
    parser.add_argument("--latent_std", type=float, default=1.0 / 1.2465,
                        help="std of the decoder-input latent dist "
                             "(default 1/scale_factor = deployment point)")
    parser.add_argument("--agree_groups", type=int, default=32,
                        help="(B,k) groups for selection-agreement eval")
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--out", default="loggings/scoring_decoder/ch{ch}.npz")
    parser.add_argument("--bf16", type=str2bool, default=True)
    parser.add_argument("--save_dtype", default="float32",
                        choices=["float32", "float16"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def build(args, device):
    """(teacher AutoencoderKL decoder, student ScoringDecoder), float32 on
    ``device``: the JAX script's init keys 1 and 3 become seeds 1 and 3."""
    teacher = teacher_vae(args.teacher_ch, args.vae_path)
    student = flax_init_(ScoringDecoder(ch=args.ch), 3)
    return teacher.to(device).eval().requires_grad_(False), student.to(device)


def make_step(student, optimizer, bf16: bool):
    """One Adam step on the L1 between the student's decode of ``z`` and
    ``target``; returns the loss."""
    def step(z, target):
        optimizer.zero_grad(set_to_none=True)
        with autocast(z.device, bf16):
            rec = student.decode(z)
        loss = (rec - target).abs().mean()
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


@torch.no_grad()
def group_losses(teacher, student, z_img, target_ph, target_nd,
                 bf16: bool) -> Dict[str, torch.Tensor]:
    """Both decoders' long rolls of ``z_img`` (k, 4, 128, 16) scored
    against the targets: per-candidate losses ``<rule>_f``/``<rule>_l``
    and the rule vectors' MSE ``<rule>_mse``."""
    with autocast(z_img.device, bf16):
        roll_f = make_decode_fn(teacher.decode)(z_img)
        roll_l = make_decode_fn(student.decode)(z_img)
    out = {}
    for name, tgt in (("pitch_hist", target_ph), ("note_density", target_nd)):
        vf, vl = FUNC_DICT[name](roll_f), FUNC_DICT[name](roll_l)
        out[f"{name}_f"] = ((vf - tgt) ** 2).mean(dim=-1)
        out[f"{name}_l"] = ((vl - tgt) ** 2).mean(dim=-1)
        out[f"{name}_mse"] = ((vf - vl) ** 2).mean()
    return out


def group_agrees(out: Dict[str, torch.Tensor]) -> bool:
    """Both decoders pick the same candidate under 40 * ph + nd."""
    total_f = out["pitch_hist_f"] * 40.0 + out["note_density_f"]
    total_l = out["pitch_hist_l"] * 40.0 + out["note_density_l"]
    return int(torch.argmin(total_f)) == int(torch.argmin(total_l))


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    teacher, student = build(args, device)
    n_light = sum(p.numel() for p in student.parameters())
    n_full = sum(p.numel() for p in teacher.decoder.parameters())
    print(f"light decoder ch={args.ch}: {n_light/1e6:.1f}M params "
          f"(full decoder: {n_full/1e6:.1f}M)")

    step = make_step(student, torch.optim.Adam(student.parameters(), lr=args.lr),
                     args.bf16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    log = TrainLog(every=50)
    for i in range(args.steps):
        z = torch.randn((args.batch, 4, 16, 16), generator=gen,
                        device=device) * args.latent_std
        with torch.no_grad(), autocast(device, args.bf16):
            target = teacher.decode(z)
        loss = float(step(z, target))
        log.step(i, loss, f"L1 {loss:.4f}")

    student.eval()
    agree, rule_mse = 0, {r: [] for r in RULES}
    for _ in range(args.agree_groups):
        z_img = torch.randn((args.k, 4, 128, 16), generator=gen,
                            device=device) * args.latent_std
        target_ph = softmax_targets(gen, args.k, 12, device)
        target_nd = uniform_targets(gen, args.k, 16, device)
        out = group_losses(teacher, student, z_img, target_ph, target_nd, args.bf16)
        agree += group_agrees(out)
        for r in RULES:
            rule_mse[r].append(float(out[f"{r}_mse"]))
    agreement = agree / args.agree_groups
    print(f"selection agreement (k={args.k}, {args.agree_groups} groups): "
          f"{agreement:.3f}")
    for r in RULES:
        print(f"rule-vector MSE light-vs-full [{r}]: {np.mean(rule_mse[r]):.5f}")

    out_path = args.out.format(ch=args.ch)
    write_npz(out_path, student, "vae", agreement, args.save_dtype)
    return dict(losses=log.logged, step_ms=log.step_ms, agreement=agreement,
                rule_mse={r: float(np.mean(v)) for r, v in rule_mse.items()},
                out=out_path, student=student, teacher=teacher)


if __name__ == "__main__":
    main()
