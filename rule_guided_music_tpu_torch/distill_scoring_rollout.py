"""Distill a reduced-size rollout denoiser for SCG candidate ranking.

    python -m rule_guided_music_tpu_torch.distill_scoring_rollout [--device cuda]

Counterpart of ``scripts/distill_scoring_rollout.py``, with its flags and
defaults plus ``--device``. The guided SCG step spends k/(k+1) of its
denoiser work on the one-step candidate rollout, whose x̂0 only ranks the
candidates; a smaller DiTRotary (default ``DiTRotary_B_8``) can stand in
there while the chain keeps the full model. The student learns the
teacher's (default ``DiTRotary_XL_8``) x̂0 (``predict_xstart_from_eps``
with ``tables.model_t[t]`` fed to the model; both ``learn_sigma=False``,
``--num_classes`` labels) by MSE on (x_t, t, y) from the sampler's
operating range: unit-gaussian latents noised to a uniform t < t_max.

The agreement gate ranks k candidates at a shared t by ``pitch_hist``
against a random target, decoded by a ``--vae_ch`` VAE, with the teacher's
and the student's x̂0; a group whose teacher losses all tie is skipped
(vacuous), and a warning says so when every group ties.

Without ``--model_path`` the teacher is the JAX initialisation
(``init_weights_``) perturbed as the JAX script perturbs it: adaLN-Zero
makes the output exactly 0 at init, so 0.02 * N(0, 1) from
``np.random.default_rng(seed)`` is added to every leaf in the order
``jax.tree_util`` flattens the Flax tree (:func:`perturb_`). Writes the
student as an npz of its Flax tree and ``agreement``. ``main`` returns
what it measured and the trained student.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import convert, pipeline
from .diffusion import gaussian as gd
from .diffusion.latent import make_decode_fn
from .diffusion.schedule import make_schedule
from .models.dit import DiT_models, init_weights_
from .models.vae import AutoencoderKL
from .rules.registry import FUNC_DICT
from .training.distill import (TrainLog, autocast, flax_init_, softmax_targets,
                               str2bool, write_npz)


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--teacher", default="DiTRotary_XL_8")
    parser.add_argument("--student", default="DiTRotary_B_8")
    parser.add_argument("--model_path", default="",
                        help="teacher weights (converted bundle)")
    parser.add_argument("--vae_path", default="",
                        help="VAE weights for the agreement gate's decode")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--t_max", type=int, default=750,
                        help="distill over the guided-step range t < t_max")
    parser.add_argument("--agree_groups", type=int, default=32)
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--num_classes", type=int, default=3)
    parser.add_argument("--vae_ch", type=int, default=128,
                        help="agreement-gate VAE width (reduce for smoke)")
    parser.add_argument("--out", default="loggings/scoring_rollout/{student}.npz")
    parser.add_argument("--bf16", type=str2bool, default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


@torch.no_grad()
def perturb_(model: torch.nn.Module, seed: int, scale: float = 0.02,
             kind: str = "dit") -> torch.nn.Module:
    """Add ``scale`` * N(0, 1) from ``np.random.default_rng(seed)`` to every
    parameter, drawn in Flax layout in the order ``jax.tree_util`` flattens
    ``{"params": tree}`` (dict keys sorted at every level: the paths'
    component tuples in sorted order), each draw cast to float32 before
    the add, as the JAX script does."""
    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    leaves = []
    for name, p in params.items():
        path, perm = convert.flax_path(name, tuple(p.shape), kind,
                                       isinstance(modules[name.rpartition(".")[0]],
                                                  torch.nn.Embedding))
        leaves.append((tuple(f"params/{path}".split("/")), name, perm))
    for _, name, perm in sorted(leaves):
        p = params[name]
        flax_shape = [p.shape[perm.index(d)] for d in range(p.dim())]
        noise = (scale * rng.standard_normal(flax_shape)).astype(np.float32)
        p.add_(torch.from_numpy(np.ascontiguousarray(np.transpose(noise, perm)))
               .to(p.device))
    return model


def build(args, device):
    """(teacher, student), float32 on ``device``: the registry's DiTs on
    (4, 128, 16) with ``num_classes`` and no learned sigma, JAX-initialised
    from seeds 1 and 2 (the JAX script's init keys)."""
    kw = dict(input_size=(128, 16), in_channels=4, num_classes=args.num_classes,
              learn_sigma=False)
    teacher = init_weights_(DiT_models[args.teacher](**kw),
                            torch.Generator().manual_seed(1))
    if args.model_path:
        pipeline.load_weights(teacher, args.model_path, "dit")
        print(f"teacher: {args.model_path}")
    else:
        perturb_(teacher, args.seed)
        print("teacher: random-init, perturbed (no --model_path)")
    student = init_weights_(DiT_models[args.student](**kw),
                            torch.Generator().manual_seed(2))
    return teacher.to(device).eval().requires_grad_(False), student.to(device)


def build_vae(args, device) -> AutoencoderKL:
    """The gate's decoder: ``--vae_ch`` wide, Flax-initialised from seed 3
    unless ``--vae_path`` is given."""
    vae = flax_init_(AutoencoderKL(ch=args.vae_ch), 3)
    if args.vae_path:
        pipeline.load_weights(vae, args.vae_path, "vae")
    return vae.to(device).eval().requires_grad_(False)


def sample_batch(tables, gen, batch: int, t_max: int, num_classes: int):
    """(x_t, t, y): unit gaussian latents noised to a uniform t < t_max,
    labels uniform over ``max(num_classes, 1)``."""
    device = tables.betas.device
    x = torch.randn((batch, 4, 128, 16), generator=gen, device=device)
    t = torch.randint(0, t_max, (batch,), generator=gen, device=device)
    noise = torch.randn(x.shape, generator=gen, device=device)
    y = torch.randint(0, max(num_classes, 1), (batch,), generator=gen, device=device)
    return gd.q_sample(tables, x, t, noise), t, y


def x0_from(model, tables, x_t, t, y, bf16: bool):
    """The model's x̂0 of ``x_t``: its eps at ``tables.model_t[t]``."""
    with autocast(x_t.device, bf16):
        eps = model(x_t, tables.model_t[t], y)
    return gd.predict_xstart_from_eps(tables, x_t, t, eps.float())


def make_step(student, optimizer, tables, bf16: bool):
    """One Adam step on the MSE between the student's x̂0 and the
    teacher's; returns the loss."""
    def step(x_t, t, y, target_x0):
        optimizer.zero_grad(set_to_none=True)
        loss = ((x0_from(student, tables, x_t, t, y, bf16) - target_x0) ** 2).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


@torch.no_grad()
def group_rank(teacher, student, vae, tables, x_t, t, target_ph, bf16: bool):
    """One gate group: (teacher's argmin, student's argmin, MSE of the two
    rank losses, spread of the teacher's), each candidate's x̂0 decoded and
    scored by pitch_hist against ``target_ph``."""
    y = torch.zeros(x_t.shape[0], dtype=torch.long, device=x_t.device)
    losses = {}
    for name, model in (("t", teacher), ("s", student)):
        x0 = x0_from(model, tables, x_t, t, y, bf16)
        with autocast(x_t.device, bf16):
            roll = make_decode_fn(vae.decode)(x0)
        losses[name] = ((FUNC_DICT["pitch_hist"](roll) - target_ph) ** 2).mean(dim=-1)
    spread = losses["t"].max() - losses["t"].min()
    return (int(torch.argmin(losses["t"])), int(torch.argmin(losses["s"])),
            float(((losses["t"] - losses["s"]) ** 2).mean()), float(spread))


def gate_inputs(tables, gen, k: int, t_max: int):
    """(x_t, t) of one group: k unit latents noised to one shared t."""
    device = tables.betas.device
    t_scalar = torch.randint(0, t_max, (), generator=gen, device=device)
    t = t_scalar.expand(k).to(torch.long)
    x = torch.randn((k, 4, 128, 16), generator=gen, device=device)
    noise = torch.randn(x.shape, generator=gen, device=device)
    return gd.q_sample(tables, x, t, noise), t


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    device = pipeline.resolve_device(args.device)
    teacher, student = build(args, device)
    n_t = sum(p.numel() for p in teacher.parameters())
    n_s = sum(p.numel() for p in student.parameters())
    print(f"student {args.student}: {n_s/1e6:.0f}M params "
          f"(teacher {args.teacher}: {n_t/1e6:.0f}M)")
    tables = make_schedule("linear", 1000).tables(device)
    step = make_step(student, torch.optim.Adam(student.parameters(), lr=args.lr),
                     tables, args.bf16)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    log = TrainLog(every=100)
    for i in range(args.steps):
        x_t, t, y = sample_batch(tables, gen, args.batch, args.t_max,
                                 args.num_classes)
        with torch.no_grad():
            target = x0_from(teacher, tables, x_t, t, y, args.bf16)
        loss = float(step(x_t, t, y, target))
        log.step(i, loss, f"x0-MSE {loss:.5f}")

    student.eval()
    vae = build_vae(args, device)
    agree, n_valid, mses = 0, 0, []
    for _ in range(args.agree_groups):
        x_t, t = gate_inputs(tables, gen, args.k, args.t_max)
        target_ph = softmax_targets(gen, args.k, 12, device)
        a, b, mse, spread = group_rank(teacher, student, vae, tables, x_t, t,
                                       target_ph, args.bf16)
        if spread < 1e-9:
            # every candidate scores alike (a random VAE may decode below the
            # roll threshold): agreement would be vacuous
            continue
        n_valid += 1
        agree += a == b
        mses.append(mse)
    if n_valid == 0:
        print("WARNING: every candidate group tied — the decode path is "
              "degenerate (random weights?); agreement not measurable")
        agreement = 0.0
    else:
        agreement = agree / n_valid
        print(f"selection agreement (k={args.k}, {n_valid}/{args.agree_groups} "
              f"non-tied groups): {agreement:.3f} (chance {1/args.k:.3f}); "
              f"rank-loss MSE {np.mean(mses):.6f}")

    out_path = args.out.format(student=args.student.replace("/", "_"))
    write_npz(out_path, student, "dit", agreement)
    return dict(losses=log.logged, step_ms=log.step_ms, agreement=agreement,
                valid_groups=n_valid, out=out_path, student=student,
                teacher=teacher)


if __name__ == "__main__":
    main()
