"""The reference's judgement of a sampling chain, step by step.

A served chain is chaotic: an SCG pick that rounding tips one way sends
the chain elsewhere, so the reference follows the program from the
program's own states. At each checked step it takes the state x_t that
the program's denoiser received and recomputes, in float32 with TF32 off,
the denoiser's output and the guided mean (with the classifier gradient
the program applied, which is judged by itself). At a guided step it
also recomputes every one of the k candidates from the benchmark's own
noise (``cand_err``), the rollout of the program's candidates, their x0
cut into the decoder's chunks (``x0_err``, the decoder's input), and the
decode of the program's decoder input (``decode_err``). The candidate
the program kept must be the one that the reference's rules, scoring the
program's decoded candidates, put first (``pick_miss``, an exact
comparison), and the next state must be that candidate (``update_err``).
The final decode is judged on the chain's own latents.

``readings(..., fp8=True)`` puts the reference computed in float8 in the
program's place: the control, which has to read as not correct.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import diffusion as D
from . import models as M
from . import rules as R


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def cond_grad(classifiers, specs, x, tm, targets):
    """d/dx of sum over the guidance terms of scale * log p(rule | x_t)."""
    with torch.enable_grad():
        x = x.detach().float().requires_grad_()
        total = 0.0
        for (fn, rule, scale), clf in zip(specs, classifiers):
            if fn == "grad_nn_zt_mse":
                lp = -((clf(x, tm) - targets[rule].float()) ** 2).sum(-1)
            elif fn == "grad_nn_zt_chord":
                logp = F.log_softmax(clf(x, tm)[1], -1)
                lp = torch.gather(logp, -1, targets[rule].long()[..., None])[..., 0].mean(-1)
            else:
                raise ValueError(f"guidance term {fn} has no reference")
            total = total + scale * lp.sum()
        return torch.autograd.grad(total, x)[0]


class Models:
    """The reference's models of a sampling cell, weights from the
    benchmark's initializer (rounded to the served dtype)."""

    def __init__(self, cfg, seeds, device, init_):
        dt = getattr(torch, cfg["dtype"])
        self.dit = init_(M.build("dit", cfg["denoiser"], device), seeds["dit"], dt)
        self.vae = init_(M.build("vae", cfg["vae"], device), seeds["vae"], dt)
        self.classifiers = [init_(M.build("classifier", dict(c, input_size=cfg["denoiser"]["input_size"],
                                                             in_channels=cfg["denoiser"]["in_channels"]), device),
                                  seeds[f"cls{i}"], dt)
                            for i, c in enumerate(cfg.get("classifiers_used", []))]


@torch.no_grad()
def readings(cap, models: Models, sched: D.Schedule, plan: dict, noise, fp8: bool = False,
             block: int = 64) -> Dict[str, float]:
    """The numbers compared for one captured chain. ``cap`` holds the
    program's tensors: ``traj_in``/``traj_out`` by step position,
    ``roll_in``/``roll_out``, ``dec_in``/``dec_out`` at checked guided
    positions, ``latents`` and ``rolls``. ``plan``: steps, guided flags,
    sampler, eta, k, targets, weights, specs, num_classes, scale_factor,
    t_end. With ``fp8`` the reference in float8 stands in for the
    program's outputs (the control)."""
    out: Dict[str, float] = {}
    add = lambda k, v: out.__setitem__(k, max(out.get(k, float("-inf")), v))
    dit, vae = models.dit, models.vae
    k, nsteps, start = plan["k"], sched.n, sched.n - 1
    targets = plan["targets"]
    null = plan["num_classes"]

    def run_dit(x, t_idx, fp8_on):
        M.set_fp8(dit, fp8_on)
        y = torch.full((x.shape[0],), null, dtype=torch.long, device=x.device)
        tm = sched.model_t[t_idx]
        return torch.cat([dit(x[i:i + block], tm[i:i + block], y[i:i + block])
                          for i in range(0, x.shape[0], block)])

    def grad(x, t_idx, fp8_on):
        for c in models.classifiers:
            M.set_fp8(c, fp8_on)
        return cond_grad(models.classifiers, plan["specs"], x, sched.model_t[t_idx], targets)

    for pos in plan["steps"]:
        t = start - pos
        x = cap["traj_in"][pos].float()
        b = x.shape[0]
        tb = torch.full((b,), t, dtype=torch.long, device=x.device)
        x_next = (cap["traj_in"][pos + 1] if pos + 1 < nsteps else cap["latents"]).float()
        eps_r = run_dit(x, tb, False)
        eps_p = run_dit(x, tb, True) if fp8 else cap["traj_out"][pos].float()
        add("dit_err", rel(eps_p, eps_r))
        guided_cls = bool(plan["specs"])
        if plan["sampler"] == "ddpm":
            mean_r, var, g = D.ddpm_mean_var(sched, x, tb, eps_r)
            mean_0 = D.ddpm_mean_var(sched, x, tb, torch.zeros_like(eps_r))[0]
            if guided_cls:
                grad_r = grad(x, tb, False)
                grad_p = grad(x, tb, True) if fp8 else cap["grad"][pos].float()
                add("grad_err", rel(grad_p, grad_r))
                # the step is judged given the gradient it applied; the
                # gradient is judged above
                mean_r = mean_r + var * grad_p
            nz = float(t > plan["t_end"])
        else:
            mean_r, g = D.ddim_mean_sigma(sched, x, tb, eps_r, plan["eta"])
            mean_0 = D.ddim_mean_sigma(sched, x, tb, torch.zeros_like(eps_r), plan["eta"])[0]
            nz = float(t != plan["t_end"])
        guided = pos in plan["guided"]
        if fp8:
            mean_8 = D.ddpm_mean_var(sched, x, tb, eps_p)[0] if plan["sampler"] == "ddpm" \
                else D.ddim_mean_sigma(sched, x, tb, eps_p, plan["eta"])[0]
            mean_got = mean_8 + (var * grad_p if guided_cls else 0.0)
        # a step's error in units of what the denoiser's output moves it
        unit = (mean_r - mean_0).double().norm().clamp(min=1e-300)
        if guided:
            z = noise("scg", pos, (k,) + tuple(x.shape))
            cand_p = cap["roll_in"][pos].float().reshape((k,) + tuple(x.shape))
            cand_w = mean_r[None] + g[None] * z
            cand_g = mean_got[None] + g[None] * z if fp8 else cand_p
            add("cand_err", max(float((cand_g[j] - cand_w[j]).double().norm() / unit)
                                for j in range(k)))
            pick = torch.stack([(cand_p[:, i] - x_next[i]).flatten(1).norm(dim=1).argmin()
                                for i in range(b)])
            z_kept = z[pick, torch.arange(b, device=x.device)]
        else:
            z_kept = noise("scg" if plan["scg"] else "step", pos, tuple(x.shape))
        want = mean_r + nz * g * z_kept
        got = mean_got + nz * g * z_kept if fp8 else x_next
        add("update_err", float((got - want).double().norm() / unit))
        if guided:
            flat = cand_p.reshape((k * b,) + tuple(x.shape[1:]))
            tk = tb.repeat(k)
            roll_r = run_dit(flat, tk, False)
            roll_p = run_dit(flat, tk, True) if fp8 else cap["roll_out"][pos].float()
            add("dit_err", rel(roll_p, roll_r))
            M.set_fp8(vae, False)
            z_r = _decoder_input(vae, D.predict_x0(sched, flat, tk, roll_r), plan, block)
            if fp8:
                M.set_fp8(vae, True)
                z_in = _decoder_input(vae, D.predict_x0(sched, flat, tk, roll_p), plan, block)
                dec_p = _decoder(vae, z_in, block)
                M.set_fp8(vae, False)
            else:
                z_in = cap["dec_in"][pos].float()
                dec_p = cap["dec_out"][pos].to(x.device).float()
                add("pick_miss", _misses(dec_p, pick, plan, k, b))
            add("x0_err", rel(z_in, z_r))
            # the decoder judged at the program's own input; that input is
            # judged above
            add("decode_err", rel(dec_p, _decoder(vae, z_in, block)))
    M.set_fp8(vae, False)
    rolls_r = D.decode_latents(vae, cap["latents"].float(), plan["scale_factor"], block)
    if fp8:
        M.set_fp8(vae, True)
        rolls_p = D.decode_latents(vae, cap["latents"].float(), plan["scale_factor"], block)
        M.set_fp8(vae, False)
    else:
        rolls_p = cap["rolls"].float()
    add("decode_err", rel(rolls_p, rolls_r))
    M.set_fp8(dit, False)
    return out


def _decoder_input(vae, x0, plan, block):
    """Rolled-out latents -> what the decoder receives: x0 over the scale
    factor, cut into chunk-major 16 x 16 chunks, through post_quant_conv."""
    chunks = D.latent_to_chunks(x0 / plan["scale_factor"])
    return torch.cat([vae.post_quant_conv(chunks[i:i + block])
                      for i in range(0, len(chunks), block)])


def _decoder(vae, z, block):
    return torch.cat([vae.decoder(z[i:i + block]) for i in range(0, len(z), block)])


def _misses(chunks, pick, plan, k, b, tol=1e-5):
    """How many examples kept a candidate that the reference's rules,
    scoring the program's own decoded candidates, put below the best (by
    more than ``tol`` of the best score's size): the selection judged as
    an exact comparison."""
    rolls = D.chunks_to_pixels(chunks, chunks.shape[0] // (k * b))
    tiled = {n: torch.cat([v] * k) for n, v in plan["targets"].items()}
    s = R.scores(rolls, tiled, plan["weights"]).reshape(k, b)
    best = s.max(0).values
    kept = s[pick, torch.arange(b, device=s.device)]
    return float(((best - kept) > tol * (best.abs() + 1e-3)).sum())
