"""The reference's train steps: train_dit's first steps in float32 (TF32
off) from the same weights, batches and draws as the program's.

Per step: the frozen KL-VAE encoder's posterior mode of every 128-column
chunk, overlapping 8-chunk excerpts (``encode_rep`` of them a roll) times
the scale factor, x_t from the step's noise and timesteps, the denoiser
with the step's label-dropout mask, the MSE on eps weighted by the
sampler's weights, the backward in microbatches, AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay) written out, and the EMA. It starts
from the benchmark's weights with no optimizer state, or from a state
the program reached (parameters, AdamW's moments and step count, EMA),
to follow a step taken inside the window. Returns what the comparison
reads: each step's loss, the encoder's moments, the first gradient, and
the parameters' and the EMA's change after the last step, as norms by
unit (:func:`units`).

``fp8=True`` computes every product in float8 (the control); ``half=True``
leaves out half of each batch and takes the mean over the rest (a
planted fault).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import diffusion as D
from . import models as M


def adamw_(params, grads, state, step, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * wd)
            denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def units(name: str, t: torch.Tensor, width: int):
    """A leaf cut along its first dim into blocks of the model's width
    where that dim is a larger multiple of it (a fused qkv into q, k and v,
    an adaLN linear into its six modulations): the units whose norms are
    compared, so that a part that only round-off moves (a key's bias under
    softmax) can be told apart by the rule on the reference's gradient."""
    if t.dim() >= 1 and t.shape[0] > width and t.shape[0] % width == 0:
        return [(f"{name}[{i}]", t[i * width:(i + 1) * width])
                for i in range(t.shape[0] // width)]
    return [(name, t)]


def norms(tensors: Dict[str, torch.Tensor], width: int) -> Dict[str, float]:
    return {u: float(v.norm()) for n, t in tensors.items() for u, v in units(n, t, width)}


def run(cfg, dit, vae, steps: List[dict], fp8=False, half=False, micro=8,
        start: Optional[dict] = None) -> Dict:
    """``steps``: per step the rolls (B/rep, 3, 128, L), labels y (B,),
    timesteps t (B,), weights w (B,), noise (B, 4, 128, 16) and the
    dropout mask (B,), as the program's step received them. ``start``:
    by name, the ``params``, AdamW's moments ``m`` and ``v`` and the
    ``ema`` to start from, and AdamW's ``step`` count."""
    M.set_fp8(dit, fp8)
    M.set_fp8(vae, fp8)
    device = next(dit.parameters()).device
    sched = D.Schedule(cfg["diffusion_steps"], "", device)
    params = dict(dit.named_parameters())
    state, step0 = {}, 0
    if start is not None:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start["params"][n])
                state[n] = (start["m"][n].to(device).clone(), start["v"][n].to(device).clone())
        step0 = start["step"]
    p0 = {n: p.detach().clone() for n, p in params.items()}
    ema = {n: (start["ema"][n].to(device).clone() if start is not None else p.detach().clone())
           for n, p in params.items()}
    ema0 = {n: e.clone() for n, e in ema.items()}
    losses, moments, first_grad = [], [], None
    rate = cfg["ema_rate"]
    width = cfg["denoiser"]["hidden_size"]
    for i, st in enumerate(steps, start=step0 + 1):
        st = {k: v.to(device) for k, v in st.items()}
        with torch.no_grad():
            latents, mom = D.kl_input(vae, st["rolls"], cfg["scale_factor"],
                                      cfg["shift_size"])
        moments.append(mom)
        n = latents.shape[0]
        rows = torch.arange(n // 2 if half else n, device=device)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss_sum = 0.0
        for j in range(0, len(rows), micro):
            r = rows[j:j + micro]
            t = st["t"][r]
            x_t = D.q_sample(sched, latents[r], t, st["noise"][r])
            out = dit(x_t, sched.model_t[t], st["y"][r], st["drop"][r])
            mse = ((st["noise"][r] - out) ** 2).flatten(1).mean(1)
            loss = (mse * st["w"][r]).sum() / len(rows)
            g = torch.autograd.grad(loss, list(params.values()))
            for (k, _), gk in zip(params.items(), g):
                grads[k] += gk
            loss_sum += float(loss.detach())
        losses.append(loss_sum)
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        adamw_(params, grads, state, i, cfg["lr"], cfg["weight_decay"])
        with torch.no_grad():
            for k, p in params.items():
                ema[k].mul_(rate).add_(p, alpha=1 - rate)
    with torch.no_grad():
        update = {k: p - p0[k] for k, p in params.items()}
        ema_change = {k: ema[k] - ema0[k] for k in params}
    M.set_fp8(dit, False)
    M.set_fp8(vae, False)
    return {"loss": losses, "moments": moments, "grad": first_grad, "update": update,
            "ema": ema_change, "width": width}


def unit_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             grad_ref: Dict[str, torch.Tensor], width: int) -> float:
    """The worst unit's gap between two norms, |got - want| over the
    larger of ``want`` and the median unit's ``want``. Elements whose
    reference gradient is under a thousandth of the median unit's gradient
    per element (root mean square) move under Adam by round-off alone (a
    key's bias on the dims rotary leaves alone) and are left out of both
    norms."""
    rms = torch.tensor([float(v.norm()) / v.numel() ** 0.5 for n, t in grad_ref.items()
                        for _, v in units(n, t, width)])
    floor = 1e-3 * float(rms.median())
    g_n, w_n = {}, {}
    for name, g in grad_ref.items():
        keep = g.abs() >= floor
        dev = g.device
        for (u, k), (_, a), (_, b) in zip(units(name, keep, width),
                                          units(name, got[name].to(dev), width),
                                          units(name, want[name].to(dev), width)):
            if k.any():
                g_n[u], w_n[u] = float(a[k].norm()), float(b[k].norm())
    med = float(torch.tensor(list(w_n.values())).median())
    return max(abs(g_n[u] - w) / max(w, med) for u, w in w_n.items())


def norm_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The worst unit's gap between two norms, |got - want| over the
    larger of ``want`` and the median unit's ``want``."""
    med = float(torch.tensor(list(want.values())).median())
    return max(abs(got[u] - w) / max(w, med) for u, w in want.items())


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, the worst
    unit's gap of the first gradient, of the parameters' change and of the
    EMA's change, and the encoder's moments' relative error. ``prog``
    holds the first gradient as norms by unit or as tensors."""
    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    width = ref["width"]
    grad_p = prog["grad"]
    if not isinstance(next(iter(grad_p.values())), float):
        grad_p = norms(grad_p, width)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": norm_gap(grad_p, norms(ref["grad"], width)),
        "update_gap": unit_gap(prog["update"], ref["update"], ref["grad"], width),
        "ema_gap": unit_gap(prog["ema"], ref["ema"], ref["grad"], width),
        "latent_err": max(rel(a.to(b.device), b) for a, b in zip(prog["moments"], ref["moments"])),
    }
