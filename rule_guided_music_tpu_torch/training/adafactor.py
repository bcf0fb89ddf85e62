"""Adafactor, as ``optax.adafactor`` computes it at its defaults.

Port of what the JAX package builds for ``--optimizer adafactor``
(``rule_guided_music_tpu/training/train_loop.py::make_optimizer``:
``optax.adafactor(learning_rate=schedule, weight_decay_rate=...)``), the
low-memory option: a factored estimate of the squared gradient's mean
keeps one row and one column vector for each parameter whose two largest
dims are both at least 128, where AdamW keeps two full moments. The chain
of one update, in optax's order:

1. factored RMS scaling (``scale_by_factored_rms``): with ``decay_t = 1 -
   (count + 1)^-0.8`` (0 on the first update) and ``g2 = g^2 + 1e-30``,
   ``v_row = decay_t v_row + (1 - decay_t) mean(g2, d0)``, ``v_col``
   likewise over ``d1``, and ``u = g (v_row / mean(v_row))^-1/2 v_col^-1/2``
   broadcast back; ``d1, d0`` are the two largest dims by ``np.argsort`` of
   the shape. An unfactored parameter keeps ``v`` of its own shape and
   takes ``u = g v^-1/2``;
2. block-RMS clipping: ``u / max(1, rms(u))``;
3. the learning rate: ``lr u`` (the group's ``lr``, which the train step
   sets from its anneal, as for AdamW);
4. the parameter's scale: ``u max(rms(p), 1e-3)``;
5. weight decay, where given: ``u + wd p``, after the learning rate, so
   not scaled by it (unlike AdamW's);
6. ``p - u``.

A torch Linear weight is the transpose of a flax kernel, and a torch conv
weight is ``(out, in, kh, kw)`` where flax has ``(kh, kw, in, out)``. The
factored dims are picked from the torch shape; they are the same two dims
of the weight, and the estimate ``v_row v_col / mean(v_row)`` is symmetric
in them, so the update is the same (where the two are equal in size, the
torch ``v_row`` holds what optax keeps as ``v_col``).

The state of each parameter: ``count`` (updates taken, an int), and
``v_row`` and ``v_col``, or ``v``, in the parameter's dtype; it goes
through ``state_dict()`` as any torch optimizer's. Unfactored parameters
take their update through ``torch._foreach_*`` calls; the factored ones
(reductions along their own dims) one by one, and the clipping, the
scales and the decay then act on every parameter's update at once.

A DTensor parameter (a mesh run, ``parallel.mesh``) is updated on its
local shard, and every reduction is over the global tensor: the factored
means over d0 and d1 sum the shard and all-reduce over the mesh dims that
shard that dim, and the RMS of the update and of the parameter come from
one all-reduce of every parameter's sum of squares. ``v_row`` and
``v_col`` are DTensors placed as the parameter less the reduced dim
(:func:`factor_placements`), ``v`` as the parameter.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel.mesh import as_placed, local, sum_squares

DECAY_RATE = 0.8
MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """The two largest dims (second largest, largest), or None where the
    second largest is below 128 or the tensor has fewer than two dims
    (optax ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def decay_rate_at(count: int) -> float:
    """``1 - (count + 1)^-0.8`` in float32, as optax computes it."""
    t = np.float32(count + 1)
    return float(np.float32(1.0) - t ** np.float32(-DECAY_RATE))


def factor_placements(p: DTensor, key: str) -> tuple:
    """The placements of ``v_row`` (``p`` less its largest dim d0) or
    ``v_col`` (less d1) of a DTensor parameter: replicated over the mesh
    dims that sharded the reduced dim, the other shards moved down."""
    from torch.distributed.tensor import Replicate, Shard

    d1, d0 = factored_dims(tuple(p.shape))
    gone = d0 if key == "v_row" else d1
    out = []
    for q in p.placements:
        if isinstance(q, Shard):
            q = Replicate() if q.dim == gone else Shard(q.dim - (q.dim > gone))
        out.append(q)
    return tuple(out)


def _global_mean(x: torch.Tensor, p, dim_x: int, dim_p: int) -> torch.Tensor:
    """The mean over dim ``dim_x`` of a shard ``x`` whose dim is the
    parameter ``p``'s ``dim_p``: the shard's sum, all-reduced over the mesh
    dims that shard ``dim_p``, over the global size."""
    total = x.sum(dim_x)
    if isinstance(p, DTensor):
        mesh = p.device_mesh
        for i, q in enumerate(p.placements):
            if getattr(q, "dim", None) == dim_p and q.is_shard():
                dist.all_reduce(total, group=mesh.get_group(i))
    return total / p.shape[dim_p]


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate=lr, weight_decay_rate=weight_decay)``
    at its other defaults (factored, decay rate 0.8, clipping 1.0,
    parameter scale on, no momentum); ``weight_decay`` None or 0 for
    none."""

    def __init__(self, params, lr: float = 1e-3,
                 weight_decay: Optional[float] = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay or 0.0))

    def _init_state(self, p: torch.Tensor) -> dict:
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            return {"count": 0, "v": torch.zeros_like(p)}
        d1, d0 = dims
        shard = local(p)
        row = list(shard.shape)
        del row[d0]
        col = list(shard.shape)
        del col[d1]
        state = {"count": 0, "v_row": shard.new_zeros(row), "v_col": shard.new_zeros(col)}
        if isinstance(p, DTensor):
            for key in ("v_row", "v_col"):
                state[key] = DTensor.from_local(state[key], p.device_mesh,
                                                factor_placements(p, key),
                                                run_check=False)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(params, group["lr"], group["weight_decay"])
        return loss

    def _update(self, params, lr: float, weight_decay: float) -> None:
        states = []
        for p in params:
            if not self.state[p]:
                self.state[p] = self._init_state(p)
            states.append(self.state[p])
        locals_ = [local(p) for p in params]
        grads = [local(p.grad) for p in params]
        updates = [None] * len(params)
        plain = [i for i, s in enumerate(states) if "v" in s]
        # 1. the factored RMS scaling
        for i, (p, s) in enumerate(zip(params, states)):
            if "v" in s:
                continue
            decay = decay_rate_at(s["count"])
            d1, d0 = factored_dims(tuple(p.shape))
            g = grads[i]
            g2 = g * g + EPS
            v_row, v_col = local(s["v_row"]), local(s["v_col"])
            v_row.mul_(decay).add_(_global_mean(g2, p, d0, d0), alpha=1.0 - decay)
            v_col.mul_(decay).add_(_global_mean(g2, p, d1, d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = _global_mean(v_row, p, reduced_d1, d1).unsqueeze(reduced_d1)
            row_factor = (v_row / row_mean).rsqrt_()
            col_factor = v_col.rsqrt()
            torch.mul(g, row_factor.unsqueeze(d0), out=g2)
            updates[i] = g2.mul_(col_factor.unsqueeze(d1))
        if plain:
            # every parameter has taken as many updates as every other
            decay = decay_rate_at(states[plain[0]]["count"])
            pgrads = [grads[i] for i in plain]
            vs = [local(states[i]["v"]) for i in plain]
            g2 = torch._foreach_mul(pgrads, pgrads)
            torch._foreach_add_(g2, EPS)
            torch._foreach_mul_(vs, decay)
            torch._foreach_add_(vs, g2, alpha=1.0 - decay)
            inv = torch._foreach_rsqrt(vs)
            torch._foreach_mul_(inv, pgrads)
            for i, u in zip(plain, inv):
                updates[i] = u
        for s in states:
            s["count"] += 1
        # 2-4. clipping by the update's RMS, the rate, the parameter's RMS:
        # one factor a tensor
        sizes = torch.tensor([p.numel() for p in params], dtype=torch.float32,
                             device=locals_[0].device).sqrt_()
        if isinstance(params[0], DTensor):
            wrap = lambda ts: [as_placed(t, p) for t, p in zip(ts, params)]
            sq = sum_squares(wrap(updates) + wrap(locals_)).sqrt()
            rms_u, rms_p = sq[:len(params)] / sizes, sq[len(params):] / sizes
        else:
            rms_u = torch.stack(torch._foreach_norm(updates)).float() / sizes
            rms_p = torch.stack(torch._foreach_norm(locals_)).float() / sizes
        scale = torch.where(rms_p <= MIN_SCALE, MIN_SCALE, rms_p)
        factor = scale * lr / torch.clamp_min(rms_u / CLIPPING_THRESHOLD, 1.0)
        torch._foreach_mul_(updates, list(factor.unbind()))
        # 5. the decay, after the rate; 6. the step
        if weight_decay:
            torch._foreach_add_(updates, locals_, alpha=weight_decay)
        torch._foreach_sub_(locals_, updates)
