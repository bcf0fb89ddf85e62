"""GPipe and circular pipeline parallelism over a ``stage`` mesh axis.

Port of ``rule_guided_music_tpu/parallel/pipeline.py``. The DiT's blocks
are stacked on a leading axis (:func:`stack_block_params`, on the
``blocks.{i}.`` keys of a state dict); stage s of S applies its blocks,
and microbatches move stage to stage by :func:`comm.ppermute`, whose
backward sends the gradient back, so the schedules differentiate with
respect to the block parameters and the input, as JAX's do.

As in JAX, every stage computes at every tick (the fill and drain ticks on
zeros, never collected), and every tick's result joins the output graph
(times zero), so every rank runs the same sequence of exchanges forward
and backward; the last stage's results go to every stage by a sum in
which only it contributes (:func:`comm.reduce_from`, whose backward hands
the gradient to that stage alone).

  * :func:`gpipe_apply`: stage s holds blocks [s L/S, (s+1) L/S); M
    microbatches, ``M + S - 1`` ticks; stage s computes microbatch
    ``t - s`` at tick t.
  * :func:`circular_pipeline_apply`: stage s holds the v = L/S blocks
    ``r S + s``; M = S microbatches go v times round the ring, one block a
    tick, ``S v + S - 1`` ticks.

``mesh`` is a 1-D DeviceMesh with the dim ``axis``, or None for one stage
(every block on this rank: no exchange). Each schedule takes the stack of
this stage's blocks alone, in :func:`stage_blocks`' order, as JAX's
``P(axis)`` placement of the stack gives a stage its own; a caller that
holds the whole stack slices it there, and the gradient of the whole
stack is then nonzero on each rank only on its own blocks, that of the
input only on stage 0: the sums over ranks are the gradients.
:func:`keep_stage_blocks_` drops the other stages' blocks from a DiT, so
that a stage holds only the blocks it runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils._pytree import tree_leaves, tree_map

from .comm import Axis, ppermute, reduce_from


def stack_block_params(state: Dict[str, torch.Tensor], n_blocks: int,
                       prefix: str = "blocks."
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split a state dict into (the blocks' tensors stacked on a new leading
    axis, by their name within a block; the rest)."""
    names = [k[len(f"{prefix}0."):] for k in state if k.startswith(f"{prefix}0.")]
    stacked = {n: torch.stack([state[f"{prefix}{i}.{n}"] for i in range(n_blocks)])
               for n in names}
    rest = {k: v for k, v in state.items() if not k.startswith(prefix)}
    return stacked, rest


def unstack_block_params(stacked: Dict[str, torch.Tensor],
                         rest: Dict[str, torch.Tensor],
                         prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_block_params`."""
    out = dict(rest)
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        out.update({f"{prefix}{i}.{k}": v[i] for k, v in stacked.items()})
    return out


def stage_blocks(n_blocks: int, n_stages: int, stage: int,
                 schedule: str = "gpipe") -> list:
    """The indices of the blocks that stage ``stage`` of ``n_stages`` runs,
    in the order it runs them: [s L/S, (s+1) L/S) under ``"gpipe"``, r S + s
    for r < L/S under ``"circular"``."""
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} blocks do not split over {n_stages} stages")
    if schedule == "gpipe":
        per = n_blocks // n_stages
        return list(range(stage * per, (stage + 1) * per))
    if schedule == "circular":
        return list(range(stage, n_blocks, n_stages))
    raise ValueError(f"schedule {schedule!r}: gpipe or circular")


class DroppedBlock(nn.Module):
    """Stands in ``model.blocks`` for a block that another stage holds: no
    parameters, and calling it raises."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} is held by another pipeline stage")


def keep_stage_blocks_(model: nn.Module, mesh=None, axis: str = "stage",
                       schedule: str = "gpipe") -> nn.Module:
    """Keep in ``model.blocks`` only the blocks this rank's stage of
    ``mesh[axis]`` runs under ``schedule`` (:func:`stage_blocks`); each
    other block becomes a :class:`DroppedBlock`. In place; returns
    ``model``. Call it before the model moves to its device: the stage then
    holds its L/S blocks and every module outside ``model.blocks`` (the
    embedders and the final layer run on every stage)."""
    stage = Axis.of(mesh, axis)
    keep = set(stage_blocks(len(model.blocks), stage.size, stage.rank, schedule))
    for i in range(len(model.blocks)):
        if i not in keep:
            model.blocks[i] = DroppedBlock(i)
    return model


def _run(block_fn, local, x, *, stage: Axis, n_micro: int, n_ticks: int,
         chunk_at: Callable[[int], Optional[int]], inject_at: Callable[[int], bool],
         emit_at: Callable[[int], Optional[int]], ring: bool):
    """The shared tick loop: at tick t this stage takes a fresh microbatch
    where ``inject_at(t)``, else what the stage before sent; applies its
    local blocks ``chunk_at(t)`` (an index, or None for all); collects the
    result as microbatch ``emit_at(t)`` where not None."""
    batch = tree_leaves(x)[0].shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} microbatches")
    mb = batch // n_micro
    x_mb = tree_map(lambda a: a.reshape((n_micro, mb) + a.shape[1:]), x)
    n_local = tree_leaves(local)[0].shape[0]
    carry = tree_map(lambda a: torch.zeros_like(a[0]), x_mb)
    outs, anchor = [None] * n_micro, 0.0
    for t in range(n_ticks):
        if inject_at(t):
            fresh = tree_map(lambda a: a[min(t, n_micro - 1)], x_mb)
            # the received carry stays in the graph (with a zero gradient)
            # so that its exchange runs backward on every rank alike
            cur = tree_map(lambda i, c: i + 0 * c, fresh, carry)
        else:
            cur = carry
        r = chunk_at(t)
        for j in range(n_local) if r is None else (r,):
            cur = block_fn(tree_map(lambda a: a[j], local), cur)
        m = emit_at(t)
        if m is not None:
            outs[m] = cur
        # every tick's result reaches the output (times zero), so that each
        # rank runs the backward of every exchange, in the same order
        anchor = anchor + sum(0 * a.sum() for a in tree_leaves(cur))
        if t < n_ticks - 1:
            carry = tree_map(lambda a: ppermute(a, stage, ring=ring), cur)
    is_last = stage.rank == stage.size - 1
    out = [o if is_last else tree_map(torch.zeros_like, tree_map(lambda a: a[0], x_mb))
           for o in outs]
    out = tree_map(lambda *ms: torch.stack(ms), *out)
    out = tree_map(lambda a: reduce_from(a + anchor.to(a.dtype), stage), out)
    return tree_map(lambda a: a.reshape((batch,) + a.shape[2:]), out)


def gpipe_apply(block_fn: Callable[[Any, Any], Any], local_params, x, *,
                mesh=None, axis: str = "stage", n_micro: Optional[int] = None):
    """Apply a stack of identical blocks, pipelined over ``mesh[axis]``.

    ``block_fn(one_block_params, carry) -> carry`` for a single block;
    ``local_params`` a pytree whose leading axis holds this stage's L/S
    blocks, [s L/S, (s+1) L/S) of the L; ``x`` a carry pytree with a
    leading batch axis on every leaf; ``n_micro`` microbatches (default:
    the stage count). Returns the carry after all L blocks, on every
    stage."""
    stage = Axis.of(mesh, axis)
    n_stages, s = stage.size, stage.rank
    n_micro = n_micro or n_stages
    last = n_stages - 1

    def emit(t):
        m = t - last
        return m if s == last and 0 <= m < n_micro else None

    return _run(block_fn, local_params, x, stage=stage, n_micro=n_micro,
                n_ticks=n_micro + n_stages - 1, chunk_at=lambda t: None,
                inject_at=lambda t: s == 0, emit_at=emit, ring=False)


def circular_pipeline_apply(block_fn: Callable[[Any, Any], Any], local_params, x,
                            *, mesh=None, axis: str = "stage"):
    """Interleaved ("circular") schedule: stage s holds the ``v = L / S``
    blocks ``r S + s``, ``local_params`` those alone in order of r;
    ``M = S`` microbatches make v passes round the stage ring, one block a
    tick: ``S v + S - 1`` ticks against GPipe's ``(M + S - 1) v``
    block-ticks."""
    stage = Axis.of(mesh, axis)
    n_stages, s = stage.size, stage.rank
    v = tree_leaves(local_params)[0].shape[0]
    last = n_stages - 1

    def emit(t):
        m = t - last - (v - 1) * n_stages
        return m if s == last and 0 <= m < n_stages else None

    return _run(block_fn, local_params, x, stage=stage, n_micro=n_stages,
                n_ticks=v * n_stages + n_stages - 1,
                chunk_at=lambda t: min(max((t - s) // n_stages, 0), v - 1),
                inject_at=lambda t: s == 0 and t < n_stages, emit_at=emit,
                ring=True)


def pipelined_dit_rotary_apply(model, x: torch.Tensor, t: torch.Tensor,
                               y: Optional[torch.Tensor] = None, *, mesh=None,
                               axis: str = "stage", n_micro: Optional[int] = None,
                               schedule: str = "gpipe") -> torch.Tensor:
    """``model(x, t, y)`` (a DiTRotary, eval path: no label dropout) with
    its blocks pipelined over ``mesh[axis]`` by :func:`gpipe_apply`
    (``schedule="gpipe"``) or :func:`circular_pipeline_apply`
    (``"circular"``; the batch a multiple of the stage count). The
    embedders and the final layer run on every stage. The stack the
    schedules take is this stage's block indices (:func:`stage_blocks`):
    each stage calls only its own ``model.blocks[i]``, so the gradient
    reaches the model's parameters, and a model trimmed by
    :func:`keep_stage_blocks_` with the same mesh and schedule, which holds
    only those blocks, runs as the whole one does."""
    dtype = model.final_layer.linear.weight.dtype
    b, _, h, w = x.shape
    tokens = model.x_embedder(x.to(dtype))
    c = model.t_embedder(t)
    if model.y_embedder is not None and y is not None:
        c = c + model.y_embedder(y)
    rotary = model.rotary_table(h * w // model.patch_size, x.device)

    def block_fn(index, carry):
        xt, cc = carry
        return model.blocks[int(index)](xt, cc, rotary), cc

    stage = Axis.of(mesh, axis)
    blocks = torch.tensor(stage_blocks(len(model.blocks), stage.size, stage.rank,
                                       schedule))
    if schedule == "circular":
        tokens, _ = circular_pipeline_apply(block_fn, blocks, (tokens, c),
                                            mesh=mesh, axis=axis)
    else:
        tokens, _ = gpipe_apply(block_fn, blocks, (tokens, c), mesh=mesh,
                                axis=axis, n_micro=n_micro)
    out = model.final_layer(tokens, c)
    out = out.reshape(b, -1, w, model.out_channels)
    return out.permute(0, 3, 1, 2).float()
