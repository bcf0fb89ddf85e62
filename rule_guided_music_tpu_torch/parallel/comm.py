"""Differentiable collectives over one process group, and the axis they
run on.

Each op is a ``torch.autograd.Function`` whose backward is the transpose
of its forward, so a program built from them differentiates as JAX's
``shard_map`` programs do:

  * :func:`copy_to`   identity forward, all-reduce of the gradient (the
    entry of a column-parallel region: every rank's partial ``dx``);
  * :func:`reduce_from` all-reduce forward, identity backward (the exit of a
    row-parallel region, and ``psum`` of a value held once);
  * :func:`gather` all-gather along a dim where every rank goes on with
    the whole alike: backward keeps this rank's piece of the gradient;
  * :func:`gather_split` all-gather where each rank goes on with its own
    part of the whole (its heads, its query rows): backward sums every
    rank's gradient of this rank's piece (reduce-scatter);
  * :func:`ppermute` send to ``(rank + 1)`` (mod the size where ``ring``),
    receive from the rank before; backward sends the gradient back.

An :class:`Axis` of size 1 makes every op the identity and starts no
collective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group, size and index."""

    group: Optional[dist.ProcessGroup]
    size: int = 1
    rank: int = 0

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        """The axis ``name`` of a ``DeviceMesh`` (size 1 where absent)."""
        if mesh is None or name not in (mesh.mesh_dim_names or ()):
            return cls(None)
        size = mesh.size(mesh.mesh_dim_names.index(name))
        if size == 1:
            return cls(None)
        return cls(mesh.get_group(name), size, mesh.get_local_rank(name))

    def global_rank(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)


def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=axis.group)
    return x


def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, split):
        ctx.axis, ctx.dim, ctx.n, ctx.split = axis, dim, x.shape[dim], split
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            g = _all_reduce(g, ctx.axis)
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _Gather.apply(x, axis, dim, False)


def gather_split(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _Gather.apply(x, axis, dim, True)


def shard(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's equal piece of ``x`` along ``dim`` (a plain slice)."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


def _exchange(x: torch.Tensor, axis: Axis, dst: Optional[int],
              src: Optional[int]) -> torch.Tensor:
    """Send ``x`` to ``dst`` and receive a tensor of its shape from ``src``
    (zeros where ``src`` is None); ranks are indices on ``axis``."""
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), axis.global_rank(dst),
                              group=axis.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, axis.global_rank(src),
                              group=axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, ring):
        s, n = axis.rank, axis.size
        nxt = (s + 1) % n if ring or s < n - 1 else None
        prv = (s - 1) % n if ring or s > 0 else None
        ctx.axis, ctx.nxt, ctx.prv = axis, nxt, prv
        return _exchange(x, axis, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis, ctx.prv, ctx.nxt), None, None


def ppermute(x: torch.Tensor, axis: Axis, ring: bool = False) -> torch.Tensor:
    """``jax.lax.ppermute`` with pairs ``(i, i + 1)``, or ``(i, (i + 1) %
    size)`` where ``ring``: rank 0 of a line receives zeros."""
    if axis.size == 1:
        return torch.zeros_like(x) if not ring else x
    return _PPermute.apply(x, axis, ring)
