"""Device mesh and sharding rules: DP / FSDP / TP over ``torch.distributed``.

Port of ``rule_guided_music_tpu/parallel/mesh.py``. The mesh is a
``DeviceMesh`` with the dims ``("data", "fsdp", "model")``, one rank a
device:

  * data  - batch rows (DDP): parameters replicated, gradients summed;
  * fsdp  - batch rows too, and every large parameter sharded on one dim
    (ZeRO-3): gathered for the forward, its gradient reduce-scattered;
  * model - tensor parallelism over the DiT's heads and MLP hidden units.

Parameters become ``DTensor``s placed by JAX's PartitionSpec rules
(:data:`DIT_TP_RULES`, written against Flax paths and layouts). Each rule
is carried to the torch parameter through ``convert.flax_path``, the
inverse of the renaming and transposition that carries JAX trees into the
port: ``P("fsdp", "model")`` on ``attn/qkv/kernel`` (in, out) is
``Shard(1)`` over fsdp and ``Shard(0)`` over model on ``attn.qkv.weight``
(out, in). A dim that does not divide by its axis falls back to
replication, as there. The model computes on plain views of the
parameters, gathered unit by unit (:func:`gather_per_unit`: each DiT
block in its own forward, the root the rest): a ``redistribute`` to the
compute placement (the fsdp all-gather; the model shard kept only where
the module computes tensor-parallel), with the gradient a partial sum
over the batch dims, so the backward all-reduces over data and
reduce-scatters over fsdp, and the gradient lands in the parameter's own
placement. A rank's rows of the batch are the ``batch_axis(mesh).rank``-th
of ``batch_axis(mesh).size`` pieces: ranks that share a (data, fsdp)
coordinate hold the same rows, as under GSPMD.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..convert import flax_path
from .comm import Axis, copy_to, gather, gather_split

AXES = ("data", "fsdp", "model")


def maybe_init_distributed(device="cuda", force: bool = False) -> bool:
    """Initialise the default process group where a launcher asks for one:
    ``RGM_MULTIHOST=1`` (as the JAX package) or torchrun's ``RANK`` and
    ``WORLD_SIZE``; with ``force``, a group of one where neither is set.
    NCCL on cuda, gloo on the CPU; the store is torchrun's ``env://``
    (127.0.0.1 by default) or a file, ``RGM_DIST_STORE`` or a new temporary
    one for a world of one. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    launched = ("RANK" in env and "WORLD_SIZE" in env) or \
        env.get("RGM_MULTIHOST", "0") not in ("", "0")
    if not (launched or force):
        return False
    rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if "MASTER_ADDR" in env:
        init = "env://"
    elif env.get("RGM_DIST_STORE"):
        init = f"file://{env['RGM_DIST_STORE']}"
    elif world == 1:
        init = f"file://{tempfile.mkdtemp(prefix='rgm_dist_')}/store"
    else:
        raise RuntimeError(f"{world} ranks need a store: launch with torchrun, "
                           f"or set RGM_DIST_STORE to a file every rank reads")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world, **kw)
    return True


def check_factors(n: int, dp: Optional[int], fsdp: int, tp: int) -> None:
    """Raise unless ``n`` ranks factor as dp x fsdp x tp (dp None: any)."""
    if n % (fsdp * tp) != 0 or (dp is not None and dp * fsdp * tp != n):
        raise ValueError(
            f"make_mesh: cannot factor {n} device(s) as "
            f"dp={dp if dp is not None else '?'} x fsdp={fsdp} x tp={tp}. "
            f"Pass factors that multiply to the number of ranks, or launch more "
            f"ranks first (e.g. torchrun --nproc-per-node N, with --device cpu "
            f"for N CPU ranks on gloo).")


def launched_world() -> int:
    """The world size: the group's, or what the launcher set (1 if none)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
              device="cuda", ranks: Optional[Iterable[int]] = None):
    """A ``("data", "fsdp", "model")`` DeviceMesh over ``ranks`` (default:
    every rank of the default group); ``dp=None`` takes what is left. Every
    rank of the group calls it; a rank outside ``ranks`` gets a mesh whose
    ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    check_factors(n, dp, fsdp, tp)
    dp = dp or n // (fsdp * tp)
    arr = torch.tensor(ranks).reshape(dp, fsdp, tp)
    mesh = DeviceMesh(torch.device(device).type, arr, mesh_dim_names=AXES)
    # the batch group: the ranks of this model coordinate, data-major
    batch_groups = [dist.new_group(arr[:, :, m].reshape(-1).tolist())
                    for m in range(tp)]
    all_group = dist.new_group(ranks) if n < world else None
    coord = mesh.get_coordinate()
    mesh.rgm_batch = None if coord is None else Axis(
        batch_groups[coord[2]], dp * fsdp, coord[0] * fsdp + coord[1])
    if mesh.rgm_batch is not None and mesh.rgm_batch.size == 1:
        mesh.rgm_batch = Axis(None)
    mesh.rgm_all = all_group
    return mesh


def mesh_shape(mesh) -> Dict[str, int]:
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def batch_axis(mesh) -> Axis:
    """The (data, fsdp) ranks of this rank's model coordinate, flattened
    data-major: this rank's rows are the ``rank``-th of ``size`` pieces."""
    return Axis(None) if mesh is None else mesh.rgm_batch


def rows(n: int, mesh) -> slice:
    """This rank's rows of a global batch of ``n``."""
    ax = batch_axis(mesh)
    if n % ax.size:
        raise ValueError(f"global batch {n} does not split over data*fsdp = {ax.size}")
    b = n // ax.size
    return slice(ax.rank * b, (ax.rank + 1) * b)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from every rank's rows (no gradient)."""
    ax = batch_axis(mesh)
    if ax.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over every rank of the mesh."""
    if mesh is None or mesh.size() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.rgm_all)
    return x


def shard_noise_fn(noise_fn, mesh, shape):
    """A chain's ``noise_fn`` that draws for the global batch and keeps this
    rank's rows, so a sharded chain sees the single-process chain's
    numbers. ``shape`` is the chain's global shape; a draw has its rank
    (x_T, a step's noise) or one leading dim more (the SCG chain's k
    candidates), and the batch dim after it."""
    ax = batch_axis(mesh)
    if ax.size == 1:
        return noise_fn
    batch, ndim = shape[0], len(shape)
    b = batch // ax.size

    def noise(kind, step, local):
        d = len(local) - ndim
        full = noise_fn(kind, step, tuple(local[:d]) + (batch,) + tuple(local[d + 1:]))
        return full.narrow(d, ax.rank * b, b)

    return noise


# ---------------------------------------------------------------------------
# Parameter sharding rules (Flax path regex -> PartitionSpec, as in JAX)
# ---------------------------------------------------------------------------

DIT_TP_RULES = [
    (r"attn/qkv/kernel$", ("fsdp", "model")),
    (r"attn/proj/kernel$", ("model", "fsdp")),
    (r"mlp/fc1/kernel$", ("fsdp", "model")),
    (r"mlp/fc2/kernel$", ("model", "fsdp")),
    (r"adaLN_modulation/kernel$", ("fsdp", "model")),
    (r"adaLN_modulation/bias$", ("model",)),
    (r"attn/qkv/bias$", ("model",)),
    (r"mlp/fc1/bias$", ("model",)),
    # conv kernels (Flax (kh, kw, in, out)): the output channels
    (r"kernel$", (None, None, None, "fsdp")),
    # embedders / heads: fsdp only
    (r"kernel$", ("fsdp", None)),
    (r"embedding_table$", (None, "fsdp")),
]


def dit_param_spec(path: str, shape) -> tuple:
    """The PartitionSpec (a tuple of axis names) of a Flax ``path``: the
    first rule that matches and is no longer than the rank."""
    for pattern, spec in DIT_TP_RULES:
        if re.search(pattern, path) and len(spec) <= len(shape):
            return spec
    return ()


def kind_of(model: nn.Module) -> str:
    """The converter's name family of ``model``: "unet", "vae" or "dit"."""
    from ..models.unet import UNetModel
    from ..models.vae import AutoencoderKL

    if isinstance(model, UNetModel):
        return "unet"
    if isinstance(model, AutoencoderKL):
        return "vae"
    return "dit"


def param_specs(model: nn.Module, sizes: Dict[str, int],
                kind: Optional[str] = None) -> Dict[str, tuple]:
    """Each parameter's spec in the torch layout (one axis name or None a
    tensor dim): JAX's rule on the Flax path and shape, its divisibility
    fallback (``shard_params``), carried through the converter's
    permutation. Pure: ``model`` may live on the meta device."""
    kind = kind or kind_of(model)
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        owner = modules[name.rpartition(".")[0]]
        path, perm = flax_path(name, tuple(p.shape), kind,
                               isinstance(owner, nn.Embedding))
        flax_shape = [p.shape[perm.index(d)] for d in range(p.ndim)]
        spec = list(dit_param_spec(path, flax_shape))
        spec += [None] * (p.ndim - len(spec))
        for d, axis in enumerate(spec):
            if axis is not None and flax_shape[d] % sizes[axis]:
                spec[d] = None
        out[name] = tuple(spec[perm[j]] for j in range(p.ndim))
    return out


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a torch-layout spec on ``mesh``: ``Shard(d)``
    over an axis that shards dim d and has more than one rank."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, axis in enumerate(mesh.mesh_dim_names):
        dims = [d for d, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1 else Replicate())
    return tuple(out)


def shard_params(model: nn.Module, mesh, kind: Optional[str] = None) -> nn.Module:
    """Make every parameter of ``model`` a DTensor placed by
    :func:`param_specs` (in place; every rank holds the same full
    values before), and turn on tensor parallelism in the DiT modules
    whose parameters the model axis shards (:func:`enable_tensor_parallel`).
    Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(model, mesh_shape(mesh), kind)
    modules = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh, placements(specs[name], mesh))
        setattr(modules[owner_name], leaf, nn.Parameter(dt, p.requires_grad))
    enable_tensor_parallel(model, mesh, specs)
    gather_per_unit(model)
    return model


def enable_tensor_parallel(model: nn.Module, mesh, specs: Dict[str, tuple]) -> None:
    """Set ``tp`` (the model :class:`Axis`) on each DiT ``Attention`` (its
    heads divide), ``Mlp``, and adaLN of a ``DiTBlock`` or ``FinalLayer``
    whose column- and row-parallel parameters the model axis all shards,
    and record those parameters in ``model.rgm_tp_local``: their local
    views keep the model shard."""
    from ..models.layers import Attention, DiTBlock, FinalLayer, Mlp

    axis = Axis.of(mesh, "model")
    model.rgm_tp_local = set()
    if axis.size == 1:
        return
    for mname, module in model.named_modules():
        if isinstance(module, (DiTBlock, FinalLayer)):
            own = ["adaLN_modulation.1.weight", "adaLN_modulation.1.bias"]
        elif isinstance(module, Attention) and module.num_heads % axis.size == 0:
            own = ["qkv.weight", "qkv.bias", "proj.weight"]
        elif isinstance(module, Mlp):
            own = ["fc1.weight", "fc1.bias", "fc2.weight"]
        else:
            continue
        own = [f"{mname}.{n}" for n in own if f"{mname}.{n}" in specs]
        if own and all("model" in specs[n] for n in own):
            module.tp = axis
            model.rgm_tp_local.update(own)


def _gather_steps(p, keep_model: bool) -> tuple:
    """The differentiable collectives (:mod:`.comm`) that take this rank's
    shard of the DTensor ``p`` to its compute value: ``copy_to`` over data
    (and over fsdp where fsdp replicates ``p``), whose backward all-reduces
    the gradient; ``gather_split`` over fsdp where it shards ``p``, whose
    backward sums every rank's gradient of this rank's piece; ``gather``
    over model where the module does not compute tensor-parallel (every
    model rank computes the same gradient). Empty where every axis has one
    rank: the shard is the value."""
    mesh, steps = p.device_mesh, []
    for i, (axis, q) in enumerate(zip(mesh.mesh_dim_names, p.placements)):
        if mesh.size(i) == 1 or (axis == "model" and (keep_model or not q.is_shard())):
            continue
        ax = Axis.of(mesh, axis)
        if not q.is_shard():
            steps.insert(0, (copy_to, ax, None))
        else:
            steps.append((gather if axis == "model" else gather_split, ax, q.dim))
    return tuple(steps)


def leaf(p: torch.Tensor) -> torch.Tensor:
    """The plain tensor that stands for the DTensor parameter ``p`` in this
    rank's forward: a tensor on the storage of ``p``'s shard, with ``p``'s
    ``requires_grad``, made at the first call (the parameter's data is
    updated in place from then on: the optimizer, ``restore``). Autograd
    accumulates the gradient of ``p``'s shard in its ``.grad``; AdamW
    steps it (``make_optimizer``)."""
    t = getattr(p, "_rgm_leaf", None)
    if t is None:
        with torch.no_grad():
            t = p.to_local().detach().requires_grad_(p.requires_grad)
        p._rgm_leaf = t
    return t


def _unit_hooks(unit: nn.Module, entries, keep) -> None:
    """Run ``unit`` on the compute values of its own DTensor parameters
    (whatever DTensors stand there: the parameters, or the EMA that
    ``functional_call`` put in): a pre-hook puts them in place of the
    DTensors, the hook after the forward puts the DTensors back. A
    parameter that takes a gradient enters as its :func:`leaf`."""
    from torch.distributed.tensor import DTensor

    cache = {}

    def pre(module, args):
        held = [owner._parameters[leaf_name] for owner, leaf_name, _ in entries]
        if all(isinstance(t, DTensor) for t in held):
            layout = [t.placements for t in held]
            if cache.get("layout") != layout:
                cache["layout"] = layout
                cache["steps"] = [_gather_steps(t, name in keep)
                                  for t, (_, _, name) in zip(held, entries)]
            grad = torch.is_grad_enabled()
            for (owner, leaf_name, _), t, steps in zip(entries, held, cache["steps"]):
                if grad and t.requires_grad:
                    v = leaf(t)
                else:
                    with torch.no_grad():
                        v = t.to_local()
                for fn, ax, dim in steps:
                    v = fn(v, ax) if dim is None else fn(v, ax, dim)
                owner._parameters[leaf_name] = v
        else:
            held = None
        module._rgm_held.append(held)

    def post(module, args, output):
        held = module._rgm_held.pop() if module._rgm_held else None
        for (owner, leaf_name, _), t in zip(entries, held or ()):
            owner._parameters[leaf_name] = t

    unit._rgm_held = []
    unit.register_forward_pre_hook(pre)
    unit.register_forward_hook(post, always_call=True)


def gather_per_unit(model: nn.Module) -> None:
    """Make ``model`` compute on plain tensors from its DTensor parameters,
    gathered unit by unit: each block of ``model.blocks`` (a DiT's) in its
    own forward, the root the parameters that are in no block. Under
    ``torch.utils.checkpoint`` (``--remat``) a block's gathered weights
    live only through its forward and its recompute. With one rank on
    every axis a parameter's compute value is its :func:`leaf`, and the
    forward is the plain model's."""
    keep = getattr(model, "rgm_tp_local", set())
    units = [(f"blocks.{i}", b) for i, b in enumerate(getattr(model, "blocks", ()))]
    claimed = set()
    for prefix, unit in units + [("", model)]:
        entries = []
        for mname, module in unit.named_modules(prefix=prefix):
            for leaf_name, _ in module.named_parameters(recurse=False):
                name = f"{mname}.{leaf_name}" if mname else leaf_name
                if name not in claimed:
                    claimed.add(name)
                    entries.append((module, leaf_name, name))
        if entries:
            _unit_hooks(unit, entries, keep)


def grad_shard(p: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's shard of ``p``'s gradient (its :func:`leaf`'s), or
    ``p.grad`` for a plain parameter."""
    from torch.distributed.tensor import DTensor

    return leaf(p).grad if isinstance(p, DTensor) else p.grad


def clear_grad(p: torch.Tensor) -> None:
    from torch.distributed.tensor import DTensor

    p.grad = None
    if isinstance(p, DTensor):
        leaf(p).grad = None


def as_placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g``, this rank's shard of a tensor placed as the DTensor ``p``, as
    that DTensor (a wrapper on ``g``'s storage); ``g`` for a plain ``p``."""
    from torch.distributed.tensor import DTensor

    return DTensor(g, p._spec, requires_grad=False) if isinstance(p, DTensor) else g


def replicas(t) -> int:
    """How many ranks hold each element of a DTensor (1 for a tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return 1
    return int(np.prod([t.device_mesh.size(i) for i, q in enumerate(t.placements)
                        if isinstance(q, Replicate)] or [1]))


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor, or ``t`` itself; called under
    ``torch.no_grad`` it is the shard's own tensor, outside the graph."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def sum_squares(tensors) -> torch.Tensor:
    """(n,) float32 sums of squares of ``tensors``, each over its global
    DTensor (one all-reduce for all of them), or over the tensor."""
    from torch.distributed.tensor import DTensor

    tensors = list(tensors)
    sq = torch.stack(torch._foreach_norm([local(t).float() for t in tensors])).pow(2)
    dts = [t for t in tensors if isinstance(t, DTensor)]
    if not dts:
        return sq
    mesh = dts[0].device_mesh
    if mesh.size() == 1:
        return sq
    sq = sq / torch.tensor([float(replicas(t)) for t in tensors], device=sq.device)
    return all_reduce_sum(sq, mesh)


def full_tensor(t):
    """The whole value of a DTensor (a collective: every rank calls it), or
    ``t`` itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def sequence_parallel(model: nn.Module, axis: Axis) -> nn.Module:
    """Shard the DiTRotary's (B, N, D) tokens over ``axis`` (JAX's
    ``token_spec`` with a ``seq`` axis): each rank keeps N / size tokens
    through the blocks; attention gathers q, k and v over the axis before
    the kernel (one N for the three) and keeps this rank's query rows
    after it; the tokens are gathered before the final layer."""
    from ..models.layers import Attention

    model.seq = axis
    for module in model.modules():
        if isinstance(module, Attention):
            module.seq = axis
    return model

