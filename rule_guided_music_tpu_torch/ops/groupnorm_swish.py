"""Fused GroupNorm + affine + swish: the hand-written CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel ``rule_guided_music_tpu/ops/pallas_groupnorm.py
::groupnorm_swish`` (body ``_gn_swish_kernel``; ``custom_vjp`` wrapper
``fused_groupnorm_swish``), which serves every ResnetBlock ``norm1``/``norm2``
and the ``norm_out`` of the KL-VAE decoder.

What bounds it on the H100: no matrix product, a few operations per element,
so device memory; at the least it reads x once and writes y once. The
kernel (``csrc/groupnorm_swish.cu``, built by ``nvcc`` for sm_90a at first
use and bound with ``ctypes``) reads x exactly once: NCHW keeps one
(example, group) as one contiguous span of (C/G)*H*W elements, which
:func:`plan_slices` cuts into S <= 8 slices of at most 64 KB; one
thread-block cluster of S blocks takes one span, each block holds its slice
in shared memory, and the blocks combine their (count, mean, M2) with
Chan's formula through distributed shared memory before each writes
y = swish(x * a + b) from its slice. A span that would need more than
8 x 64 KB raises; no caller of the port comes near it.

On a CUDA tensor :func:`groupnorm_swish` launches the kernel or raises;
where a gradient is wanted, the launch goes through a
``torch.autograd.Function`` whose backward launches the backward kernel of
the same source (``rgm_groupnorm_swish_bwd``, the VJP that ``_fgs_bwd``
takes; its plain version is :func:`groupnorm_swish_backward_reference`).
The backward reads x and dy and writes dx (three times the bytes of a
forward, a few dozen operations per element: device memory bounds it
too). It has a plan of its own, :func:`plan_bwd_slices`: slices of at
most 32 KB of x and as much of dy per block, so that three blocks (24
warps) share an SM and one block's copies and cluster barriers overlap
another's math; up to 16 slices per span (past 8, a non-portable
cluster). One pass over the shared slices takes the span sums of h = w g
and h xh and, where the weight and bias gradients are wanted, each warp's
sums of g and g xh per channel of its run of the slice, in a fixed order;
a second pass writes dx. A small second launch sums the (N, C) partial
over N in a fixed order, only where dw and dbias are wanted: the
gradients are the same from run to run. On a CPU tensor the wrapper
computes :func:`groupnorm_swish_reference`. The counters count Python
calls: ``launches`` forward calls, ``backward_launches`` backward calls
and ``param_grad_launches`` the calls that also reduce dw and dbias (the
second launch), whatever the CUDA launches inside.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build

launches = 0
backward_launches = 0
param_grad_launches = 0

_lib = None
build_result = None

SLICE_BYTES = 64 * 1024     # one block's slice in shared memory
MAX_CLUSTER = 8             # the portable thread-block cluster size
_CHUNK = 8                  # slice lengths are multiples of 8 elements (16 B in bf16)
CHANNEL_BYTES = 32 * 1024   # the backward's per-channel sums: 2 fp32 per channel
BWD_SLICE_BYTES = 32 * 1024  # the backward's slice of x, and of dy, per block
BWD_MAX_CLUSTER = 16        # the backward's cluster: non-portable past 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def groupnorm_swish_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ``F.group_norm`` then ``F.silu``."""
    return F.silu(F.group_norm(x, num_groups, weight, bias, eps))


def groupnorm_swish_backward_reference(x, weight, bias, dy, num_groups: int,
                                       eps: float = 1e-6) -> tuple:
    """Plain version of the backward kernel, in fp32, by its closed form:
    with xh the normalised x, z = w xh + b and
    g = dy sigmoid(z) (1 + z (1 - sigmoid(z))), dbias = sum g,
    dw = sum g xh (over N and the spatial axes), and, with h = w g,
    dx = inv (h - mean(h) - xh mean(h xh)), the means over each (n, group).
    Returns fp32 (dx, dw, dbias)."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xh = (xf - mean) * inv
    per_channel = (1, c) + (1,) * (x.dim() - 2)
    w = weight.float().reshape(per_channel)
    z = xh.reshape(x.shape) * w + bias.float().reshape(per_channel)
    sg = torch.sigmoid(z)
    g = dy.float() * sg * (1 + z * (1 - sg))
    axes = [0] + list(range(2, x.dim()))
    dbias = g.sum(axes)
    dw = (g * xh.reshape(x.shape)).sum(axes)
    h = (g * w).reshape(n, num_groups, -1)
    dx = inv * (h - h.mean(-1, keepdim=True)
                - xh * (h * xh).mean(-1, keepdim=True))
    return dx.reshape(x.shape), dw, dbias


def slice_length(span: int, clusters: int) -> int:
    """Length of each of ``clusters`` slices of a span (the last one
    shorter): ceil(span / clusters), rounded up to a multiple of 8."""
    per = -(-span // clusters)
    return -(-per // _CHUNK) * _CHUNK


def plan_slices(span: int, itemsize: int, slice_bytes: int = SLICE_BYTES,
                max_cluster: int = MAX_CLUSTER) -> tuple:
    """(S, slice_len) for one (n, g) span of ``span`` elements: S, the
    cluster size, is the smallest power of two whose slices hold at most
    ``slice_bytes`` each (the forward's 64 KB by default); S past
    ``max_cluster`` raises ``ValueError``."""
    max_len = slice_bytes // itemsize
    clusters = 1
    while slice_length(span, clusters) > max_len:
        clusters *= 2
        if clusters > max_cluster:
            raise ValueError(
                f"groupnorm_swish: a group of {span} elements of {itemsize} "
                f"bytes exceeds the kernel's limit of {max_cluster} x "
                f"{slice_bytes // 1024} KB per (example, group)")
    return clusters, slice_length(span, clusters)


def plan_bwd_slices(span: int, itemsize: int) -> tuple:
    """The backward's plan: slices of at most 32 KB of x (and as much of
    dy) per block, so that three blocks fit on an SM; S <= 16 (past 8 a
    non-portable cluster: fp32 spans of 256-512 KB)."""
    return plan_slices(span, itemsize, BWD_SLICE_BYTES, BWD_MAX_CLUSTER)


def _load():
    global _lib, build_result
    if _lib is None:
        lib, build_result = build.load_library("groupnorm_swish")
        fn = lib.rgm_groupnorm_swish_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.rgm_groupnorm_swish_bwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _plan(x, num_groups, planner=plan_slices):
    """(n, c, hw, cpg, span, S, slice_len) of one call."""
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    cpg = c // num_groups
    span = cpg * hw
    if span >= 2 ** 31:
        raise ValueError("groupnorm_swish: a group too large for int32 offsets")
    return (n, c, hw, cpg, span) + planner(span, x.element_size())


def _launch(x, weight, bias, num_groups, eps):
    global launches
    n, _, hw, cpg, span, clusters, slice_len = _plan(x, num_groups)
    y = torch.empty_like(x)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rgm_groupnorm_swish_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n * num_groups, num_groups, cpg, hw, span, clusters, slice_len,
            _DTYPE_CODE[x.dtype], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_swish kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _launch_bwd(x, weight, bias, dy, num_groups, eps, params):
    """The backward kernel: dx, and (dw, dbias) where ``params`` asks for
    them (else None, None); each in x's dtype."""
    global backward_launches, param_grad_launches
    n, c, hw, cpg, span, clusters, slice_len = _plan(x, num_groups,
                                                     plan_bwd_slices)
    if params and 2 * cpg * 4 > CHANNEL_BYTES:
        raise ValueError(f"groupnorm_swish backward: {cpg} channels per group "
                         f"exceed the kernel's {CHANNEL_BYTES // 8} for weight "
                         f"and bias gradients")
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    part = dw = db = None
    if params:
        part = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
        dw, db = torch.empty_like(weight), torch.empty_like(bias)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rgm_groupnorm_swish_bwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), ptr(part), ptr(dw), ptr(db), n * num_groups,
            num_groups, cpg, hw, span, clusters, slice_len,
            _DTYPE_CODE[x.dtype], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_swish backward kernel launch failed: "
                           f"CUDA error {err}")
    backward_launches += 1
    param_grad_launches += params
    return dx, dw, db


class _GroupNormSwish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _launch(x, weight, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        want = ctx.needs_input_grad
        dx, dw, db = _launch_bwd(x, weight, bias, grad, ctx.num_groups,
                                 ctx.eps, want[1] or want[2])
        return dx if want[0] else None, dw, db, None, None


def _check(x, weight, bias, num_groups):
    if x.dim() < 3:
        raise ValueError(f"groupnorm_swish takes (N, C, ...), got {tuple(x.shape)}")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("weight and bias must be (C,)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"groupnorm_swish takes float32 or bfloat16, got {x.dtype}")
    if not (x.device == weight.device == bias.device):
        raise ValueError("x, weight and bias must lie on one device")


def groupnorm_swish(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(num_groups, eps) + affine + swish over NCHW ``x``."""
    _check(x, weight, bias, num_groups)
    if x.device.type == "cpu":
        return groupnorm_swish_reference(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no groupnorm_swish for device {x.device}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("groupnorm_swish kernel needs contiguous NCHW input")
    if not (x.dtype == weight.dtype == bias.dtype):
        raise TypeError(f"groupnorm_swish kernel takes x, weight and bias of one "
                        f"dtype, got {x.dtype}, {weight.dtype}, {bias.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSwish.apply(x, weight, bias, num_groups, eps)
    return _launch(x, weight, bias, num_groups, eps)
