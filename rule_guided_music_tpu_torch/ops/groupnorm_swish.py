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
``torch.autograd.Function`` whose backward replays the plain version's VJP,
as ``_fgs_bwd`` does. On a CPU tensor it computes
:func:`groupnorm_swish_reference`. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build

launches = 0

_lib = None
build_result = None

SLICE_BYTES = 64 * 1024     # one block's slice in shared memory
MAX_CLUSTER = 8             # the portable thread-block cluster size
_CHUNK = 8                  # slice lengths are multiples of 8 elements (16 B in bf16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def groupnorm_swish_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ``F.group_norm`` then ``F.silu``."""
    return F.silu(F.group_norm(x, num_groups, weight, bias, eps))


def slice_length(span: int, clusters: int) -> int:
    """Length of each of ``clusters`` slices of a span (the last one
    shorter): ceil(span / clusters), rounded up to a multiple of 8."""
    per = -(-span // clusters)
    return -(-per // _CHUNK) * _CHUNK


def plan_slices(span: int, itemsize: int) -> tuple:
    """(S, slice_len) for one (n, g) span of ``span`` elements: S, the
    cluster size, is the smallest power of two whose slices hold at most
    64 KB each; S > 8 raises ``ValueError``."""
    max_len = SLICE_BYTES // itemsize
    clusters = 1
    while slice_length(span, clusters) > max_len:
        clusters *= 2
        if clusters > MAX_CLUSTER:
            raise ValueError(
                f"groupnorm_swish: a group of {span} elements of {itemsize} "
                f"bytes exceeds the kernel's limit of {MAX_CLUSTER} x "
                f"{SLICE_BYTES // 1024} KB per (example, group)")
    return clusters, slice_length(span, clusters)


def _load():
    global _lib, build_result
    if _lib is None:
        lib, build_result = build.load_library("groupnorm_swish")
        fn = lib.rgm_groupnorm_swish_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(x, weight, bias, num_groups, eps):
    global launches
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    cpg = c // num_groups
    span = cpg * hw
    if span >= 2 ** 31:
        raise ValueError("groupnorm_swish: a group too large for int32 offsets")
    clusters, slice_len = plan_slices(span, x.element_size())
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


class _GroupNormSwish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _launch(x, weight, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, weight, bias)]
            out = groupnorm_swish_reference(*inputs, ctx.num_groups, ctx.eps)
            gx, gw, gb = torch.autograd.grad(out, inputs, grad)
        return gx, gw, gb, None, None


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
