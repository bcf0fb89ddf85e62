"""Fused GroupNorm + affine + swish: a Triton kernel and its plain version.

Replaces the Pallas TPU kernel ``rule_guided_music_tpu/ops/pallas_groupnorm.py
::groupnorm_swish`` (body ``_gn_swish_kernel``; ``custom_vjp`` wrapper
``fused_groupnorm_swish``), which serves every ResnetBlock ``norm1``/``norm2``
and the ``norm_out`` of the KL-VAE decoder.

What bounds it on the H100: no matrix product, a few operations per element,
so device memory. At the least it reads x once and writes y once; this
kernel reads x twice (statistics pass, then the normalise pass), and the
second read is meant to come from the 50 MB L2 cache.

Design: NCHW keeps one (example, group) as one contiguous span of
(C/G)*H*W elements (up to 131,072 at 256x128x128 with G = 32), so one
program handles one (n, g):
  * pass 1 sums x and x*x in fp32 over the span, block by block, with one
    running sum per lane and a tree sum at the end, and takes the variance
    in the one-pass form E[x^2] - mean^2 of the Pallas kernel (clamped at 0);
  * pass 2 writes y = x*(inv*scale[c]) + (bias[c] - mean*inv*scale[c]),
    then y*sigmoid(y), in the input dtype.
There is no size limit and no fallback: the Pallas kernel's VMEM fallback
has no counterpart here.

On a CUDA tensor :func:`groupnorm_swish` launches the kernel (inside a
``torch.autograd.Function`` whose backward replays the plain version's VJP,
as ``_fgs_bwd`` does) or raises; on a CPU tensor it computes
:func:`groupnorm_swish_reference`. ``launches`` counts kernel launches.
Triton is imported only when the kernel is first built. (No
``from __future__ import annotations`` here: Triton must see the evaluated
``tl.constexpr`` annotation.)
"""

import torch
import torch.nn.functional as F

from . import build

launches = 0

tl = None          # triton.language, bound when the kernel is first built
_kernel = None


def groupnorm_swish_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ``F.group_norm`` then ``F.silu``."""
    return F.silu(F.group_norm(x, num_groups, weight, bias, eps))


def _build_kernel():
    global _kernel, tl
    if _kernel is not None:
        return _kernel
    build.set_triton_cache_dir()
    import triton
    import triton.language as triton_language

    tl = triton_language

    @triton.jit
    def gn_swish_kernel(x_ptr, w_ptr, b_ptr, y_ptr, span, hw, cpg, groups,
                        eps, BLOCK: tl.constexpr):
        pid = tl.program_id(0)                    # n * groups + g
        g = pid % groups
        base = pid.to(tl.int64) * span
        lanes = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, span, BLOCK):
            offs = start + lanes
            mask = offs < span
            x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
            acc += x
            acc2 += x * x
        mean = tl.sum(acc, axis=0) / span
        var = tl.maximum(tl.sum(acc2, axis=0) / span - mean * mean, 0.0)
        inv = 1.0 / tl.sqrt(var + eps)
        for start in range(0, span, BLOCK):
            offs = start + lanes
            mask = offs < span
            c = g * cpg + offs // hw
            w = tl.load(w_ptr + c, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + c, mask=mask, other=0.0).to(tl.float32)
            x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
            a = inv * w
            y = x * a + (b - mean * a)
            y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    _kernel = gn_swish_kernel
    return _kernel


def _block_for(span: int) -> tuple:
    block = 1 << max(span - 1, 1).bit_length()
    block = max(256, min(block, 4096))
    return block, (8 if block >= 2048 else 4)


def _launch(x, weight, bias, num_groups, eps):
    global launches
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    span = (c // num_groups) * hw
    if n * c * hw >= 2 ** 31 or span >= 2 ** 31:
        raise ValueError("groupnorm_swish: tensor too large for int32 offsets")
    y = torch.empty_like(x)
    kernel = _build_kernel()
    block, warps = _block_for(span)
    with torch.cuda.device(x.device):
        kernel[(n * num_groups,)](x, weight, bias, y, span, hw,
                                  c // num_groups, num_groups, float(eps),
                                  BLOCK=block, num_warps=warps)
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
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"groupnorm_swish takes a float tensor, got {x.dtype}")
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
    return _GroupNormSwish.apply(x, weight, bias, num_groups, eps)
