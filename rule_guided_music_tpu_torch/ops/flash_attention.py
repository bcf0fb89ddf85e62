"""Flash attention: the hand-written CUDA kernels and their plain version.

Replaces the Pallas TPU kernel ``rule_guided_music_tpu/ops/pallas_attention.py
::flash_attention`` (body ``_flash_kernel``): non-causal softmax attention on
(B, N, H, D) tensors, scale D^-0.5 on the true D, online softmax in fp32.
The kernels are in ``csrc/flash_attention.cu``, built by ``nvcc`` for sm_90a
at first use and bound with ``ctypes``; they launch on PyTorch's current
stream. The dtype alone chooses between them (the source's header says why):

* bfloat16: a FlashAttention-2-shaped kernel on the tensor cores (mma.sync
  m16n8k16, fp32 accumulation, 64-key K/V tiles double-buffered by
  cp.async, P kept in registers as bf16). What bounds it on the H100: at
  the DiT shapes (N=256, D=72) about 128 operations per byte, under the
  tensor cores' ridge, so device memory;
* float32: the SIMT kernel on the fp32 pipes, which keeps fp32 exact to
  1e-4 where the tensor cores would round to TF32.

On a CUDA tensor :func:`flash_attention` launches one of them or raises; on
a CPU tensor it computes :func:`flash_attention_reference`. Where a
gradient is wanted (classifier guidance differentiates the classifiers with
respect to x_t), the launch goes through ``_FlashAttention``, whose
backward replays the plain version's VJP in fp32: the Pallas kernel has no
backward either, so there is no backward kernel to port.
``kernel_launches`` counts the launches of each kernel by name.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

kernel_launches = {"flash_attention": 0, "flash_attention_fp32": 0}

_lib = None
build_result = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_NAME = {torch.bfloat16: "flash_attention",
               torch.float32: "flash_attention_fp32"}
MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: einsum logits, fp32 softmax, einsum; (B, N, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.float())
    return out.to(q.dtype)


def _load():
    global _lib, build_result
    if _lib is None:
        lib, build_result = build.load_library("flash_attention")
        fn = lib.rgm_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")


def _launch(q, k, v):
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rgm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            _DTYPE_CODE[q.dtype], float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    kernel_launches[KERNEL_NAME[q.dtype]] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward replays the VJP of
    :func:`flash_attention_reference` in fp32 on the saved inputs. The
    gradients take each input's shape (a strided view of qkv included) and
    dtype; autograd scatters them back into the tensor a view came from."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().float().requires_grad_() for t in saved]
            out = flash_attention_reference(*inputs)
            grads = torch.autograd.grad(out, inputs, grad.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, N, H, D); returns a contiguous (B, N, H, D)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _dispatch(q, k, v)


def _dispatch(q, k, v):
    """The autograd Function only where a gradient is wanted: the inference
    path keeps one launch and no autograd bookkeeping."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _launch(q, k, v)
