"""Flash attention: the hand-written CUDA kernels and their plain version.

Replaces the Pallas TPU kernel ``rule_guided_music_tpu/ops/pallas_attention.py
::flash_attention`` (body ``_flash_kernel``): non-causal softmax attention on
(B, N, H, D) tensors, scale D^-0.5 on the true D, online softmax in fp32.
The kernels are in three sources, each built by ``nvcc`` for sm_90a at first
use into a library of its own and bound with ``ctypes``; they launch on
PyTorch's current stream. The dtype and the direction alone choose the
library (each source's header says why):

* bfloat16 forward, ``csrc/flash_attention.cu``: a FlashAttention-2-shaped
  kernel on the tensor cores (mma.sync m16n8k16, fp32 accumulation, 64-key
  K/V tiles double-buffered by cp.async, P kept in registers as bf16). What
  bounds it on the H100: at the DiT shapes (N=256, D=72) about 128
  operations per byte, under the tensor cores' ridge, so device memory;
* bfloat16 backward, ``csrc/flash_attention_bwd.cu``: for N <= 512, by grid
  size, one thread-block cluster per (batch, head) does the five products
  once: each block keeps its keys' K and V (16 a warp; blocks of 4 warps
  for grids of at most half the SMs, of 8 past the SMs at head dims
  49-80), walks the query tiles for dK and dV, and stores each tile's dS
  into the shared memory of the block that owns those queries, which then
  sums their dQ over the cluster's dS in rank order. Between those grid
  sizes (DPS's B=2), for a ragged N or another head dim past the SMs, and
  past N = 512, a dQ kernel and a dK/dV kernel. ~120 operations per byte
  at the DiT shapes: memory sets the floor, mma.sync's issue rate and each
  block's serial start set the time;
* float32, forward and backward, ``csrc/flash_attention_fp32.cu``: the
  same shapes on the tensor cores with the 3xTF32 split (each operand as a
  TF32 big part and a TF32 small part, three products: a few fp32 ulps,
  within the 1e-4 agreement that fp32 callers, the card-versus-CPU checks,
  rely on, where one TF32 product would not be). The backward: Di, then a
  dK/dV kernel that also writes dS to a scratch buffer, then dQ = dS K.

On a CUDA tensor :func:`flash_attention` launches one of them or raises; on
a CPU tensor it computes :func:`flash_attention_reference`. Where a
gradient is wanted (classifier guidance, DPS, the EDM worker and
train_dit differentiate through attention), the launch goes through
``_FlashAttention``: its forward also records the row log-sum-exp, and its
backward launches the backward kernels of its dtype. Every route is a
function of the shape and the card, so a repeat gives the same bits; no
atomics: the gradient is the same from run to run.
The Pallas kernel has no backward (the JAX package differentiates the XLA
formulation); :func:`flash_attention_backward_reference` is the plain
version of the backward kernels. ``kernel_launches`` counts Python calls of
each kernel by name: one per forward call, and one per backward call
(``flash_attention_bwd``, ``flash_attention_bwd_fp32``) however many CUDA
launches it makes.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build

kernel_launches = {"flash_attention": 0, "flash_attention_fp32": 0,
                   "flash_attention_bwd": 0, "flash_attention_bwd_fp32": 0}

# kernel 1's libraries, one per source (csrc/<name>.cu), built in parallel
LIBRARIES = ("flash_attention", "flash_attention_bwd", "flash_attention_fp32")
_libs = {}
build_results = {}

_FWD = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12 + [
    ctypes.c_float, ctypes.c_void_p]
_BWD_TAIL = [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15 + [ctypes.c_float,
                                                             ctypes.c_void_p]
# each library's entry points and their argument types
_EXPORTS = {
    "flash_attention": {"rgm_flash_attention_fwd": _FWD},
    "flash_attention_bwd": {"rgm_flash_attention_bwd": [ctypes.c_void_p] * 10 + _BWD_TAIL,
                            "rgm_flash_attention_bwd_route": [ctypes.c_int]},
    "flash_attention_fp32": {"rgm_flash_attention_fp32_fwd": _FWD,
                             "rgm_flash_attention_fp32_bwd": [ctypes.c_void_p] * 11
                             + _BWD_TAIL},
}
# (library, entry point) of each direction by dtype
_FWD_FN = {torch.bfloat16: ("flash_attention", "rgm_flash_attention_fwd"),
           torch.float32: ("flash_attention_fp32", "rgm_flash_attention_fp32_fwd")}
_BWD_FN = {torch.bfloat16: ("flash_attention_bwd", "rgm_flash_attention_bwd"),
           torch.float32: ("flash_attention_fp32", "rgm_flash_attention_fp32_bwd")}

KERNEL_NAME = {torch.bfloat16: "flash_attention",
               torch.float32: "flash_attention_fp32"}
BWD_KERNEL_NAME = {torch.bfloat16: "flash_attention_bwd",
                   torch.float32: "flash_attention_bwd_fp32"}
MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: einsum logits, fp32 softmax, einsum; (B, N, H, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> tuple:
    """Plain version of the forward that records LSE: (out, lse), lse the
    fp32 (B, H, N) log-sum-exp of the scaled logits over the keys."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.float())
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, out, lse, dout) -> tuple:
    """Plain version of the backward kernels, in fp32, by their formulas:
    D = rowsum(dO o O); P = exp(S * scale - LSE); dV = P^T dO;
    dP = dO V^T; dS = P o (dP - D); dQ = dS K * scale; dK = dS^T Q * scale.
    Returns fp32 (dq, dk, dv) in (B, N, H, D)."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    scale = q.shape[-1] ** -0.5
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
                  - lse.float()[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq, dk, dv


def _load(name: str):
    """Build (if needed) and load one of :data:`LIBRARIES`."""
    if name not in _libs:
        lib, build_results[name] = build.load_library(name)
        for fn_name, argtypes in _EXPORTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def load_all() -> dict:
    """Build and load every library of :data:`LIBRARIES`, one ``nvcc`` each,
    all started together; returns {name: build.BuildResult}."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        list(pool.map(_load, LIBRARIES))
    return dict(build_results)


def _entry(table, dtype):
    lib, fn = table[dtype]
    return getattr(_load(lib), fn)


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_NAME:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D")


def _strides(*tensors):
    """The (B, N, H) strides of each (B, N, H, D) tensor, in order."""
    return [s for t in tensors for s in t.stride()[:3]]


def _launch(q, k, v, lse=None):
    """The forward kernel; ``lse``, an fp32 (B, H, N) tensor, receives the
    row log-sum-exp where given."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _entry(_FWD_FN, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, h, n, d,
                 *_strides(q, k, v, out), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    kernel_launches[KERNEL_NAME[q.dtype]] += 1
    return out


def _launch_bwd(q, k, v, out, lse, dout):
    """The backward kernels: fresh contiguous (dq, dk, dv) of q's dtype.
    fp32 also takes a scratch for dS^T, (B*H, N, N rounded up to 32)."""
    b, n, h, d = q.shape
    dout = dout.contiguous()
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    ds = None
    if q.dtype == torch.float32:
        ds = torch.empty((b * h, n, -(-n // 32) * 32), dtype=torch.float32,
                         device=q.device)
    scratch = [] if ds is None else [ds.data_ptr()]
    fn = _entry(_BWD_FN, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *scratch,
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, d,
                 *_strides(q, k, v, out, dout), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    kernel_launches[BWD_KERNEL_NAME[q.dtype]] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, recording LSE; the backward kernels on the saved
    q, k, v, output and LSE. The gradients are contiguous tensors of each
    input's shape and dtype; autograd scatters them back into the tensor a
    strided view of qkv came from."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, n, h, _ = q.shape
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _launch_bwd(*ctx.saved_tensors, grad)


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
