"""Int8 dense layers for serving the DiT trunk (w8a8 and w8a16).

Port of ``rule_guided_music_tpu/ops/quant.py``. There it is XLA, not a
Pallas kernel: the int8 product is XLA's ``dot_general`` and XLA fuses the
dequantization around it. Here, on a CUDA tensor, both modes run
hand-written Hopper kernels (``csrc/quant_gemm.cu``, built by ``nvcc`` at
first use into a library of its own and bound with ``ctypes``; they launch
on PyTorch's current stream), which likewise keep the dequantization on the
accumulator. The GEMMs read their operands by TMA (tensor maps encoded in
the library; a weight's once), so every operand's rows must start on 16
bytes and lie contiguous, and K must be a multiple of 16; the wrappers
raise a ``ValueError`` that says which otherwise:

  * w8a16, :func:`wo_dense_apply` -> :func:`w8a16_gemm`: the int8 weight is
    read as it is stored and converted to bf16 in registers, the product is
    accumulated in fp32 on the tensor cores, ``* scale + bias`` is applied
    to the fp32 sums and the result rounded once to the compute dtype, as
    JAX's ``preferred_element_type=float32`` product is (fp32 inputs, the
    fp32 route: three bf16 products of each input's bf16 parts, split once
    a tile in the kernel);
  * w8a8, :func:`quant_dense_apply` -> :func:`w8a8_linear`, one host call
    that launches the per-token quantization (int8 with true divisions, as
    JAX divides; each row read once) and the s8 x s8 -> s32 GEMM (exact;
    ``acc * (s_x * scale) + bias`` in fp32, then one rounding): the plain
    version's result bit for bit. Where a gradient is wanted the two go
    through :func:`quantize_rows` and :func:`w8a8_gemm` apart.

On a CPU tensor each takes its plain version, JAX's formula in PyTorch
(:func:`wo_dense_reference`, :func:`quant_dense_reference`,
:func:`quantize_rows_reference`, :func:`w8a8_gemm_reference`); on any
other device it raises. Where a gradient is wanted (DPS differentiates the
denoiser with respect to x_t), a kernel's wrapper goes through an autograd
Function whose backward gives the activations the gradient that autograd
takes through the plain version: w8a16's through the product, w8a8's
through s_x alone (the rounded int8 activations have none, as in JAX).
``kernel_launches`` counts each kernel's launches by name (w8a16's fp32
route apart, as ``w8a16_gemm_fp32``; :func:`w8a8_linear` counts one
quantization and one GEMM);
:func:`bf16_disagreement` is the rule that holds a bf16 w8a16 result
against another.

Scheme, as in the JAX package:
  * weights: per-output-channel symmetric int8, scale = max|W[:, j]| / 127,
    folded offline by :func:`quantize_dense` (numpy, the same float
    operations, so the int8 values and scales equal JAX's bit for bit);
  * w8a8: per-token dynamic symmetric int8 activations (fp32 amax, round
    half to even, clip to +-127), int32 accumulation, dequantized by
    s_x * scale, bias added in fp32, then cast;
  * w8a16: the int8 weight in the compute dtype, the product accumulated
    in fp32, then * scale + bias in fp32, then cast.

Only the four token-level linears of each DiT block are quantized
(``DIT_BLOCK_QUANT_LEAVES``, in place by :func:`quantize_`); embedders, adaLN, norms and the final layer
stay in the compute dtype. :class:`QuantLinear` keeps its int8 weight and
its fp32 ``scale`` and ``bias`` through ``module.to(dtype)``, as the JAX
tree keeps them whatever the compute dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn as nn

from . import build

# token-level linears of a DiT block (JAX ``DIT_BLOCK_QUANT_LEAVES``)
DIT_BLOCK_QUANT_LEAVES = (("attn", "qkv"), ("attn", "proj"),
                          ("mlp", "fc1"), ("mlp", "fc2"))
QUANT_MODES = ("w8a8", "w8a16")

kernel_launches = {"w8a16_gemm": 0, "w8a16_gemm_fp32": 0, "quantize_rows": 0,
                   "w8a8_gemm": 0}
_W8A16_NAME = {torch.bfloat16: "w8a16_gemm", torch.float32: "w8a16_gemm_fp32"}
_GEMM_CODE = {"w8a16": 0, "w8a8": 1, "w8a16_fp32": 2}
_lib = None
build_result = None
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_EXPORTS = {
    "rgm_w8a16_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "rgm_quantize_rows": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "rgm_w8a8_gemm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "rgm_w8a8_linear": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "rgm_quant_gemm_force_route": [ctypes.c_int] * 2,
    "rgm_quant_gemm_route": [ctypes.c_int] * 4,
    "rgm_quantize_rows_route": [ctypes.c_int] * 3,
}


def normalize_quant_mode(v) -> str:
    """CLI/config value -> '' (off) | 'w8a8' | 'w8a16'.

    Accepts bools (True -> 'w8a8') and strings in any case, so
    ``--quant True`` and ``--quant w8a16`` both work.
    """
    if v is None or v is False:
        return ""
    if v is True:
        return "w8a8"
    s = str(v).strip().lower()
    if s in ("", "0", "false", "none", "off"):
        return ""
    if s in ("1", "true", "w8a8"):
        return "w8a8"
    if s in ("w8a16", "weight_only", "wo"):
        return "w8a16"
    raise ValueError(f"unknown quant mode {v!r} (use w8a8 or w8a16)")


def quantize_dense(kernel: np.ndarray):
    """Per-output-channel symmetric int8 quantization of a dense kernel.

    kernel: (d_in, d_out) float, the JAX layout. Returns (kernel_i8 int8
    (d_in, d_out), scale float32 (d_out,)).
    """
    kernel = np.asarray(kernel, dtype=np.float32)
    amax = np.max(np.abs(kernel), axis=0)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.rint(kernel / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def int_mm(x_i8: torch.Tensor, weight_i8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times the transpose of an (N, K) int8 weight -> (M, N)
    int32, exact on any device: a float64 product, whose sums of integers
    are exact while |sum| <= 127^2 K < 2^53."""
    return (x_i8.double() @ weight_i8.double().t()).to(torch.int32)


def quantize_rows_reference(x: torch.Tensor) -> tuple:
    """Plain version of :func:`quantize_rows`: (x_i8 int8 of x's shape,
    s_x fp32 of x's shape with 1 for the last axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, and JAX divides
    s_x = amax.clamp_min(1e-8) / amax.new_tensor(127.0)
    return torch.round(xf / s_x).clamp(-127, 127).to(torch.int8), s_x


def w8a8_gemm_reference(x_i8: torch.Tensor, s_x: torch.Tensor,
                        weight_i8: torch.Tensor, scale: torch.Tensor, bias=None,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`w8a8_gemm`, JAX's formula: x_i8 (..., K)
    int8 and s_x (..., 1) fp32 as :func:`quantize_rows_reference` gives
    them; acc * (s_x * scale) + bias in fp32, one rounding to ``dtype``."""
    acc = int_mm(x_i8.reshape(-1, x_i8.shape[-1]), weight_i8)
    y = acc.reshape(*x_i8.shape[:-1], -1).float() * (s_x * scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def quant_dense_reference(x: torch.Tensor, weight_i8: torch.Tensor,
                          scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """Plain version of :func:`quant_dense_apply`, JAX's formula."""
    x_i8, s_x = quantize_rows_reference(x)
    return w8a8_gemm_reference(x_i8, s_x, weight_i8, scale, bias, dtype or x.dtype)


def wo_dense_reference(x: torch.Tensor, weight_i8: torch.Tensor,
                       scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """Plain version of :func:`wo_dense_apply`, JAX's formula: x rounded to
    ``dtype``, its product with the int8 weight taken in fp32 (no TF32 on
    the card: callers there turn it off), ``* scale + bias`` in fp32, one
    rounding to ``dtype``."""
    dtype = dtype or x.dtype
    y = torch.matmul(x.to(dtype).float(), weight_i8.float().t()) * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def bf16_disagreement(got, want, x, weight_i8, scale) -> tuple:
    """How far two bf16 w8a16 results of the same inputs are apart:
    (share of outputs that differ, number that differ by more than one
    bf16 ulp of the larger of the two and by more than what the order of
    K fp32 additions can move a cancelling sum, K 2^-24 sum |x w| s).
    Two results that each round the fp32 sums once differ in a few
    outputs in 10^4; rounding the sums to bf16 before the rescale makes it
    about a quarter."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs())
                                            + 1e-30)) - 7)
    order = (x.shape[-1] * 2.0 ** -24
             * (x.float().abs() @ weight_i8.float().abs().t()) * scale)
    beyond = (got - want).abs() > torch.maximum(ulp, order)
    return (got != want).float().mean().item(), int(beyond.sum().item())


def _load():
    """Build (if needed) and load ``csrc/quant_gemm.cu``."""
    global _lib, build_result
    if _lib is None:
        lib, build_result = build.load_library("quant_gemm")
        for name, argtypes in _EXPORTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x as a contiguous (M, k) tensor whose rows start on 16 bytes."""
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return x2


def _check_tma(name: str, t: torch.Tensor) -> None:
    """Raises where TMA cannot read ``t``'s rows as a tensor map: they must
    lie contiguous and start on 16 bytes (K a multiple of 16 makes every
    row's stride one)."""
    if not t.is_contiguous():
        raise ValueError(f"the int8 kernels read {name} by TMA or 16-byte loads and take "
                         f"it contiguous: got shape {tuple(t.shape)} with strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"the int8 kernels read {name} by TMA or 16-byte loads, which "
                         f"need its base on 16 bytes: it starts {t.data_ptr() % 16} "
                         f"bytes past one")


def _check_rows(x2, dtypes) -> tuple:
    """(M, K) of a kernel's input; raises on what the kernels do not take."""
    if x2.dim() != 2 or x2.dtype not in dtypes:
        raise TypeError(f"a 2-D {' or '.join(map(str, dtypes))} input, got "
                        f"{tuple(x2.shape)} {x2.dtype}")
    if x2.shape[1] % 16:
        raise ValueError(f"K = {x2.shape[1]}: the int8 kernels take K a multiple of 16 "
                         f"(TMA reads rows of a multiple of 16 bytes)")
    _check_tma("the input", x2)
    return tuple(x2.shape)


def _check_weight(x2, weight_i8, scale, bias) -> int:
    """N of a GEMM call; raises on what the kernels do not take."""
    k = x2.shape[1]
    if weight_i8.dtype != torch.int8 or weight_i8.dim() != 2 or weight_i8.shape[1] != k:
        raise ValueError(f"an int8 (N, {k}) weight, got {tuple(weight_i8.shape)} "
                         f"{weight_i8.dtype}")
    n = weight_i8.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (n,)):
            raise ValueError(f"{name} must be fp32 ({n},), got {tuple(t.shape)} {t.dtype}")
    for t in (weight_i8, scale, bias):
        if t is not None and t.device != x2.device:
            raise ValueError("the weight, scale and bias must lie on the input's device")
    for t in (scale, bias):
        if t is not None and not t.is_contiguous():
            raise ValueError("the int8 kernels take a contiguous scale and bias")
    _check_tma("the weight", weight_i8)
    return n


def _call(name: str, device, *args) -> None:
    """``name``'s launch on ``device``'s current stream; the current device
    is switched only where it is another (the switch costs host time on
    every call of the B=2 trunk)."""
    fn = getattr(_load(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def gemm_route(m: int, n: int, k: int, mode: str) -> tuple:
    """(BN, split) that an (m, k) x (n, k)^T call of ``mode`` ("w8a16" in
    bf16, "w8a8" or "w8a16_fp32") takes on the current device: BN tokens a
    block of 128 output features, and the blocks of the cluster its k-tiles
    are split across (``pick_route`` in csrc/quant_gemm.cu)."""
    code = _load().rgm_quant_gemm_route(m, n, k, _GEMM_CODE[mode])
    return code // 100, code % 100


def quantize_route(m: int, k: int, dtype=torch.bfloat16) -> tuple:
    """(threads a row, rows a block, pieces of 8 elements a thread holds)
    that the quantization of an (m, k) input of ``dtype`` takes on the
    current device; 0 pieces: the route that reads each row twice
    (``quant_route`` in csrc/quant_gemm.cu)."""
    code = _load().rgm_quantize_rows_route(m, k, _DTYPE_CODE[dtype])
    return code // 10000, code // 100 % 100, code % 100


class force_route:
    """``with force_route(bn, split):`` every int8 GEMM takes that route
    (0: by shape) until the block ends; for the tests and the A/B tool that
    hold the routes against each other. Not thread-safe."""

    def __init__(self, bn: int = 0, split: int = 0):
        self.route = (bn, split)

    def __enter__(self):
        err = _load().rgm_quant_gemm_force_route(*self.route)
        if err != 0:
            raise ValueError(f"no int8 GEMM route {self.route}: BN 0, 128 or 256, "
                             f"split 0-4")
        return self

    def __exit__(self, *exc):
        _load().rgm_quant_gemm_force_route(0, 0)
        return False


def _w8a16_launch(x2, weight_i8, scale, bias) -> torch.Tensor:
    m, k = _check_rows(x2, (torch.bfloat16, torch.float32))
    n = _check_weight(x2, weight_i8, scale, bias)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m:
        _call("rgm_w8a16_gemm", x2.device, x2.data_ptr(), weight_i8.data_ptr(),
              scale.data_ptr(), _ptr(bias), out.data_ptr(), m, n, k,
              _DTYPE_CODE[x2.dtype])
        kernel_launches[_W8A16_NAME[x2.dtype]] += 1
    return out


def _quantize_rows_launch(x2) -> tuple:
    m, k = _check_rows(x2, (torch.bfloat16, torch.float32))
    q = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    s_x = torch.empty((m,), dtype=torch.float32, device=x2.device)
    if m:
        _call("rgm_quantize_rows", x2.device, x2.data_ptr(), q.data_ptr(),
              s_x.data_ptr(), m, k, _DTYPE_CODE[x2.dtype])
        kernel_launches["quantize_rows"] += 1
    return q, s_x


def _check_out_dtype(dtype) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"w8a8_gemm writes bf16 or fp32, not {dtype}")


def _w8a8_launch(q, s_x, weight_i8, scale, bias, dtype) -> torch.Tensor:
    m, k = _check_rows(q, (torch.int8,))
    n = _check_weight(q, weight_i8, scale, bias)
    if (s_x.dtype != torch.float32 or tuple(s_x.shape) != (m,)
            or s_x.device != q.device or not s_x.is_contiguous()):
        raise ValueError(f"s_x must be a contiguous fp32 ({m},) on {q.device}")
    _check_out_dtype(dtype)
    out = torch.empty((m, n), dtype=dtype, device=q.device)
    if m:
        _call("rgm_w8a8_gemm", q.device, q.data_ptr(), weight_i8.data_ptr(),
              s_x.data_ptr(), scale.data_ptr(), _ptr(bias),
              out.data_ptr(), m, n, k, _DTYPE_CODE[dtype])
        kernel_launches["w8a8_gemm"] += 1
    return out


def _w8a8_linear_launch(x2, weight_i8, scale, bias, dtype) -> torch.Tensor:
    m, k = _check_rows(x2, (torch.bfloat16, torch.float32))
    n = _check_weight(x2, weight_i8, scale, bias)
    _check_out_dtype(dtype)
    # x_i8 (m, k), then s_x (m,) at a multiple of 16 bytes (k is one)
    work = torch.empty(m * k + 4 * m, dtype=torch.uint8, device=x2.device)
    out = torch.empty((m, n), dtype=dtype, device=x2.device)
    if m:
        _call("rgm_w8a8_linear", x2.device, x2.data_ptr(), weight_i8.data_ptr(),
              scale.data_ptr(), _ptr(bias), work.data_ptr(), work.data_ptr() + m * k,
              out.data_ptr(), m, n, k, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[dtype])
        kernel_launches["quantize_rows"] += 1
        kernel_launches["w8a8_gemm"] += 1
    return out


# The gradients with respect to the activations, as autograd takes them
# through the plain versions (and JAX through its formulas): DPS
# differentiates the denoiser with respect to x_t. The weight, scale and
# bias are buffers and get none.

def w8a16_grad(dy, weight_i8, scale) -> torch.Tensor:
    """d x of (x . W^T) * scale + bias: (dy * scale) . W in fp32."""
    return torch.matmul(dy.float() * scale, weight_i8.float())


def w8a8_grad_s_x(dy, acc_f, scale) -> torch.Tensor:
    """d s_x (M,) of acc_f * (s_x * scale) + bias, acc_f the (M, N) int32
    sums in fp32 (the rounded int8 activations get none)."""
    return ((dy.float() * acc_f) * scale).sum(-1)


def quantize_rows_grad(x2, ds_x) -> torch.Tensor:
    """d x (M, K) of s_x = max(max_k |x|, 1e-8) / 127: shared evenly by the
    entries where |x| is the row's largest, with their sign, and none
    where the 1e-8 floor holds."""
    xf = x2.float()
    a = xf.abs()
    amax = a.amax(-1, keepdim=True)
    g = (ds_x[:, None] / amax.new_tensor(127.0)) * (amax >= 1e-8)
    hit = (a == amax).to(g.dtype)
    return ((g / hit.sum(-1, keepdim=True)) * hit * xf.sgn()).to(x2.dtype)


class _W8A16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight_i8, scale, bias):
        ctx.save_for_backward(weight_i8, scale)
        return _w8a16_launch(x2, weight_i8, scale, bias)

    @staticmethod
    def backward(ctx, dy):
        weight_i8, scale = ctx.saved_tensors
        return w8a16_grad(dy, weight_i8, scale).to(dy.dtype), None, None, None


class _QuantizeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2):
        q, s_x = _quantize_rows_launch(x2)
        ctx.mark_non_differentiable(q)
        ctx.save_for_backward(x2)
        return q, s_x

    @staticmethod
    def backward(ctx, dq, ds_x):
        return quantize_rows_grad(ctx.saved_tensors[0], ds_x)


class _W8A8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, s_x, weight_i8, scale, bias, dtype):
        ctx.save_for_backward(q, weight_i8, scale)
        return _w8a8_launch(q, s_x, weight_i8, scale, bias, dtype)

    @staticmethod
    def backward(ctx, dy):
        q, weight_i8, scale = ctx.saved_tensors
        # the kernel with unit scales gives the int32 sums in fp32
        ones = lambda n: torch.ones(n, dtype=torch.float32, device=q.device)
        acc_f = _w8a8_launch(q, ones(q.shape[0]), weight_i8, ones(weight_i8.shape[0]),
                             None, torch.float32)
        return None, w8a8_grad_s_x(dy, acc_f, scale), None, None, None, None


def _wants_grad(t: torch.Tensor) -> bool:
    """The autograd Function only where a gradient is wanted: the serving
    path keeps one launch and no autograd bookkeeping."""
    return torch.is_grad_enabled() and t.requires_grad


def w8a16_gemm(x2: torch.Tensor, weight_i8: torch.Tensor, scale: torch.Tensor,
               bias=None) -> torch.Tensor:
    """The w8a16 kernel: (x2 (M, K) . weight_i8 (N, K)^T) * scale + bias,
    (M, N) in x2's dtype (bf16 or fp32), on a CUDA tensor; differentiable
    in x2."""
    if _wants_grad(x2):
        return _W8A16.apply(x2, weight_i8, scale, bias)
    return _w8a16_launch(x2, weight_i8, scale, bias)


def quantize_rows(x2: torch.Tensor) -> tuple:
    """The per-token quantization kernel: (x_i8 (M, K) int8, s_x (M,)
    fp32) of a bf16 or fp32 (M, K) CUDA tensor; s_x differentiable in x2."""
    if _wants_grad(x2):
        return _QuantizeRows.apply(x2)
    return _quantize_rows_launch(x2)


def w8a8_linear(x2: torch.Tensor, weight_i8: torch.Tensor, scale: torch.Tensor,
                bias=None, dtype=torch.bfloat16) -> torch.Tensor:
    """The whole w8a8 linear on a CUDA tensor: x2 (M, K) bf16 or fp32
    quantized per token, then float(x_i8 . weight_i8^T) * (s_x * scale) +
    bias, (M, N) in ``dtype``. Both kernels from one host call (the
    quantization into a workspace), each counted in ``kernel_launches``;
    where a gradient is wanted, :func:`quantize_rows` then
    :func:`w8a8_gemm`, differentiable in x2."""
    if _wants_grad(x2):
        q, s_x = quantize_rows(x2)
        return w8a8_gemm(q, s_x, weight_i8, scale, bias, dtype)
    return _w8a8_linear_launch(x2, weight_i8, scale, bias, dtype)


def w8a8_gemm(q: torch.Tensor, s_x: torch.Tensor, weight_i8: torch.Tensor,
              scale: torch.Tensor, bias=None, dtype=torch.bfloat16) -> torch.Tensor:
    """The w8a8 kernel: float(q (M, K) . weight_i8 (N, K)^T) * (s_x (M,) *
    scale) + bias, (M, N) in ``dtype`` (bf16 or fp32), on CUDA tensors;
    differentiable in s_x."""
    if _wants_grad(s_x):
        return _W8A8.apply(q, s_x, weight_i8, scale, bias, dtype)
    return _w8a8_launch(q, s_x, weight_i8, scale, bias, dtype)


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 kernels for device {x.device}")
    return x.device.type == "cuda"


def quant_dense_apply(x: torch.Tensor, weight_i8: torch.Tensor,
                      scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """w8a8: dequant(int8(x) @ W_i8^T) + bias with per-token scales.

    x: (..., d_in); weight_i8: (d_out, d_in) int8; scale: (d_out,) fp32.
    The result is in ``dtype`` (x's dtype when None). On a CUDA tensor the
    quantization and the GEMM kernels (one host call, :func:`w8a8_linear`,
    where no gradient is wanted); on a CPU one the plain version.
    """
    if not _on_card(x):
        return quant_dense_reference(x, weight_i8, scale, bias, dtype)
    y = w8a8_linear(_rows(x, x.shape[-1]), weight_i8, scale, bias, dtype or x.dtype)
    return y.reshape(*x.shape[:-1], weight_i8.shape[0])


def wo_dense_apply(x: torch.Tensor, weight_i8: torch.Tensor,
                   scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """w8a16: (x @ W^T) * scale + bias with W the int8 weight in ``dtype``
    (x's dtype when None), the product accumulated in fp32 and rescaled in
    fp32 before one rounding to ``dtype``, as JAX's. On a CUDA tensor the
    w8a16 kernel, which reads the int8 weight as it is stored (no weight
    in ``dtype`` is written); on a CPU one the plain version.
    """
    if not _on_card(x):
        return wo_dense_reference(x, weight_i8, scale, bias, dtype)
    x2 = _rows(x.to(dtype or x.dtype), x.shape[-1])
    y = w8a16_gemm(x2, weight_i8, scale, bias)
    return y.reshape(*x.shape[:-1], weight_i8.shape[0])


class QuantLinear(nn.Module):
    """Drop-in linear with an int8 weight (``mode`` "w8a8" or "w8a16").

    Buffers: ``weight`` int8 (out, in), as a torch ``Linear`` keeps it;
    ``scale`` and ``bias`` float32 (out,). Made from a trained fp32 linear
    by :meth:`from_linear`; the zeros here only define shapes.
    ``module.to(dtype)`` moves the buffers but keeps their dtypes, as the
    JAX tree keeps the scale and bias in fp32; the output is in the
    input's dtype.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mode: str = "w8a8"):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode = mode
        self.register_buffer("weight", torch.zeros(out_features, in_features,
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear, mode: str) -> "QuantLinear":
        """``lin``'s weight folded to int8 by :func:`quantize_dense`, its
        bias kept in fp32, on ``lin``'s device. ``lin`` must be fp32: a
        bf16-rounded weight gives other int8 values than JAX's."""
        if lin.weight.dtype != torch.float32:
            raise ValueError(f"quantize an fp32 linear, not {lin.weight.dtype}")
        # quantize_dense takes the JAX (in, out) layout
        q, s = quantize_dense(lin.weight.detach().cpu().numpy().T)
        out = cls(lin.in_features, lin.out_features, lin.bias is not None, mode)
        out.weight = torch.from_numpy(np.ascontiguousarray(q.T))
        out.scale = torch.from_numpy(s)
        if lin.bias is not None:
            out.bias = lin.bias.detach().cpu().clone()
        return out.to(lin.weight.device)

    def _apply(self, fn, recurse=True):
        # ``fn`` decides the device only: applied to an empty slice it says
        # where ``fn`` would move a buffer, without rounding its values
        kept = {n: self._buffers.pop(n) for n in ("scale", "bias")}
        try:
            super()._apply(fn, recurse)
        finally:
            for n, t in kept.items():
                self._buffers[n] = None if t is None else t.to(fn(t[:0]).device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        apply = quant_dense_apply if self.mode == "w8a8" else wo_dense_apply
        return apply(x, self.weight, self.scale, self.bias)


def quantize_(model: nn.Module, mode: str) -> nn.Module:
    """Make ``model``'s trunk int8 in place and return it: in every block
    of ``model.blocks`` the four token-level linears (``attn.qkv``,
    ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``) become :class:`QuantLinear`
    in ``mode``; every other module is left as it is (JAX
    ``quantize_dit_params``). Call it on the fp32 model, before any cast
    to bf16: JAX quantizes its host's fp32 tree."""
    for block in model.blocks:
        for parent, leaf in DIT_BLOCK_QUANT_LEAVES:
            owner = getattr(block, parent)
            setattr(owner, leaf, QuantLinear.from_linear(getattr(owner, leaf), mode))
    return model
