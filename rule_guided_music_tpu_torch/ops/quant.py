"""Int8 dense layers for serving the DiT trunk (w8a8 and w8a16).

Port of ``rule_guided_music_tpu/ops/quant.py``. There it is XLA, not a
Pallas kernel: the int8 product is XLA's ``dot_general`` with an int32
result, so here it is ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 on the
card), a plain matrix product, as the JAX package left it to XLA.

Scheme, as in the JAX package:
  * weights: per-output-channel symmetric int8, scale = max|W[:, j]| / 127,
    folded offline by :func:`quantize_dense` (numpy, the same float
    operations, so the int8 values and scales equal JAX's bit for bit);
  * w8a8: per-token dynamic symmetric int8 activations (fp32 amax, round
    half to even, clip to +-127), int32 accumulation, dequantized by
    s_x * scale, bias added in fp32, then cast;
  * w8a16: the int8 weight cast to the compute dtype, the product
    accumulated in fp32, then * scale + bias.

Only the four token-level linears of each DiT block are quantized
(``DIT_BLOCK_QUANT_LEAVES``, in place by :func:`quantize_`); embedders, adaLN, norms and the final layer
stay in the compute dtype. :class:`QuantLinear` keeps its int8 weight and
its fp32 ``scale`` and ``bias`` through ``module.to(dtype)``, as the JAX
tree keeps them whatever the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# token-level linears of a DiT block (JAX ``DIT_BLOCK_QUANT_LEAVES``)
DIT_BLOCK_QUANT_LEAVES = (("attn", "qkv"), ("attn", "proj"),
                          ("mlp", "fc1"), ("mlp", "fc2"))
QUANT_MODES = ("w8a8", "w8a16")
# ``torch._int_mm`` on the card takes more than 16 rows
_INT_MM_MIN_ROWS = 17


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
    int32, exact. On the card ``torch._int_mm`` needs more than 16 rows,
    so fewer rows (a 16-token DiT call at B=1) are padded with zero rows,
    which it drops from the result: each row is its own dot products, so
    the real rows are unchanged."""
    m = x_i8.shape[0]
    if m < _INT_MM_MIN_ROWS:
        x_i8 = F.pad(x_i8, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(x_i8, weight_i8.t())[:m]


def quant_dense_apply(x: torch.Tensor, weight_i8: torch.Tensor,
                      scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """w8a8: dequant(int8(x) @ W_i8^T) + bias with per-token scales.

    x: (..., d_in); weight_i8: (d_out, d_in) int8; scale: (d_out,) fp32.
    The result is in ``dtype`` (x's dtype when None).
    """
    dtype = dtype or x.dtype
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = amax.clamp_min(1e-8) / 127.0
    x_i8 = torch.round(xf / s_x).clamp(-127, 127).to(torch.int8)
    acc = int_mm(x_i8.reshape(-1, x.shape[-1]), weight_i8)
    y = acc.reshape(*x.shape[:-1], -1).float() * (s_x * scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def wo_dense_apply(x: torch.Tensor, weight_i8: torch.Tensor,
                   scale: torch.Tensor, bias=None, dtype=None) -> torch.Tensor:
    """w8a16: (x @ W^T) * scale + bias with W the int8 weight cast to
    ``dtype`` (x's dtype when None), the product accumulated in fp32.

    The JAX package folds the cast into the dot's operand read. Here the
    cast writes a weight in ``dtype`` on every call, and in bf16
    ``F.linear`` rounds the fp32 sums to bf16 before the rescale (JAX
    rescales them in fp32): one more rounding of half a bf16 ulp.
    """
    dtype = dtype or x.dtype
    y = F.linear(x.to(dtype), weight_i8.to(dtype)).float() * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


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
