"""Port backward kernels: their plain versions against the JAX package's VJPs.

The backward kernels of ``rule_guided_music_tpu_torch.ops`` (flash
attention's dQ/dK/dV, GroupNorm+swish's dx/dw/dbias) run only on the card
(tests/test_torch_gpu.py, marked ``gpu``). Here their plain versions,
``flash_attention_backward_reference`` and
``groupnorm_swish_backward_reference``, are held against ``jax.vjp`` of the
JAX package's attention and ``jax.grad`` through ``fused_groupnorm_swish``'s
custom VJP on the same numpy inputs, and the kernels' arithmetic is
emulated in plain torch (the bf16 rounding points of the attention
backward and its tile order: dK, dV over query tiles, dQ over key tiles
in rank order; the GroupNorm backward's S-slice split, its per-warp
channel sums and its per-(n, c) partials summed over N in runs) and held
within the card's tolerances of JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.ops.attention import sdpa as jax_sdpa
from rule_guided_music_tpu.ops.pallas_groupnorm import fused_groupnorm_swish
from rule_guided_music_tpu_torch.ops import flash_attention as fa
from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn

# fp32 on both sides, summation order only: 1e-5 of the largest gradient
ATTN_GRAD_TOL = 1e-5
# chip_smoke.py's GRAD_TOL for the bf16 kernels: max abs error over the
# largest gradient
BF16_GRAD_TOL = 1e-2
LOG2E = 1.4426950408889634


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_attention_vjp(q, k, v, dout):
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax_sdpa, *(jnp.asarray(a) for a in (q, k, v)))
        return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


ATTN_SHAPES = [(1, 257, 2, 72), (2, 64, 3, 64), (1, 40, 2, 16)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_backward_reference_matches_jax_vjp(shape):
    q, k, v, dout = _inputs(shape, seed=sum(shape))
    want = _jax_attention_vjp(q, k, v, dout)
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = fa.flash_attention_reference_lse(tq, tk, tv)
    got = fa.flash_attention_backward_reference(tq, tk, tv, out, lse, tdo)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == shape and g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) <= ATTN_GRAD_TOL, name


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_reference_lse_is_logsumexp_of_scaled_logits(shape):
    q, k, v = _inputs(shape, seed=7 + sum(shape), n=3)
    with jax.default_matmul_precision("highest"):
        logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q) * shape[-1] ** -0.5,
                            jnp.asarray(k))
        want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    out, lse = fa.flash_attention_reference_lse(*(torch.as_tensor(a)
                                                  for a in (q, k, v)))
    assert lse.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    ref = fa.flash_attention_reference(*(torch.as_tensor(a) for a in (q, k, v)))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


def _bf16_forward_emulation(q, k, v, tile=64):
    """The tensor-core forward's arithmetic on bf16 (B, N, H, D) inputs
    (tests/test_torch_kernels.py's emulation), also returning the LSE it
    records: (m + log2 l) * ln 2, m the running max in log2 units."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    b, h, n, d = qf.shape
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full((b, h, n, 1), -float("inf"))
    l = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, d))
    for k0 in range(0, n, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    lse = ((m + torch.log2(l)) / LOG2E)[..., 0]
    return (acc / l).bfloat16().permute(0, 2, 1, 3), lse


def _bf16_backward_emulation(q, k, v, out, lse, dout, tile=64):
    """The bf16 backward kernel's arithmetic and order of summation: one
    cluster per (batch, head), block r owning key tile r and query tile r.
    Products of bf16 values accumulated in fp32; P = exp2(S * scale * log2
    e - LSE * log2 e) in fp32, rounded to bf16 only as the operand of dV =
    P^T dO; D = rowsum(dO o O) in fp32 from the bf16 output; dS = P o (dP -
    D) in fp32, rounded to bf16 only as the operand of dK = dS^T Q and dQ =
    dS K. dK and dV add the query tiles' products in tile order; dQ adds
    the key tiles' partials dS_{r, r'} K_r' in rank order. Every gradient is
    rounded to bf16 once, at the end."""
    qf, kf, vf, of, dof = (t.float().permute(0, 2, 1, 3)
                           for t in (q, k, v, out, dout))
    n = qf.shape[2]
    scale = q.shape[-1] ** -0.5
    p = torch.exp2(qf @ kf.transpose(-1, -2) * (scale * LOG2E)
                   - (lse * LOG2E)[..., None])
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).bfloat16().float()
    pb = p.bfloat16().float()
    tiles = [slice(t0, t0 + tile) for t0 in range(0, n, tile)]
    dv = sum(pb[:, :, t].transpose(-1, -2) @ dof[:, :, t] for t in tiles)
    dk = sum(ds[:, :, t].transpose(-1, -2) @ qf[:, :, t] for t in tiles) * scale
    dq = sum(ds[:, :, :, t] @ kf[:, :, t] for t in tiles) * scale
    return [g.bfloat16().permute(0, 2, 1, 3) for g in (dq, dk, dv)]


@pytest.mark.parametrize("shape", [(2, 256, 4, 72), (2, 257, 2, 64)])
def test_attention_bf16_backward_emulation_within_card_tolerance(shape):
    """The bf16 backward's rounding points, on bf16 inputs and the bf16
    forward's own output and LSE, stay within GRAD_TOL (1e-2 of the largest
    gradient) of JAX's VJP at 'highest' precision on the same values; so
    the kernel needs no hi/lo split of P and dS."""
    q, k, v, dout = (torch.as_tensor(a).bfloat16() for a in _inputs(shape, seed=11))
    out, lse = _bf16_forward_emulation(q, k, v)
    got = _bf16_backward_emulation(q, k, v, out, lse, dout)
    want = _jax_attention_vjp(*(t.float().numpy() for t in (q, k, v, dout)))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == shape
        assert _rel_err(g.float().numpy(), w) <= BF16_GRAD_TOL, name


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _jax_gn_grads(x, scale, bias, dy, groups, eps):
    """dx (back in NCHW), dscale, dbias: jax.grad of <fused_groupnorm_swish,
    dy> in JAX's NHWC layout, through the custom VJP (_fgs_bwd)."""
    nhwc = lambda a: np.moveaxis(a, 1, -1)

    def loss(xx, ss, bb):
        return (fused_groupnorm_swish(xx, ss, bb, groups, eps)
                * jnp.asarray(nhwc(dy))).sum()

    with jax.default_matmul_precision("highest"):
        gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(nhwc(x)), jnp.asarray(scale), jnp.asarray(bias))
    return np.moveaxis(np.asarray(gx), -1, 1), np.asarray(gs), np.asarray(gb)


# (shape, groups): decoder-like spans, a ragged H*W (81, odd: the kernel's
# element-by-element path), channels cut by every slice count below
GN_BWD_CASES = [((2, 64, 16, 16), 32), ((1, 32, 24, 16), 8), ((1, 12, 9, 9), 4)]
GN_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("shape,groups", GN_BWD_CASES)
def test_gn_backward_reference_matches_fused_vjp(shape, groups, eps):
    x, scale, bias, dy = _gn_inputs(shape, seed=groups + int(eps * 1e6))
    want = _jax_gn_grads(x, scale, bias, dy, groups, eps)
    got = gn.groupnorm_swish_backward_reference(
        *(torch.as_tensor(a) for a in (x, scale, bias, dy)), groups, eps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GN_GRAD_TOL)


# the backward kernel's warps: 8 per block, each owning a run of R = 8
# rows of 32 units (16-byte chunks: 4 elements in fp32), so 1024 fp32
# elements of a slice
GN_WARPS, GN_WARP_ELEMS = 8, 8 * 32 * 4


def _gn_bwd_split_emulation(x, w, b, dy, groups, clusters, eps):
    """The backward kernel's arithmetic in fp32, in its order of summation:
    each of ``clusters`` slices of an (n, g) span takes its (count, mean,
    M2), combined with Chan's formula in rank order (the statistics); the
    span sums of h = w g and h xh are the slices' sums added in rank order;
    dx = inv (h - mean(h) - xh mean(h xh)). For dw and dbias each warp of
    a slice sums g and g xh over each channel of its run (one pass, with
    the sums of h); a channel that several warps share adds their sums in
    warp order, then the slices' in rank order, into an (N, C) partial;
    dw and dbias sum it over N in 8 runs, each in order, added in order."""
    n, c = x.shape[:2]
    spans_x = x.reshape(n * groups, -1)
    spans_dy = dy.reshape(n * groups, -1)
    span = spans_x.shape[1]
    cpg, hw = c // groups, span // (c // groups)
    slice_len = gn.slice_length(span, clusters)
    cuts = [slice(r * slice_len, min((r + 1) * slice_len, span))
            for r in range(clusters)]
    assert all(s.start < span for s in cuts)
    count = mean = m2 = torch.zeros(n * groups, 1)
    for cut in cuts:
        part = spans_x[:, cut]
        mean_s = part.mean(1, keepdim=True)
        m2_s = ((part - mean_s) ** 2).sum(1, keepdim=True)
        total = count + part.shape[1]
        delta = mean_s - mean
        mean = mean + delta * (part.shape[1] / total)
        m2 = m2 + m2_s + delta * delta * (count * part.shape[1] / total)
        count = total
    inv = 1.0 / torch.sqrt(m2 / span + eps)
    channel = torch.arange(span) // hw                       # within the group
    group = torch.arange(n * groups) % groups
    wc = w.reshape(groups, cpg)[group][:, channel]
    bc = b.reshape(groups, cpg)[group][:, channel]
    xh = (spans_x - mean) * inv
    z = xh * wc + bc
    sg = torch.sigmoid(z)
    g = spans_dy * sg * (1 + z * (1 - sg))
    h = wc * g
    tot_h = sum(h[:, cut].sum(1, keepdim=True) for cut in cuts)
    tot_hx = sum((h * xh)[:, cut].sum(1, keepdim=True) for cut in cuts)
    dx = inv * (h - tot_h / span - xh * tot_hx / span)
    part_g = torch.zeros(n * groups, cpg)
    part_gx = torch.zeros(n * groups, cpg)
    for cut in cuts:
        slice_g = torch.zeros(n * groups, cpg)
        slice_gx = torch.zeros(n * groups, cpg)
        for a in range(cut.start, cut.stop, GN_WARP_ELEMS):      # the warps
            run = slice(a, min(a + GN_WARP_ELEMS, cut.stop))
            for cc in channel[run].unique():
                sel = torch.arange(run.start, run.stop)[channel[run] == cc]
                slice_g[:, cc] += g[:, sel].sum(1)
                slice_gx[:, cc] += (g * xh)[:, sel].sum(1)
        part_g += slice_g
        part_gx += slice_gx
    per = -(-n // GN_WARPS)
    dbias, dw = torch.zeros(c), torch.zeros(c)
    for r in range(GN_WARPS):
        rows = slice(r * per, min(n, (r + 1) * per))
        dbias = dbias + part_g.reshape(n, c)[rows].sum(0)
        dw = dw + part_gx.reshape(n, c)[rows].sum(0)
    return dx.reshape(x.shape), dw, dbias


@pytest.mark.parametrize("clusters", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape,groups", GN_BWD_CASES)
def test_gn_backward_split_emulation_matches_jax(shape, groups, clusters):
    x, scale, bias, dy = _gn_inputs(shape, seed=40 + groups)
    want = _jax_gn_grads(x, scale, bias, dy, groups, 1e-6)
    got = _gn_bwd_split_emulation(
        *(torch.as_tensor(a) for a in (x, scale, bias, dy)), groups, clusters,
        1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GN_GRAD_TOL)
