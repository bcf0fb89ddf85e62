"""Port kernels: plain versions against the JAX package's Pallas kernels.

On the CPU each wrapper of ``rule_guided_music_tpu_torch.ops`` computes its
plain PyTorch version; here that version is held against the Pallas kernel
it replaces, run in Pallas interpret mode as tests/test_pallas_*.py run it,
and against the JAX reference formulation. JAX runs under
``default_matmul_precision("highest")``; both sides are float32 and inputs
come from numpy with a fixed seed.

The kernels themselves run in tests/test_torch_gpu.py (marked ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.ops.pallas_attention import flash_attention as jax_flash
from rule_guided_music_tpu.ops.pallas_groupnorm import (
    _gn_swish_ref,
    fused_groupnorm_swish,
    groupnorm_swish as jax_groupnorm_swish,
)
from rule_guided_music_tpu_torch.ops import flash_attention as fa
from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn
from rule_guided_music_tpu_torch.ops.attention import sdpa

# fp32 on both sides; only the summation order differs (~1e-7 relative on
# O(1) outputs), so 1e-5 leaves two decades of margin.
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# one-pass (Pallas, E[x^2]-mean^2) vs two-pass (F.group_norm) variance
# differ by ~1e-7 relative at these means/scales.
GN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [
    (2, 256, 4, 72),    # XL_8 head dim, fewer heads
    (2, 257, 2, 64),    # S/8 classifier sequence (CLS token): ragged N
    (1, 40, 3, 16),     # short sequence, small head dim
])
def test_attention_plain_matches_pallas_interpret(shape, interpret_mode):
    q, k, v = _qkv(shape, seed=sum(shape))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = sdpa(*(torch.as_tensor(a) for a in (q, k, v)))
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **ATTN_TOL)


def test_attention_wrapper_takes_strided_views():
    """The DiT hands q, k, v as views of one (B, N, 3, H, D) qkv tensor."""
    rng = np.random.default_rng(5)
    qkv = torch.as_tensor(rng.standard_normal((2, 33, 3, 2, 8)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "head_dim", "stride"])
def test_attention_wrapper_rejects_bad_input(bad):
    q = torch.zeros(1, 8, 2, 16)
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = torch.zeros(1, 9, 2, 16)
    elif bad == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 8, 2, 160) for _ in range(3))
    else:
        q = torch.zeros(1, 8, 2, 32)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v)


def test_attention_wrapper_refuses_other_devices():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


GN_CASES = [((2, 64, 16, 16), 32), ((1, 128, 8, 8), 32), ((3, 8, 4, 4), 4),
            ((1, 32, 24, 16), 8)]


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_swish_plain_matches_jax_reference(shape, groups):
    x, scale, bias = _gn_inputs(shape, seed=groups)
    x_nhwc = np.transpose(x, (0, 2, 3, 1))
    ref = np.asarray(_gn_swish_ref(jnp.asarray(x_nhwc), jnp.asarray(scale),
                                   jnp.asarray(bias), groups, 1e-6))
    out = gn.groupnorm_swish(torch.as_tensor(x), torch.as_tensor(scale),
                             torch.as_tensor(bias), groups)
    np.testing.assert_allclose(np.transpose(out.numpy(), (0, 2, 3, 1)), ref,
                               **GN_TOL)


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_swish_plain_matches_pallas_interpret(shape, groups,
                                                        interpret_mode):
    x, scale, bias = _gn_inputs(shape, seed=10 + groups)
    x_nhwc = np.transpose(x, (0, 2, 3, 1))
    ref = np.asarray(jax_groupnorm_swish(jnp.asarray(x_nhwc), jnp.asarray(scale),
                                         jnp.asarray(bias), num_groups=groups))
    out = gn.groupnorm_swish(torch.as_tensor(x), torch.as_tensor(scale),
                             torch.as_tensor(bias), groups)
    np.testing.assert_allclose(np.transpose(out.numpy(), (0, 2, 3, 1)), ref,
                               **GN_TOL)


def test_groupnorm_swish_grad_matches_fused_vjp():
    """The port's gradient on the CPU (autograd of the plain version; on the
    card the backward kernel, whose plain version tests/test_torch_backward.py
    holds against the same VJP) against ``fused_groupnorm_swish``'s custom
    VJP."""
    x, scale, bias = _gn_inputs((2, 16, 4, 4), seed=4)
    x_nhwc = np.transpose(x, (0, 2, 3, 1))

    def loss_jax(xx, ss, bb):
        return (fused_groupnorm_swish(xx, ss, bb, 4) ** 2).sum()

    gx, gs, gb = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(x_nhwc), jnp.asarray(scale), jnp.asarray(bias))
    tx, ts, tb = (torch.as_tensor(a).requires_grad_() for a in (x, scale, bias))
    (gn.groupnorm_swish(tx, ts, tb, 4) ** 2).sum().backward()
    np.testing.assert_allclose(np.transpose(tx.grad.numpy(), (0, 2, 3, 1)),
                               np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("output", ["dx", "dweight", "dbias"])
def test_groupnorm_swish_function_backward_replays_plain_vjp(output):
    """``groupnorm_swish_backward_reference``, the plain version of the
    backward kernel that ``_GroupNormSwish.backward`` launches on the card,
    against autograd through the plain forward, one output at a time."""
    x, scale, bias = _gn_inputs((2, 8, 4, 4), seed=6)
    grad = torch.as_tensor(np.random.default_rng(7).standard_normal(x.shape)
                           .astype(np.float32))
    inputs = [torch.as_tensor(a).requires_grad_() for a in (x, scale, bias)]
    out = gn.groupnorm_swish_reference(*inputs, 4, 1e-6)
    want = torch.autograd.grad(out, inputs, grad)
    got = gn.groupnorm_swish_backward_reference(
        *(t.detach() for t in inputs), grad, 4, 1e-6)
    i = ["dx", "dweight", "dbias"].index(output)
    assert got[i].shape == want[i].shape
    torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["groups", "affine", "dtype"])
def test_groupnorm_swish_rejects_bad_input(bad):
    x, w, b = torch.zeros(1, 8, 4, 4), torch.ones(8), torch.zeros(8)
    groups = 4
    if bad == "groups":
        groups = 3
    elif bad == "affine":
        w = torch.ones(4)
    else:
        x = x.long()
    with pytest.raises((ValueError, TypeError)):
        gn.groupnorm_swish(x, w, b, groups)


# the decoder's GroupNorm+swish geometries (C, H=W), G = 32, and the cluster
# size S that each gets in bf16 and in fp32 (one slice <= 64 KB)
DECODER_GN = [((512, 16), 1, 1), ((512, 32), 1, 1), ((256, 32), 1, 1),
              ((256, 64), 1, 2), ((256, 128), 4, 8), ((128, 128), 2, 4)]


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("geometry,s_bf16,s_fp32", DECODER_GN)
def test_gn_cluster_plan_covers_each_span(geometry, s_bf16, s_fp32, itemsize):
    c, hw = geometry
    span = (c // 32) * hw * hw
    clusters, slice_len = gn.plan_slices(span, itemsize)
    assert clusters == (s_bf16 if itemsize == 2 else s_fp32)
    assert clusters & (clusters - 1) == 0 and 1 <= clusters <= gn.MAX_CLUSTER
    assert slice_len * itemsize <= gn.SLICE_BYTES and slice_len % 8 == 0
    lengths = [min(slice_len, span - r * slice_len) for r in range(clusters)]
    assert all(n > 0 for n in lengths) and sum(lengths) == span


def test_gn_cluster_plan_refuses_groups_past_eight_slices():
    limit = gn.MAX_CLUSTER * gn.SLICE_BYTES // 4
    assert gn.plan_slices(limit, 4) == (8, limit // 8)
    with pytest.raises(ValueError, match="8 x 64 KB"):
        gn.plan_slices(limit + 8, 4)


# the backward's plan: slices of at most 32 KB (x, and as much of dy, per
# block: three blocks on an SM), clusters of up to 16; the S each decoder
# geometry gets in bf16 and in fp32
DECODER_GN_BWD = [((512, 16), 1, 1), ((512, 32), 1, 2), ((256, 32), 1, 1),
                  ((256, 64), 2, 4), ((256, 128), 8, 16), ((128, 128), 4, 8)]


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("geometry,s_bf16,s_fp32", DECODER_GN_BWD)
def test_gn_backward_plan_covers_each_span(geometry, s_bf16, s_fp32, itemsize):
    c, hw = geometry
    span = (c // 32) * hw * hw
    clusters, slice_len = gn.plan_bwd_slices(span, itemsize)
    assert clusters == (s_bf16 if itemsize == 2 else s_fp32)
    assert clusters & (clusters - 1) == 0 and 1 <= clusters <= gn.BWD_MAX_CLUSTER
    assert slice_len * itemsize <= gn.BWD_SLICE_BYTES and slice_len % 8 == 0
    lengths = [min(slice_len, span - r * slice_len) for r in range(clusters)]
    assert all(n > 0 for n in lengths) and sum(lengths) == span


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_gn_backward_plan_leaves_no_slice_empty(itemsize):
    """Every span up to the backward's limit, in steps that cross each
    doubling of S: S slices of slice_len cover it, none empty, none over
    32 KB; two slices and their channel sums fit three blocks on an SM."""
    limit = gn.BWD_MAX_CLUSTER * gn.BWD_SLICE_BYTES // itemsize
    for span in list(range(1, 4096, 37)) + list(range(4096, limit + 1, 1531)) + [limit]:
        clusters, slice_len = gn.plan_bwd_slices(span, itemsize)
        assert slice_len * itemsize <= gn.BWD_SLICE_BYTES
        assert (clusters - 1) * slice_len < span <= clusters * slice_len, span
    assert 3 * (2 * gn.BWD_SLICE_BYTES + 1024) <= 227 * 1024


def test_gn_backward_plan_refuses_groups_past_sixteen_slices():
    limit = gn.BWD_MAX_CLUSTER * gn.BWD_SLICE_BYTES // 4
    assert gn.plan_bwd_slices(limit, 4) == (16, limit // 16)
    with pytest.raises(ValueError, match="16 x 32 KB"):
        gn.plan_bwd_slices(limit + 8, 4)
    with pytest.raises(ValueError, match="16 x 32 KB"):
        gn.plan_bwd_slices(2 * limit + 8, 2)


def _split_stats_emulation(x, scale, bias, groups, clusters, eps=1e-6):
    """The cluster kernel's arithmetic in fp32: each of ``clusters`` slices
    of an (n, g) span takes its mean and M2; Chan's formula combines them
    in rank order; y = swish(x * a + b), a = inv * scale[c],
    b = bias[c] - mean * a."""
    n, c = x.shape[:2]
    spans = x.reshape(n * groups, -1)
    span = spans.shape[1]
    slice_len = gn.slice_length(span, clusters)
    count = torch.zeros(n * groups, 1)
    mean = torch.zeros(n * groups, 1)
    m2 = torch.zeros(n * groups, 1)
    for r in range(clusters):
        part = spans[:, r * slice_len:(r + 1) * slice_len]
        assert part.shape[1] > 0
        mean_s = part.sum(1, keepdim=True) / part.shape[1]
        m2_s = ((part - mean_s) ** 2).sum(1, keepdim=True)
        total = count + part.shape[1]
        delta = mean_s - mean
        mean = mean + delta * (part.shape[1] / total)
        m2 = m2 + m2_s + delta * delta * (count * part.shape[1] / total)
        count = total
    inv = 1.0 / torch.sqrt(m2 / span + eps)
    a = (inv.reshape(n, groups, 1) * scale.reshape(groups, -1)).reshape(n, c)
    b = bias - mean.reshape(n, groups, 1).expand(n, groups, c // groups).reshape(n, c) * a
    y = x * a[:, :, None, None] + b[:, :, None, None]
    return y * torch.sigmoid(y)


@pytest.mark.parametrize("clusters", [1, 2, 4])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_gn_split_statistics_match_jax_reference(shape, groups, clusters):
    x, scale, bias = _gn_inputs(shape, seed=20 + groups)
    ref = np.asarray(_gn_swish_ref(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                                   jnp.asarray(scale), jnp.asarray(bias),
                                   groups, 1e-6))
    out = _split_stats_emulation(torch.as_tensor(x), torch.as_tensor(scale),
                                 torch.as_tensor(bias), groups, clusters)
    np.testing.assert_allclose(np.transpose(out.numpy(), (0, 2, 3, 1)), ref,
                               **GN_TOL)


# the bf16 tolerance chip_smoke.py states for the attention kernel against
# the plain version in fp32 on the same values
BF16_ATTN_TOL = 8e-3


def _bf16_tile_emulation(q, k, v, tile=64):
    """The tensor-core kernel's arithmetic on bf16 (B, N, H, D) inputs:
    64-key tiles, S = Q K^T and O += P V accumulated in fp32, the online
    softmax in base 2 with scale * log2(e) folded in, P rounded to bf16
    before P V (its row sum taken before rounding), output rounded to bf16."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    b, h, n, d = qf.shape
    scale_log2 = d ** -0.5 * 1.4426950408889634
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
    return (acc / l).bfloat16().permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape", [(2, 256, 4, 72), (2, 257, 2, 64)])
def test_attention_bf16_tile_emulation_within_card_tolerance(shape,
                                                             interpret_mode):
    """The card holds the bf16 kernel to 8e-3 of the fp32 plain version;
    the same arithmetic, emulated here, stays inside that of the Pallas
    kernel run in interpret mode on the same bf16 values."""
    q, k, v = (torch.as_tensor(a).bfloat16() for a in _qkv(shape, seed=3))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_flash(*(jnp.asarray(t.float().numpy())
                                     for t in (q, k, v))))
    out = _bf16_tile_emulation(q, k, v).float().numpy()
    assert out.shape == shape
    assert np.abs(out - ref).max() <= BF16_ATTN_TOL


# The fp32 kernels (csrc/flash_attention_fp32.cu) take every product on the
# tensor cores as three TF32 products. Their tolerances on the card, as
# chip_smoke.py states them: 1e-4 on outputs (max abs error against the
# plain version), 1e-5 on gradients (over the largest gradient).
FP32_ATTN_TOL = 1e-4
FP32_GRAD_TOL = 1e-5
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _tf32_split(x):
    """x = big + small as the kernels split it: big rounded to TF32 (10
    mantissa bits, to nearest, ties away), small = x - big (exact in fp32)
    rounded the same way, as the tensor cores drop its low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    small = (((x - big).view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return big, small


def _mm3(a, b, chunk):
    """a @ b as the kernels take it: three TF32 products per partial of
    ``chunk`` along the reduction (the small terms first), the partials
    summed in fp32 in order."""
    ab, as_ = _tf32_split(a)
    bb, bs = _tf32_split(b)
    total = None
    for c0 in range(0, a.shape[-1], chunk):
        sl = slice(c0, c0 + chunk)
        part = as_[..., sl] @ bb[..., sl, :] + ab[..., sl] @ bs[..., sl, :] \
            + ab[..., sl] @ bb[..., sl, :]
        total = part if total is None else total + part
    return total


def _tf32x3_forward(q, k, v, tile=64):
    """The fp32 forward kernel's arithmetic on (B, N, H, D): 64-key tiles,
    S = Q K^T in partials of 24 of D, the online softmax in base 2 with
    scale * log2(e) folded in, O += P V in partials of 32 keys. Returns
    (out, lse)."""
    qf, kf, vf = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    n, d = qf.shape[2], qf.shape[3]
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full(qf.shape[:3] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, n, tile):
        s = _mm3(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2), 24)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(p, vf[:, :, k0:k0 + tile], 32)
        m = m_new
    out = (acc / l).permute(0, 2, 1, 3)
    return out, ((m + torch.log2(l)) * LN2)[..., 0]


def _tf32x3_backward(q, k, v, out, lse, dout):
    """The fp32 backward kernels' arithmetic, in their tile order: Di =
    rowsum(dO o O); dK, dV over 32-query tiles (S^T = K Q^T and dP^T = V
    dO^T in partials of 24 of D, one partial of dV and of dK per tile);
    dS^T kept; dQ = dS K over 64-key tiles in partials of 32 keys."""
    qf, kf, vf, of, dof = (t.permute(0, 2, 1, 3) for t in (q, k, v, out, dout))
    n, d = qf.shape[2], qf.shape[3]
    scale = d ** -0.5
    delta = (dof * of).sum(-1)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dst = torch.zeros(qf.shape[:2] + (n, n))
    for q0 in range(0, n, 32):
        sl = slice(q0, q0 + 32)
        st = _mm3(kf, qf[:, :, sl].transpose(-1, -2), 24)
        pt = torch.exp2(st * (scale * LOG2E) - (lse[:, :, None, sl] * LOG2E))
        dv = dv + _mm3(pt, dof[:, :, sl], 32)
        dpt = _mm3(vf, dof[:, :, sl].transpose(-1, -2), 24)
        dst[..., sl] = pt * (dpt - delta[:, :, None, sl])
        dk = dk + _mm3(dst[..., sl], qf[:, :, sl], 32)
    dq = torch.zeros_like(qf)
    for k0 in range(0, n, 64):
        sl = slice(k0, k0 + 64)
        dq = dq + _mm3(dst[:, :, sl].transpose(-1, -2), kf[:, :, sl], 32)
    return tuple(g.permute(0, 2, 1, 3) for g in (dq * scale, dk * scale, dv))


FP32_EMULATION_SHAPES = [(2, 256, 4, 72), (2, 257, 2, 64), (1, 100, 3, 36)]


@pytest.mark.parametrize("shape", FP32_EMULATION_SHAPES)
def test_attention_tf32x3_emulation_within_card_tolerance(shape, interpret_mode):
    """The fp32 kernel's 3xTF32 arithmetic, emulated, stays within the
    card's 1e-4 of the Pallas kernel run in interpret mode on the same fp32
    values, and its LSE within 1e-5 of the log-sum-exp of JAX's logits."""
    q, k, v = _qkv(shape, seed=5 + shape[1])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        logits = jnp.einsum("bnhd,bmhd->bhnm", jnp.asarray(q) * shape[-1] ** -0.5,
                            jnp.asarray(k))
        ref_lse = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    out, lse = _tf32x3_forward(*(torch.as_tensor(a) for a in (q, k, v)))
    assert out.shape == shape
    assert np.abs(out.numpy() - ref).max() <= FP32_ATTN_TOL
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", FP32_EMULATION_SHAPES)
def test_attention_tf32x3_backward_emulation_matches_jax_vjp(shape):
    """The fp32 backward kernels' 3xTF32 arithmetic and tile order,
    emulated on the emulated forward's output and LSE, within the card's
    1e-5 of the largest gradient of ``jax.vjp`` of the JAX package's
    attention."""
    from rule_guided_music_tpu.ops.attention import sdpa as jax_sdpa

    q, k, v, dout = _qkv(shape, seed=9 + shape[1]) + [
        np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax_sdpa, *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = _tf32x3_forward(tq, tk, tv)
    got = _tf32x3_backward(tq, tk, tv, out, lse, tdo)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == shape
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= FP32_GRAD_TOL, (name, err)


def test_tf32_split_is_exact_to_two_ulps_of_tf32():
    """big + small recovers x to within 2^-21 of |x| (the residue below
    small's 11 bits), and big alone is x rounded to TF32 (10 bits)."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(4096)
                        .astype(np.float32) * 100)
    big, small = _tf32_split(x)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - big - small).abs() <= x.abs() * 2.0 ** -21).all()
