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
    """The port's gradient (autograd of the plain version; on the card the
    Function's backward replays that VJP) against ``fused_groupnorm_swish``'s
    custom VJP."""
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


def test_groupnorm_swish_function_backward_replays_plain_vjp():
    """``_GroupNormSwish.backward`` (the card path's backward) equals the
    plain version's autograd; its forward is swapped for the plain version
    here because the kernel needs the card."""
    x, scale, bias = _gn_inputs((2, 8, 4, 4), seed=6)
    grad = torch.as_tensor(np.random.default_rng(7).standard_normal(x.shape)
                           .astype(np.float32))

    class Ctx:
        saved_tensors = tuple(torch.as_tensor(a) for a in (x, scale, bias))
        num_groups, eps = 4, 1e-6

    got = gn._GroupNormSwish.backward(Ctx, grad)[:3]
    inputs = [torch.as_tensor(a).requires_grad_() for a in (x, scale, bias)]
    out = gn.groupnorm_swish_reference(*inputs, 4, 1e-6)
    want = torch.autograd.grad(out, inputs, grad)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


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


def test_gn_block_sizes_are_powers_of_two():
    for span in (1, 255, 256, 4096, 8192, 131072):
        block, warps = gn._block_for(span)
        assert block & (block - 1) == 0 and 256 <= block <= 4096
        assert warps in (4, 8)
