"""DiffCollage stitching and the EDM loss-guided workers: the port's
``diffusion/collage.py`` against ``rule_guided_music_tpu/diffusion/collage.py``.

Every function runs in both frameworks on the same numpy inputs (seeded),
on a toy window denoiser written once for each framework and on the
quality_tiny DiTRotary_XS_8, whose weights both load. Tolerance: 1e-5 of
the largest magnitude of the JAX output (float32 on both sides; the
workers' gradients go through ``jax.grad`` there and
``torch.autograd.grad`` here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import collage as jc
from rule_guided_music_tpu.diffusion import edm as jedm
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import collage as tc
from rule_guided_music_tpu_torch.diffusion import edm as tedm
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
REL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rel=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# a nonlinear, t- and y-dependent window denoiser, once per framework
def j_toy(x, t, y=None):
    out = jnp.tanh(x) * (1.0 + 0.01 * t.reshape(-1, 1, 1, 1))
    if y is not None:
        out = out + 0.1 * y.reshape(-1, 1, 1, 1).astype(x.dtype)
    return out + 0.05 * jnp.mean(x, axis=(1, 2, 3), keepdims=True)


def t_toy(x, t, y=None):
    out = torch.tanh(x) * (1.0 + 0.01 * t.reshape(-1, 1, 1, 1))
    if y is not None:
        out = out + 0.1 * y.reshape(-1, 1, 1, 1).to(x.dtype)
    return out + 0.05 * x.mean(dim=(1, 2, 3), keepdim=True)


# its sigma-space form: x0 = x - sigma * eps depends on x everywhere
def j_toy_sigma(x, sigma, y=None):
    return j_toy(x, sigma, y) * 0.7 + 0.3 * x / jnp.maximum(
        sigma.reshape(-1, 1, 1, 1), 1e-8)


def t_toy_sigma(x, sigma, y=None):
    return t_toy(x, sigma, y) * 0.7 + 0.3 * x / torch.clamp(
        sigma.reshape(-1, 1, 1, 1), min=1e-8)


def test_lengths_match_jax():
    for num_img in (1, 2, 3):
        for overlap in (32, 64):
            assert tc.linear_length(num_img, overlap) == jc.linear_length(num_img, overlap)
            assert tc.circle_length(num_img, overlap) == jc.circle_length(num_img, overlap)
    assert tc.BASE_LEN == jc.BASE_LEN == 128
    # the demos' circle of one image is one excerpt; the CLI default 20.48 s
    assert tc.circle_length(1, 64) == 128 and tc.circle_length(3, 64) == 256


@pytest.mark.parametrize("n,t_long", [(2, 192), (3, 320), (3, 256)])
def test_split_and_merge_match_jax(n, t_long):
    x = rand(0, (2, 4, t_long, 16))
    jw, jov = jc.split_windows(jnp.asarray(x), n)
    tw, tov = tc.split_windows(torch.as_tensor(x), n)
    assert tov == jov
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for is_avg in (True, False):
        close(tc.merge_windows(tw, tov, n, is_avg),
              jc.merge_windows(jw, jov, n, is_avg))
    np.testing.assert_allclose(tc.merge_windows(tw, tov, n).numpy(), x, atol=1e-6)


@pytest.mark.parametrize("circle", [False, True])
def test_cond_ind_identity_and_half_window_shape(circle):
    """With eps_fn the identity the stitched score is the identity; the
    half-window call sees (B*n, C, overlap, P)."""
    num_img, overlap = 3, 64
    length = (tc.circle_length if circle else tc.linear_length)(num_img, overlap)
    x = torch.as_tensor(rand(1, (2, 4, length, 16)))
    shapes = []

    def ident(xs, t, y=None):
        shapes.append(tuple(xs.shape))
        return xs

    out = tc.make_cond_ind_eps_fn(ident, num_img, overlap, circle=circle)(
        x, torch.zeros(2))
    np.testing.assert_allclose(out.numpy(), x.numpy(), atol=1e-5)
    n = num_img + 1 if circle else num_img
    assert shapes == [(2 * n, 4, 128, 16), (2 * n, 4, overlap, 16)]


@pytest.mark.parametrize("circle", [False, True])
@pytest.mark.parametrize("maker", ["cond_ind", "avg"])
def test_stitched_eps_matches_jax(circle, maker):
    num_img, overlap = 2, 64
    length = (tc.circle_length if circle else tc.linear_length)(num_img, overlap)
    x = rand(2, (2, 4, length, 16))
    t = np.array([3.0, 700.0], np.float32)
    y = np.array([1, 2], np.int32)
    jmake = {"cond_ind": jc.make_cond_ind_eps_fn, "avg": jc.make_avg_eps_fn}[maker]
    tmake = {"cond_ind": tc.make_cond_ind_eps_fn, "avg": tc.make_avg_eps_fn}[maker]
    want = jmake(j_toy, num_img, overlap, circle=circle)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    got = tmake(t_toy, num_img, overlap, circle=circle)(
        torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(y).long())
    close(got, want)


def test_cond_ind_passes_repeated_t_and_y():
    seen = {}

    def eps_fn(xs, t, y=None):
        seen["t"], seen["y"] = t, y
        return torch.zeros_like(xs)

    x = torch.zeros((2, 4, tc.linear_length(2, 64), 16))
    tc.make_cond_ind_eps_fn(eps_fn, 2, 64)(x, torch.tensor([5.0, 9.0]),
                                           torch.tensor([1, 2]))
    assert seen["t"].tolist() == [5, 5, 9, 9] and seen["y"].tolist() == [1, 1, 2, 2]


@pytest.mark.parametrize("circle", [False, True])
def test_cond_ind_sr_matches_jax(circle):
    num_img, overlap = 2, 64
    length = (tc.circle_length if circle else tc.linear_length)(num_img, overlap)
    low_len = length // 4
    x, low = rand(3, (1, 2, length, 4)), rand(4, (1, 2, low_len, 4))

    def j_sr(xs, t, y=None, low_w=None):
        return j_toy(xs, t, y) + 0.2 * jnp.mean(low_w, axis=(1, 2, 3),
                                                keepdims=True)

    def t_sr(xs, t, y=None, low_w=None):
        return t_toy(xs, t, y) + 0.2 * low_w.mean(dim=(1, 2, 3), keepdim=True)

    want = jc.make_cond_ind_sr_eps_fn(j_sr, num_img, overlap, jnp.asarray(low),
                                      circle=circle)(jnp.asarray(x), jnp.ones((1,)))
    got = tc.make_cond_ind_sr_eps_fn(t_sr, num_img, overlap, torch.as_tensor(low),
                                     circle=circle)(torch.as_tensor(x), torch.ones(1))
    close(got, want)


@pytest.mark.parametrize("weight", [0.0, 0.05])
def test_loss_guided_eps_matches_jax(weight):
    num_img, overlap = 3, 16
    x = rand(5, (2, num_img, 2, 64, 4))
    sigma = np.array([0.7, 2.5], np.float32)
    want = jc.make_loss_guided_eps_fn(j_toy_sigma, num_img, overlap, weight)(
        jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():       # the worker turns grad mode on itself
        got = tc.make_loss_guided_eps_fn(t_toy_sigma, num_img, overlap, weight)(
            torch.as_tensor(x), torch.as_tensor(sigma))
    close(got, want)


@pytest.mark.parametrize("weight", ["optimal", 0.3])
@pytest.mark.parametrize("worker", ["seq", "circle", "para"])
def test_edm_workers_match_jax(worker, weight):
    x = rand(6, (4, 1, 16, 4))
    sigma = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
    src = rand(7, (4, 1, 16, 4))
    if worker == "seq":
        jw = jc.make_seq_extend_eps_fn(j_toy_sigma, jnp.asarray(src), 4, weight,
                                       ratio=0.8)
        tw = tc.make_seq_extend_eps_fn(t_toy_sigma, torch.as_tensor(src), 4,
                                       weight, ratio=0.8)
    else:
        jw = {"circle": jc.make_circle_loss_eps_fn,
              "para": jc.make_para_loss_eps_fn}[worker](j_toy_sigma, 4, weight)
        tw = {"circle": tc.make_circle_loss_eps_fn,
              "para": tc.make_para_loss_eps_fn}[worker](t_toy_sigma, 4, weight)
    want = jw(jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = tw(torch.as_tensor(x), torch.as_tensor(sigma))
    close(got, want)


def test_optimal_weight_seq_replace_and_circle_merge_match_jax():
    a, b = rand(8, (3, 2, 8, 4)), rand(9, (3, 2, 8, 4))
    close(tc._optimal_weight(torch.as_tensor(a), torch.as_tensor(b)),
          jc._optimal_weight(jnp.asarray(a), jnp.asarray(b)))
    # a zero gradient gives weight 0, not a division by zero
    assert float(tc._optimal_weight(torch.as_tensor(a), torch.zeros(3, 2, 8, 4))) == 0.0
    np.testing.assert_array_equal(
        tc.seq_x0_replace(torch.as_tensor(a), torch.as_tensor(b), 4).numpy(),
        np.asarray(jc.seq_x0_replace(jnp.asarray(a), jnp.asarray(b), 4)))
    ring = rand(10, (4, 1, 16, 4))
    merged = tc.circle_merge_batch(torch.as_tensor(ring), 4)
    assert merged.shape == (1, 1, 48, 4)
    close(merged, jc.circle_merge_batch(jnp.asarray(ring), 4))


@pytest.fixture(scope="module")
def dits():
    """The quality_tiny XS DiT in both frameworks, and one respaced table."""
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    jt = jschedule.make_schedule("linear", 1000, "10").tables()
    tt = tschedule.make_schedule("linear", 1000, "10").tables("cpu")
    return dict(j=lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
                t=lambda x, t, y=None: tdit(x, t), jt=jt, tt=tt)


@pytest.mark.parametrize("circle", [False, True])
def test_cond_ind_on_the_dit_matches_jax(dits, circle):
    """The stitched XS DiT score, full 128-column and 64-column half windows
    (128 and 64 tokens here, the rotary table keyed by length)."""
    num_img, overlap = 2, 64
    length = (tc.circle_length if circle else tc.linear_length)(num_img, overlap)
    x = rand(11, (2, 4, length, 16))
    t = np.array([120.0, 870.0], np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jc.make_cond_ind_eps_fn(dits["j"], num_img, overlap,
                                               circle=circle))(
            jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tc.make_cond_ind_eps_fn(dits["t"], num_img, overlap, circle=circle)(
            torch.as_tensor(x), torch.as_tensor(t))
    close(got, want)


@pytest.mark.parametrize("worker", ["loss_guided", "circle"])
def test_workers_on_the_dit_match_jax(dits, worker):
    """The gradient of the seam loss through the XS DiT (VP denoiser
    driven in sigma space), against jax.grad."""
    jeps = jedm.vp_eps_fn_from_model(dits["jt"], dits["j"])
    teps = tedm.vp_eps_fn_from_model(dits["tt"], dits["t"])
    if worker == "loss_guided":
        x = rand(12, (1, 2, 4, 128, 16))
        sigma = np.array([1.3], np.float32)
        jw = jc.make_loss_guided_eps_fn(lambda a, s, y=None: jeps(a, s), 2, 64, 0.01)
        tw = tc.make_loss_guided_eps_fn(lambda a, s, y=None: teps(a, s), 2, 64, 0.01)
    else:
        x = rand(13, (4, 4, 128, 16))
        sigma = np.full((4,), 1.3, np.float32)
        jw = jc.make_circle_loss_eps_fn(lambda a, s, y=None: jeps(a, s), 64)
        tw = tc.make_circle_loss_eps_fn(lambda a, s, y=None: teps(a, s), 64)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jw)(jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = tw(torch.as_tensor(x), torch.as_tensor(sigma))
    close(got, want)
