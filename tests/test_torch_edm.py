"""The EDM Heun sampler: the port's ``diffusion/edm.py`` against
``rule_guided_music_tpu/diffusion/edm.py``.

``karras_sigmas`` must be equal; ``vp_eps_fn_from_model`` must pick the
same timesteps; ``heun_sample_loop`` runs on the same initial noise (and,
with churn, on JAX's churn draws replayed through ``noise_fn``), within
1e-5 of the largest magnitude (float32 on both sides).
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


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def jax_replay(seed, num_steps):
    """noise_fn drawing what ``heun_sample_loop(PRNGKey(seed), ...)`` draws:
    ``rng, init_rng`` first, then ``rng, churn_rng`` per step."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    churn = []
    for _ in range(num_steps):
        rng, churn_rng = jax.random.split(rng)
        churn.append(churn_rng)

    def noise_fn(kind, step, shape):
        key = init_rng if kind == "init" else churn[step]
        return torch.as_tensor(np.array(jax.random.normal(key, shape)))

    return noise_fn


@pytest.mark.parametrize("args", [(20, 1e-3, 80.0, 7.0), (5, 2e-3, 10.0, 3.0),
                                  (1, 1e-3, 80.0, 7.0)])
def test_karras_sigmas_equal(args):
    np.testing.assert_array_equal(tedm.karras_sigmas(*args),
                                  jedm.karras_sigmas(*args))


# data concentrated where x0 = 0.5 + 0.3 tanh(x): the chain ends near 0.63
def j_oracle(x, sigma_b):
    sig = sigma_b.reshape((-1,) + (1,) * (x.ndim - 1))
    return (x - 0.5 - 0.3 * jnp.tanh(x)) / jnp.maximum(sig, 1e-8)


def t_oracle(x, sigma_b):
    sig = sigma_b.reshape((-1,) + (1,) * (x.ndim - 1))
    return (x - 0.5 - 0.3 * torch.tanh(x)) / torch.clamp(sig, min=1e-8)


def test_heun_with_given_noise_matches_jax():
    shape, steps = (2, 1, 8, 8), 12
    noise = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jedm.heun_sample_loop(jax.random.PRNGKey(0), j_oracle, shape,
                                 num_steps=steps, noise=jnp.asarray(noise))
    got = tedm.heun_sample_loop(t_oracle, shape, num_steps=steps,
                                noise=torch.as_tensor(noise), device="cpu")
    close(got, want)


@pytest.mark.parametrize("s_churn", [0.0, 40.0])
def test_heun_with_replayed_keys_matches_jax(s_churn):
    shape, steps, seed = (1, 1, 4, 4), 10, 3
    kw = dict(num_steps=steps, sigma_max=20.0, s_churn=s_churn, s_tmin=0.05,
              s_tmax=15.0)
    want = jedm.heun_sample_loop(jax.random.PRNGKey(seed), j_oracle, shape, **kw)
    draws = []
    replay = jax_replay(seed, steps)

    def noise_fn(kind, step, shp):
        draws.append(kind)
        return replay(kind, step, shp)

    got = tedm.heun_sample_loop(t_oracle, shape, noise_fn=noise_fn, **kw)
    close(got, want)
    # churn noise is drawn on the steps whose sigma lies in [s_tmin, s_tmax]
    in_range = [0.05 <= s <= 15.0 for s in np.float32(tedm.karras_sigmas(
        steps, 1e-3, 20.0, 7.0))[:-1]]
    assert draws.count("churn") == (sum(in_range) if s_churn else 0)


def test_vp_eps_fn_picks_jax_timesteps():
    jt = jschedule.make_schedule("linear", 1000, "50").tables()
    tt = tschedule.make_schedule("linear", 1000, "50").tables("cpu")
    table = np.sqrt(1 - np.asarray(jt.alphas_cumprod)) / np.sqrt(
        np.asarray(jt.alphas_cumprod))
    # table values, midpoints (ties), the ends and beyond, and Karras sigmas
    mids = (table[1:] + table[:-1]) / 2
    sig = np.concatenate([table, mids, [0.0, 1e-4, 200.0],
                          tedm.karras_sigmas(16)]).astype(np.float32)
    seen = {}

    def jmodel(x, t, y=None):
        seen["j"] = t
        return x

    def tmodel(x, t, y=None):
        seen["t"] = t
        return x

    x = np.ones((len(sig), 1, 2, 2), np.float32)
    want = jedm.vp_eps_fn_from_model(jt, jmodel)(jnp.asarray(x), jnp.asarray(sig))
    got = tedm.vp_eps_fn_from_model(tt, tmodel)(torch.as_tensor(x),
                                                torch.as_tensor(sig))
    np.testing.assert_array_equal(seen["t"].numpy(), np.asarray(seen["j"]))
    close(got, want)


@pytest.mark.parametrize("circle_loss", [False, True])
def test_heun_on_the_dit_matches_jax(circle_loss):
    """A 4-step Heun chain driving the quality_tiny XS DiT in sigma space,
    plain or with the circle-loss worker on a ring of 4 windows."""
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    jt = jschedule.make_schedule("linear", 1000, "100").tables()
    tt = tschedule.make_schedule("linear", 1000, "100").tables("cpu")
    jeps = jedm.vp_eps_fn_from_model(jt, lambda x, t, y=None: jdit.apply(
        fx["dit"], x, t))
    teps = tedm.vp_eps_fn_from_model(tt, lambda x, t, y=None: tdit(x, t))
    if circle_loss:
        jvp, tvp = jeps, teps
        jeps = jc.make_circle_loss_eps_fn(lambda x, s, y=None: jvp(x, s), 64)
        teps = tc.make_circle_loss_eps_fn(lambda x, s, y=None: tvp(x, s), 64)
    shape = (4, 4, 128, 16)
    kw = dict(num_steps=4, sigma_max=10.0)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda k: jedm.heun_sample_loop(
            k, lambda x, s: jeps(x, s), shape, **kw))(jax.random.PRNGKey(7))
    with torch.no_grad():
        got = tedm.heun_sample_loop(lambda x, s: teps(x, s), shape,
                                    noise_fn=jax_replay(7, 4), **kw)
    close(got, want)
