"""The port's training half against the JAX package on shared numpy inputs
(CPU): the Gaussian training terms, the timestep samplers, the logger's
files, ``get_kl_input`` on the committed fixture, and the models' train
mode.

Tolerances: the Gaussian terms run in float64 in both frameworks (JAX
under ``jax.enable_x64``; the schedule tables are float32 in both, as the
packages store them) and are held within 1e-6; ``q_sample`` also in
float32, within 1e-5. float32 is not enough for the likelihood terms:
the discretized likelihood takes the log of a difference of two CDF
values near 1, which turns XLA's and PyTorch's last-ulp differences in
``tanh`` into relative differences up to 5e-4. The samplers are numpy on one generator in
both and must agree exactly; the logger's files must be equal byte for
byte; ``get_kl_input`` goes through ~20 fp32 convolutions of the fixture's
VAE and is held to the port's model tolerance (1e-4, as
tests/test_torch_models.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.training import resample as jresample
from rule_guided_music_tpu.training.train_loop import get_kl_input as jget_kl_input
from rule_guided_music_tpu.utils import logger as jlogger
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import gaussian as tgd
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.training import resample as tresample
from rule_guided_music_tpu_torch.training.train_loop import get_kl_input
from rule_guided_music_tpu_torch.utils import logger as tlogger

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
TOL = dict(rtol=1e-6, atol=1e-6)
TOL32 = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MEAN_TYPES = ["EPSILON", "START_X", "PREVIOUS_X"]
VAR_TYPES = ["FIXED_LARGE", "FIXED_SMALL", "LEARNED", "LEARNED_RANGE"]
LOSS_TYPES = ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"]


def _tables(respacing="10"):
    return (jschedule.make_schedule("linear", 1000, respacing).tables(),
            tschedule.make_schedule("linear", 1000, respacing).tables("cpu"))


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _inputs(seed, shape=(4, 4, 8, 8), steps=10, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal(shape) * 0.6, -1, 1).astype(dtype)
    noise = rng.standard_normal(shape).astype(dtype)
    t = np.array([0, 3, steps - 1, 5][:shape[0]], np.int32)
    return x0, noise, t


def _jmodel(learned):
    """A fixed denoiser of x_t and the conditioning t in JAX."""
    def fn(x, model_t, **kw):
        out = 0.3 * x + 1e-3 * model_t[:, None, None, None]
        return jnp.concatenate([out, jnp.tanh(x)], axis=1) if learned else out
    return fn


def _tmodel(learned):
    def fn(x, model_t, **kw):
        out = 0.3 * x + 1e-3 * model_t[:, None, None, None]
        return torch.cat([out, torch.tanh(x)], dim=1) if learned else out
    return fn


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_q_moments_and_sample_match_jax(dtype):
    tol = TOL32 if dtype == np.float32 else TOL
    with jax.enable_x64(dtype == np.float64):
        jt, tt = _tables()
        x0, noise, t = _inputs(0, dtype=dtype)
        for jout, tout in zip(jgd.q_mean_variance(jt, jnp.asarray(x0), jnp.asarray(t)),
                              tgd.q_mean_variance(tt, torch.as_tensor(x0),
                                                  torch.as_tensor(t).long())):
            _close(tout, jout, tol)
        got = tgd.q_sample(tt, torch.as_tensor(x0), torch.as_tensor(t).long(),
                           torch.as_tensor(noise))
        assert got.dtype == torch.as_tensor(x0).dtype
        _close(got, jgd.q_sample(jt, jnp.asarray(x0), jnp.asarray(t),
                                 jnp.asarray(noise)), tol)


def test_likelihood_helpers_match_jax(x64):
    rng = np.random.default_rng(1)
    m1, m2, lv1, lv2 = (rng.standard_normal((3, 4, 5)) for _ in range(4))
    x = np.clip(rng.standard_normal((3, 4, 5)), -1, 1)
    x[0, 0, :2] = [-1.0, 1.0]                 # both edge bins
    J, T = jnp.asarray, torch.as_tensor
    _close(tgd.normal_kl(T(m1), T(lv1), T(m2), T(lv2)),
           jgd.normal_kl(J(m1), J(lv1), J(m2), J(lv2)))
    _close(tgd.normal_kl(T(m1), T(lv1), 0.0, 0.0), jgd.normal_kl(J(m1), J(lv1), 0.0, 0.0))
    _close(tgd.approx_standard_normal_cdf(T(m1)), jgd.approx_standard_normal_cdf(J(m1)))
    _close(tgd.discretized_gaussian_log_likelihood(T(x), means=T(m1) * 0.1,
                                                   log_scales=T(lv1) - 2.0),
           jgd.discretized_gaussian_log_likelihood(J(x), means=J(m1) * 0.1,
                                                   log_scales=J(lv1) - 2.0))
    _close(tgd.mean_flat(T(m1)), jgd.mean_flat(J(m1)))


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_vb_terms_bpd_matches_jax(mean_type, var_type, x64):
    jt, tt = _tables()
    x0, noise, t = _inputs(2)
    learned = var_type.startswith("LEARNED")
    jx_t = jgd.q_sample(jt, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    tx_t = tgd.q_sample(tt, torch.as_tensor(x0), torch.as_tensor(t).long(),
                        torch.as_tensor(noise))
    jout = _jmodel(learned)(jx_t, jt.model_t[jnp.asarray(t)])
    tout = _tmodel(learned)(tx_t, tt.model_t[torch.as_tensor(t).long()])
    want = jgd.vb_terms_bpd(jt, jout, jnp.asarray(x0), jx_t, jnp.asarray(t),
                            mean_type=getattr(jgd.ModelMeanType, mean_type),
                            var_type=getattr(jgd.ModelVarType, var_type))
    got = tgd.vb_terms_bpd(tt, tout, torch.as_tensor(x0), tx_t,
                           torch.as_tensor(t).long(),
                           mean_type=getattr(tgd.ModelMeanType, mean_type),
                           var_type=getattr(tgd.ModelVarType, var_type))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_training_losses_match_jax(mean_type, var_type, loss_type, x64):
    """Every mean, variance and loss type of ``training_losses``; where the
    variance is learned, the mean's gradient is stopped in both."""
    jt, tt = _tables()
    x0, noise, t = _inputs(3)
    learned = var_type.startswith("LEARNED")
    kw = lambda gd: dict(mean_type=getattr(gd.ModelMeanType, mean_type),
                         var_type=getattr(gd.ModelVarType, var_type),
                         loss_type=getattr(gd.LossType, loss_type))
    want = jgd.training_losses(jt, _jmodel(learned), jnp.asarray(x0),
                               jnp.asarray(t), jnp.asarray(noise), **kw(jgd))
    got = tgd.training_losses(tt, _tmodel(learned), torch.as_tensor(x0),
                              torch.as_tensor(t).long(), torch.as_tensor(noise),
                              **kw(tgd))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])


def test_training_losses_stop_the_mean_gradient():
    """With a learned variance the VLB term trains the variance channels
    only: d vb / d eps-channels is 0 in the port as in JAX."""
    _, tt = _tables()
    x0, noise, t = _inputs(4)
    out = torch.randn((4, 8, 8, 8), dtype=torch.float64, requires_grad=True)
    terms = tgd.training_losses(tt, lambda x, mt: out, torch.as_tensor(x0),
                                torch.as_tensor(t).long(), torch.as_tensor(noise),
                                var_type=tgd.ModelVarType.LEARNED_RANGE,
                                loss_type=tgd.LossType.RESCALED_MSE)
    grad = torch.autograd.grad(terms["vb"].sum(), out)[0]
    assert torch.all(grad[:, :4] == 0) and grad[:, 4:].abs().sum() > 0


def test_prior_and_calc_bpd_loop_match_jax(x64):
    """The whole VLB over a 10-step chain; the port's noise_fn replays the
    JAX loop's per-step draws."""
    jt, tt = _tables()
    x0, _, _ = _inputs(5)
    _close(tgd.prior_bpd(tt, torch.as_tensor(x0)), jgd.prior_bpd(jt, jnp.asarray(x0)))
    key = jax.random.PRNGKey(7)
    draws, k = {}, key
    for t in range(jt.num_timesteps - 1, -1, -1):
        k, sub = jax.random.split(k)
        draws[t] = torch.as_tensor(np.array(jax.random.normal(sub, x0.shape)))
    want = jgd.calc_bpd_loop(jt, _jmodel(True), jnp.asarray(x0), key,
                             var_type=jgd.ModelVarType.LEARNED_RANGE)
    got = tgd.calc_bpd_loop(tt, _tmodel(True), torch.as_tensor(x0), draws.__getitem__,
                            var_type=tgd.ModelVarType.LEARNED_RANGE)
    assert sorted(got) == sorted(want)
    for key_ in want:
        _close(got[key_], want[key_])


# -- samplers --------------------------------------------------------------


def test_uniform_sampler_draws_as_jax():
    for name in ("uniform", "loss-second-moment"):
        js = jresample.create_named_schedule_sampler(name, 1000)
        ts = tresample.create_named_schedule_sampler(name, 1000)
        assert type(ts).__name__ == type(js).__name__
        jr, tr = np.random.default_rng(3), np.random.default_rng(3)
        for b in (1, 8, 32):
            jt_, jw = js.sample(b, jr)
            tt_, tw = ts.sample(b, tr)
            np.testing.assert_array_equal(tt_, jt_)
            np.testing.assert_array_equal(tw, jw)
    with pytest.raises(NotImplementedError):
        tresample.create_named_schedule_sampler("bogus", 10)


def test_loss_second_moment_history_and_draws_as_jax():
    """The same (t, loss) history, repeated t within a batch included,
    through warm-up: equal ring buffers, weights and draws."""
    n = 20
    js = jresample.LossSecondMomentResampler(n, history_per_term=4)
    ts = tresample.LossSecondMomentResampler(n, history_per_term=4)
    feed = np.random.default_rng(4)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for step in range(40):
        t = feed.integers(0, n, size=12)
        loss = feed.random(12) * (1 + t / n)
        js.update_with_all_losses(t, loss)
        ts.update_with_all_losses(t, loss)
        np.testing.assert_array_equal(ts._loss_history, js._loss_history)
        np.testing.assert_array_equal(ts._loss_counts, js._loss_counts)
        assert ts._warmed_up() == js._warmed_up()
        np.testing.assert_array_equal(ts.weights(), js.weights())
        for a, b in zip(ts.sample(16, tr), js.sample(16, jr)):
            np.testing.assert_array_equal(a, b)
    assert ts._warmed_up()


# -- logger ----------------------------------------------------------------


def _log_run(mod, run_dir):
    mod.configure(dir=str(run_dir), format_strs=["log", "csv", "json"])
    mod.log("hello", 3)
    for step in range(3):
        mod.logkv("step", step)
        mod.logkv("grad_norm", 0.5 + step)
        for v in (1.0, 2.0, 4.5):
            mod.logkv_mean("loss", v * (step + 1))
        if step == 1:
            mod.logkvs({"eval_loss": 0.25, "a_long_key_name_to_truncate_in_the_table": 1})
        mod.dumpkvs()
    mod.warn("careful")
    assert mod.get_dir() == str(run_dir)
    mod.get_current().close()
    mod.Logger.CURRENT = None


def test_logger_files_equal_jax(tmp_path):
    """log.txt, progress.csv and progress.json of the same keys, byte for
    byte (log.txt after its 'Logging to <dir>' line)."""
    _log_run(jlogger, tmp_path / "jax")
    _log_run(tlogger, tmp_path / "port")
    for name in ("log.txt", "progress.csv", "progress.json"):
        want = (tmp_path / "jax" / name).read_text()
        got = (tmp_path / "port" / name).read_text()
        assert got.replace(str(tmp_path / "port"), "D") == \
            want.replace(str(tmp_path / "jax"), "D"), name
    assert "step" in (tmp_path / "port" / "progress.csv").read_text().splitlines()[0]


def test_logger_run_dir_and_optional_sinks(tmp_path, monkeypatch, capsys):
    """``--dir`` names loggings/<dir>; wandb falls back to stdout with
    JAX's message; TensorBoard behaves as in JAX (its import fails where
    the package is missing)."""
    monkeypatch.chdir(tmp_path)

    class Args:
        dir = "run1"

    tlogger.configure(args=Args(), format_strs=["csv"])
    assert tlogger.get_dir() == os.path.join("loggings", "run1")
    assert os.path.exists(os.path.join("loggings", "run1", "progress.csv"))
    fmt = tlogger.make_output_format("wandb", str(tmp_path / "w"))
    assert isinstance(fmt, tlogger.HumanOutputFormat)
    assert "wandb not installed; falling back to stdout sink" in capsys.readouterr().err
    outcomes = []
    for mod in (jlogger, tlogger):
        try:
            mod.make_output_format("tensorboard", str(tmp_path / mod.__name__)).close()
            outcomes.append("ok")
        except Exception as e:
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        tlogger.make_output_format("bogus", str(tmp_path))
    tlogger.Logger.CURRENT = None


def test_torch_trace_times_a_block(tmp_path):
    """The profile_step trace: a Chrome trace file and the block's wall
    time; on the CPU no device event, so no idle share."""
    tlogger.configure(dir=str(tmp_path), format_strs=[])
    with tlogger.torch_trace() as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.exists(trace.path) and trace.wall_ms > 0
    assert trace.events == 0 and np.isnan(trace.idle_share)
    tlogger.Logger.CURRENT = None


# -- get_kl_input ----------------------------------------------------------


@pytest.mark.parametrize("recombine", [True, False])
def test_get_kl_input_matches_jax_on_fixture(recombine):
    """The fixture VAE's encoder on 12 chunks of each of 2 rolls: the chunk
    order, the posterior mode, the shifted windows and scale_factor."""
    tree = load_fixture_npz(FIXTURE)
    rolls = make_rolls(2, length=1536, seed=8)
    jvae = JaxVAE(**TINY_VAE)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jget_kl_input(
            lambda c: jvae.apply(tree["vae"], c, method=JaxVAE.encode_moments),
            jnp.asarray(rolls), scale_factor=1.2465, shift_size=4,
            recombine=recombine))
    vae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, encoder=True,
                              dtype=torch.float32, device="cpu")
    got = get_kl_input(vae.encode_moments, torch.as_tensor(rolls),
                       scale_factor=1.2465, shift_size=4, recombine=recombine)
    assert got.shape == want.shape == ((4, 4, 128, 16) if recombine
                                       else (2, 4, 192, 16))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


# -- train mode of the models ----------------------------------------------


def _old_dit_forward(model, x, t, y):
    """DiTRotary.forward as it was before train mode (inference)."""
    dtype = model.final_layer.linear.weight.dtype
    b, _, h, w = x.shape
    tokens = model.x_embedder(x.to(dtype))
    c = model.t_embedder(t)
    if model.y_embedder is not None and y is not None:
        c = c + model.y_embedder.embedding_table(y.long())
    rotary = model.rotary_table(h * w // model.patch_size, x.device)
    for block in model.blocks:
        tokens = block(tokens, c, rotary)
    out = model.final_layer(tokens, c).reshape(b, -1, w, model.out_channels)
    return out.permute(0, 3, 1, 2).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_forward_is_unchanged(dtype):
    """train=False (the default) gives bit-identical outputs to the
    pre-training forward, in fp32 and bf16; train=True with no label
    dropped equals it too, and a dropped label takes the null row."""
    torch.manual_seed(0)
    model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    pipeline.randomize_(model, seed=2)
    model = model.to(dtype).eval()
    x = torch.randn(3, 4, 128, 16)
    t = torch.tensor([1.0, 500.0, 999.0])
    y = torch.tensor([0, 2, 1])
    with torch.no_grad():
        want = _old_dit_forward(model, x, t, y)
        assert torch.equal(model(x, t, y), want)
        none = torch.zeros(3, dtype=torch.bool)
        assert torch.equal(model(x, t, y, train=True, drop=none), want)
        emb = model.y_embedder
        assert torch.equal(emb(y), emb.embedding_table(y))
        dropped = emb(y, train=True, drop=torch.tensor([True, False, True]))
        assert torch.equal(dropped[0], emb.embedding_table.weight[3])
        assert torch.equal(dropped[1], emb.embedding_table.weight[2])
        gen = torch.Generator().manual_seed(0)
        draws = torch.stack([emb(torch.zeros(4000, dtype=torch.long), train=True,
                                 generator=gen)[:, 0] for _ in range(1)])[0]
        share = (draws == emb.embedding_table.weight[3, 0]).float().mean().item()
        assert abs(share - 0.1) < 0.02


def test_remat_gives_the_same_gradients():
    """remat=True (torch.utils.checkpoint per block) changes memory, not
    the result: the same output and the same gradients."""
    torch.manual_seed(1)
    a = DiT_models["DiTRotary_XS_8"](num_classes=3)
    pipeline.randomize_(a, seed=3)
    b = DiT_models["DiTRotary_XS_8"](num_classes=3, remat=True)
    b.load_state_dict(a.state_dict())
    x, t, y = torch.randn(2, 4, 128, 16), torch.tensor([3.0, 700.0]), torch.tensor([1, 2])
    grads = []
    for m in (a, b):
        out = m(x, t, y, train=True, drop=torch.tensor([False, True]))
        grads.append(torch.autograd.grad(out.square().sum(), list(m.parameters())))
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-7)
