"""Port schedules, Gaussian math and one SCG step against the JAX package.

Inputs come from numpy with fixed seeds; JAX runs on the CPU under
``default_matmul_precision("highest")``, both sides in float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.guidance import guide_schedule_mask as jmask
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import gaussian as tgd
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.diffusion.latent import make_decode_fn

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
TABLE_NAMES = [
    "betas", "log_betas", "alphas_cumprod", "alphas_cumprod_prev",
    "alphas_cumprod_next", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "fixed_large_variance",
    "fixed_large_log_variance", "model_t",
]


@pytest.mark.parametrize("schedule,respacing", [
    ("linear", ""), ("linear", "ddim100"), ("linear", "10"),
    ("cosine", "50,30"), ("linear", "16"),
])
def test_schedule_tables_match_jax(schedule, respacing):
    jt = jschedule.make_schedule(schedule, 1000, respacing).tables()
    tt = tschedule.make_schedule(schedule, 1000, respacing).tables("cpu")
    assert tt.num_timesteps == jt.num_timesteps
    for name in TABLE_NAMES:
        # both are float32 casts of the same float64 host tables; 1e-6
        # relative covers the one rounding in between
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("counts", ["ddim25", "10", "100,20,5", 7])
def test_space_timesteps_matches_jax(counts):
    assert tschedule.space_timesteps(1000, counts) == \
        jschedule.space_timesteps(1000, counts)


@pytest.mark.parametrize("var_type", ["FIXED_LARGE", "FIXED_SMALL", "LEARNED_RANGE"])
def test_p_mean_variance_matches_jax(var_type):
    jt = jschedule.make_schedule("linear", 1000, "ddim50").tables()
    tt = tschedule.make_schedule("linear", 1000, "ddim50").tables("cpu")
    rng = np.random.default_rng(0)
    out_ch = 8 if var_type == "LEARNED_RANGE" else 4
    x = rng.standard_normal((3, 4, 16, 8)).astype(np.float32)
    model_out = rng.standard_normal((3, out_ch, 16, 8)).astype(np.float32)
    model_out[:, 4:] = np.tanh(model_out[:, 4:])
    t = np.array([0, 17, 49])
    jp = jgd.p_mean_variance(jt, jnp.asarray(model_out), jnp.asarray(x),
                             jnp.asarray(t), var_type=jgd.ModelVarType[var_type])
    tp = tgd.p_mean_variance(tt, torch.as_tensor(model_out), torch.as_tensor(x),
                             torch.as_tensor(t), var_type=tgd.ModelVarType[var_type])
    for field in ("mean", "variance", "log_variance", "pred_xstart", "eps"):
        np.testing.assert_allclose(getattr(tp, field).numpy(),
                                   np.asarray(getattr(jp, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_guide_schedule_mask_and_tile_match_jax():
    for t in range(0, 1000, 7):
        for t_start, t_end, interval in [(750, 0, 1), (600, 100, 3), (1000, 10, 2)]:
            assert tsampling.guide_schedule_mask(t, t_start, t_end, interval) == \
                bool(jmask(t, t_start, t_end, interval))
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(tsampling._tile(torch.as_tensor(a), 4).numpy(),
                                  np.asarray(jsampling._tile(jnp.asarray(a), 4)))


def test_yaml_loader_reads_scg_config():
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "configs", "cond_table", "all",
        "scg.yml")
    ns = tconfig.load_config(cfg_path)
    cfg = tconfig.sampler_config_from_yaml(
        ns, rule_names=["pitch_hist", "note_density", "chord_progression"])
    assert cfg.sampler == "ddpm" and cfg.t_end == 0
    assert cfg.guidance.schedule and cfg.guidance.t_start == 750
    assert cfg.scg.num_samples == 16
    assert dict(cfg.scg.weights) == {"pitch_hist": 40.0, "note_density": 1.0,
                                     "chord_progression": 1.0}


def test_yaml_loader_refuses_what_the_port_lacks():
    ns = tconfig.dict_to_obj({"guidance": {"scg": False, "method": "dps"},
                              "sampling": {"sampler": "heun",
                                           "diff_collage": True}})
    with pytest.raises(NotImplementedError,
                       match="outside what the JAX package documents .*sampling.sampler=heun") as err:
        tconfig.sampler_config_from_yaml(ns)
    # DPS and DiffCollage are ported, and so is DPM-Solver++: the sampler
    # alone is refused
    assert str(err.value).split("): ")[-1] == "sampling.sampler=heun"
    ns.sampling.sampler = "dpmpp"
    assert tconfig.sampler_config_from_yaml(ns).sampler == "dpmpp"


@pytest.fixture(scope="module")
def tiny():
    """quality_tiny models in both frameworks + a shared rollout point."""
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tvae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu")
    return dict(
        jmodel=lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
        jdecode=jmake_decode(
            lambda z: jvae.apply(fx["vae"], z, method=JaxVAE.decode), 1.0),
        tmodel=lambda x, t, y=None: tdit(x, t),
        tdecode=make_decode_fn(tvae.decode, 1.0))


RULES = ("pitch_hist", "note_density", "chord_progression")
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0), ("chord_progression", 1.0))


def test_one_scg_step_selects_the_same_candidates(tiny):
    k, b = 4, 2
    jt = jschedule.make_schedule("linear", 1000, "16").tables()
    tt = tschedule.make_schedule("linear", 1000, "16").tables("cpu")
    rolls = make_rolls(b, seed=21)
    jrules = {n: JFUNC[n](jnp.asarray(rolls)) for n in RULES}
    trules = pipeline.extract_targets_from_rolls(RULES, torch.as_tensor(rolls))
    rng = np.random.default_rng(8)
    mean = rng.standard_normal((b, 4, 128, 16)).astype(np.float32)
    g_coeff = np.full((b, 4, 128, 16), 0.5, np.float32)
    t = np.full((b,), 9)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, (k,) + mean.shape))

    jcfg = jsampling.SamplerConfig(
        scg=jsampling.SCGConfig(num_samples=k, weights=WEIGHTS), record=True)
    select = jax.jit(lambda rules, key, mean, g, t: jsampling._scg_select(
        jcfg, jt, tiny["jmodel"], tiny["jdecode"], rules, key, mean, g, t, None))
    with jax.default_matmul_precision("highest"):
        jsel, jrec = select(jrules, key, jnp.asarray(mean), jnp.asarray(g_coeff),
                            jnp.asarray(t))
    jlp = np.asarray(jrec["candidate_log_prob"])
    # the port decodes in 2 groups (decode_chunks), JAX in one
    tcfg = tconfig.SamplerConfig(
        scg=tconfig.SCGConfig(num_samples=k, weights=WEIGHTS,
                              decode_chunks=2), record=True)
    with torch.no_grad():
        tsel, trec = tsampling._scg_select(
            tcfg, tt, tiny["tmodel"], tiny["tdecode"], trules,
            torch.as_tensor(noise), torch.as_tensor(mean),
            torch.as_tensor(g_coeff), torch.as_tensor(t), None)
    tlp = trec["candidate_log_prob"].numpy()
    np.testing.assert_array_equal(tlp.argmax(0), jlp.argmax(0))
    # rule losses of decoded rolls: fp32 decode differences (~1e-5)
    # move a histogram entry by far less than 1e-4
    np.testing.assert_allclose(tlp, jlp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tsel.numpy(), np.asarray(jsel),
                               rtol=1e-6, atol=1e-6)
    for name in ("log_prob", "loss_std", "loss_range"):
        np.testing.assert_allclose(trec[name].numpy(), np.asarray(jrec[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
