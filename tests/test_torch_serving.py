"""The serving stack of the port on the CPU, against the JAX package: the
rule-feature head, the scoring decoder, the B_8 rollout entry, the
DPM-Solver++ 2M/SDE steps, trajectory reuse, prefilter re-ranking (with a forced tie), the memory preflight, the loader and the
CLI on the three ``scripts/configs_serving`` YAMLs.

Inputs and weights are the same numpy arrays on both sides; the chains
replay the JAX sampler's key splits through ``noise_fn``. Tolerances are
stated where they are used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import memory as jmemory
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jdecode_fn
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models import RuleFeatureHead as JaxHead
from rule_guided_music_tpu.models import ScoringDecoder as JaxScoringDecoder
from rule_guided_music_tpu.pipeline import make_sample_fn as jmake_sample_fn
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls, unflatten_tree
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline, sample_rule
from rule_guided_music_tpu_torch.diffusion import memory
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.models.scoring_head import RuleFeatureHead
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL, ScoringDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
GATE = os.path.join(REPO, "tests", "fixtures", "light_gate_tiny.npz")
DEC_ASSET = os.path.join(REPO, "assets", "scoring_decoder_ch64.npz")
FEAT_ASSET = os.path.join(REPO, "assets", "scoring_features_ch64.npz")
SERVING = os.path.join(REPO, "scripts", "configs_serving")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
LIGHT_DEC = dict(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
HEAD = dict(ch=16, depth=2)
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0),
           ("chord_progression", 1.0))
RULES = tuple(n for n, _ in WEIGHTS)
SHAPE = (2, 4, 128, 16)
# fp32 module parity: summation order of convs and matmuls (~1e-6 of the
# values) and XLA's CPU convolution algorithms; the head's softmax and
# softplus outputs are O(1)
MODULE_TOL = 1e-4
# fp32 chains on the tiny DiT: the models' ~1e-6 differences, carried by
# the 1/sqrt(alpha) factors of x0 through a few steps
CHAIN_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on one machine; torch's default of a
    thread per core makes the conv-heavy chains here contend badly there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def gate_part(name):
    data = np.load(GATE)
    return {k[len(name) + 1:]: data[k] for k in data.files
            if k.startswith(name + "/")}


def replay_noise(key):
    """noise_fn drawing what ``sample_loop(key, ...)`` draws."""
    rng, init_rng = jax.random.split(key)
    keys = []

    def noise_fn(kind, step, shape):
        nonlocal rng
        while len(keys) <= step:
            rng, noise_rng, scg_rng = jax.random.split(rng, 3)
            keys.append({"step": noise_rng, "scg": scg_rng})
        k = init_rng if kind == "init" else keys[step][kind]
        return torch.as_tensor(np.array(jax.random.normal(k, shape)))

    return noise_fn


@pytest.fixture(scope="module")
def tiny():
    fx = load_fixture_npz(QUALITY)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=QUALITY, dtype=torch.float32,
                                    device="cpu")
    return dict(fx=fx, jmodel=lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
                tdit=tdit)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("source", ["fixture", "asset"])
def test_feature_head_matches_jax(source):
    if source == "fixture":
        flat, arch = gate_part("feathead"), HEAD
    else:
        flat, arch = {k: v for k, v in np.load(FEAT_ASSET).items() if "/" in k}, {}
    jhead = JaxHead(**arch)
    jparams = unflatten_tree({k: np.asarray(v, np.float32) for k, v in flat.items()})
    thead = RuleFeatureHead(**arch)
    thead.load_state_dict(pipeline.convert.feature_head_state_dict(flat))
    z = np.random.default_rng(3).standard_normal((3, 4, 128, 16)).astype(np.float32)
    jout = jhead.apply(jparams, jnp.asarray(z))
    jfeat = jhead.apply(jparams, jnp.asarray(z), method=JaxHead.features)
    with torch.no_grad():
        tout = thead(torch.as_tensor(z))
        tfeat = thead.features(torch.as_tensor(z))
    for name in ("pitch_hist", "note_density", "chord_logits"):
        assert tout[name].shape == jout[name].shape
        np.testing.assert_allclose(tout[name].numpy(), np.asarray(jout[name]),
                                   rtol=0, atol=MODULE_TOL, err_msg=name)
    np.testing.assert_array_equal(tfeat["chord_progression"].numpy(),
                                  np.asarray(jfeat["chord_progression"]))
    assert tfeat["chord_progression"].dtype == torch.int32


def test_feature_head_pools_the_jax_windows():
    """The NCHW window pool takes the elements of JAX's NHWC
    (B, w, 16, P, ch) pool: a marker in one window's cells moves only that
    window's feature."""
    head = RuleFeatureHead(ch=4, depth=1, in_channels=4)
    with torch.no_grad():
        for p in head.parameters():
            p.zero_()
        head.conv0.weight[:, :, 1, 1] = torch.eye(4)       # identity conv
        head.win_fc.weight.copy_(torch.eye(4))
        head.nd_head.weight[0, 0] = 1.0
        z = torch.zeros(1, 4, 64, 16)
        z[0, 0, 16:32] = 1.0                               # window 1
        nd = head(z)["note_density"][0, :4]
    assert nd.argmax().item() == 1 and torch.allclose(nd[[0, 2, 3]], nd[0])


@pytest.mark.parametrize("source", ["fixture", "asset"])
def test_scoring_decoder_matches_jax(source):
    if source == "fixture":
        flat, arch = gate_part("decoder"), LIGHT_DEC
    else:
        flat, arch = {k: v for k, v in np.load(DEC_ASSET).items() if "/" in k}, {}
    jdec = JaxScoringDecoder(**arch)
    jparams = unflatten_tree({k: np.asarray(v, np.float32) for k, v in flat.items()})
    tdec = ScoringDecoder(**arch)
    tdec.load_state_dict(pipeline.convert.vae_state_dict(flat))
    z = np.random.default_rng(4).standard_normal((2, 4, 16, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdec.apply(jparams, jnp.asarray(z),
                                     method=JaxScoringDecoder.decode))
    with torch.no_grad():
        got = tdec.decode(torch.as_tensor(z)).numpy()
    assert got.shape == want.shape == (2, 3, 128, 128)
    # decoder outputs are O(1); fp32 conv summation order through ~30 convs
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL * 10)


@pytest.mark.parametrize("part,source", [("decoder", "fixture"),
                                         ("decoder", "asset"),
                                         ("feathead", "fixture"),
                                         ("feathead", "asset")])
def test_scoring_geometry_read_from_npz(part, source):
    """ScoringBundle.create reads each model's geometry from its tree: the
    fixture's ch=16 decoder and depth-2 head, the assets' ch=64 defaults;
    the loaded module takes every tensor of the tree (strict load)."""
    path = GATE if source == "fixture" else (DEC_ASSET if part == "decoder"
                                             else FEAT_ASSET)
    flat, _ = pipeline._load_scoring_npz(path, part)
    if part == "decoder":
        arch = pipeline.convert.scoring_decoder_arch(flat)
        want = LIGHT_DEC if source == "fixture" else {}
        assert arch == {**dict(ch=64, ch_mult=(1, 2, 2, 4), num_res_blocks=2,
                               out_ch=3, z_channels=4), **want}
        bundle = pipeline.ScoringBundle.create(decoder_path=path,
                                               dtype=torch.float32, device="cpu")
        assert bundle.decoder.ch == arch["ch"]
    else:
        arch = pipeline.convert.feature_head_arch(flat)
        want = HEAD if source == "fixture" else {}
        assert arch == {**dict(ch=64, depth=4, in_channels=4, n_chord_tags=8),
                        **want}
        bundle = pipeline.ScoringBundle.create(features_path=path,
                                               dtype=torch.float32, device="cpu")
        assert (bundle.feature_head.ch, bundle.feature_head.depth) == (
            arch["ch"], arch["depth"])


def test_b8_registry_entries_match_jax():
    for name in ("DiTRotary_B_8", "DiTRotary_B_16", "DiTRotary_XL_16"):
        jm = JaxDiT[name](input_size=(128, 16), in_channels=4, num_classes=3)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 128, 16)), jnp.zeros((1,)),
                                jnp.zeros((1,), jnp.int32))
        jcount = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
        with torch.device("meta"):
            tm = DiT_models[name](input_size=(128, 16), in_channels=4,
                                  num_classes=3)
        assert sum(p.numel() for p in tm.parameters()) == jcount, name
    b8 = DiT_models["DiTRotary_B_8"]
    with torch.device("meta"):
        m = b8(num_classes=3)
    assert (len(m.blocks), m.hidden_size, m.num_heads, m.patch_size) == (12, 768, 12, 8)
    small = b8(num_classes=0)
    out = small(torch.zeros(1, 4, 128, 16), torch.zeros(1))
    assert out.shape == (1, 4, 128, 16)


# ---------------------------------------------------------------- sampler

def chains(tiny, jcfg, tcfg, steps, seed, **jkw):
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    run = jax.jit(lambda key: jsampling.sample_loop(
        key, tiny["jmodel"], SHAPE, jt, jcfg, **jkw))
    with jax.default_matmul_precision("highest"):
        jx, jrec = run(jax.random.PRNGKey(seed))
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    calls = []

    def model_fn(x, t, y=None):
        calls.append(int(t[0]))
        return tiny["tdit"](x, t)

    with torch.no_grad():
        tx, trec = tsampling.sample_loop(model_fn, SHAPE, tt, tcfg,
                                         noise_fn=replay_noise(jax.random.PRNGKey(seed)))
    return np.asarray(jx), tx.numpy(), calls


@pytest.mark.parametrize("sde", [False, True])
def test_dpmpp_2m_chain_matches_jax(tiny, sde):
    jcfg = jsampling.SamplerConfig(sampler="dpmpp", dpmpp_sde=sde)
    tcfg = tconfig.SamplerConfig(sampler="dpmpp", dpmpp_sde=sde)
    jx, tx, calls = chains(tiny, jcfg, tcfg, 6, seed=2)
    assert len(calls) == 6
    np.testing.assert_allclose(tx, jx, rtol=0, atol=CHAIN_TOL)


def test_dpmpp_first_and_last_steps_are_order_1(tiny):
    """On two steps (the first has no history, the last is the final step)
    the 2M chain is the order-1 chain; on three, the middle step differs.
    Both against JAX at order 2."""
    out = {}
    for steps in (2, 3):
        for order in (1, 2):
            jcfg = jsampling.SamplerConfig(sampler="dpmpp", dpmpp_order=order)
            tcfg = tconfig.SamplerConfig(sampler="dpmpp", dpmpp_order=order)
            jx, tx, _ = chains(tiny, jcfg, tcfg, steps, seed=3)
            np.testing.assert_allclose(tx, jx, rtol=0, atol=CHAIN_TOL)
            out[steps, order] = tx
    np.testing.assert_array_equal(out[2, 1], out[2, 2])
    assert np.abs(out[3, 1] - out[3, 2]).max() > 1e-3


def test_dpmpp_ode_draws_no_noise():
    drawn = []

    def noise_fn(kind, step, shape):
        drawn.append(kind)
        return torch.zeros(shape)

    tt = tschedule.make_schedule("linear", 1000, "4").tables("cpu")
    tsampling.sample_loop(lambda x, t, y: 0.1 * x, (1, 4, 16, 16), tt,
                          tconfig.SamplerConfig(sampler="dpmpp"),
                          noise_fn=noise_fn)
    assert drawn == ["init"]


@pytest.mark.parametrize("t_max", [-1, 5])
def test_reuse_chain_matches_jax(tiny, t_max):
    """DDIM-8 with reuse every second step: the model runs on the refresh
    steps only (every second position, and every step index t >=
    reuse_t_max: t counts the respaced chain's steps), and the chain
    matches JAX's."""
    jcfg = jsampling.SamplerConfig(sampler="ddim", reuse_interval=2,
                                   reuse_t_max=t_max)
    tcfg = tconfig.SamplerConfig(sampler="ddim", reuse_interval=2,
                                 reuse_t_max=t_max)
    jx, tx, calls = chains(tiny, jcfg, tcfg, 8, seed=4)
    tt = tschedule.make_schedule("linear", 1000, "8").tables("cpu")
    want = [int(tt.model_t[t]) for pos, t in enumerate(range(7, -1, -1))
            if pos % 2 == 0 or (t_max >= 0 and t >= t_max)]
    assert calls == want
    assert len(calls) == (4 if t_max < 0 else 5)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=CHAIN_TOL)


def test_sampler_refusals():
    tt = tschedule.make_schedule("linear", 1000, "4").tables("cpu")
    scg = tconfig.SCGConfig(num_samples=2)
    cases = [
        (tconfig.SamplerConfig(sampler="heun"), "unknown sampler"),
        (tconfig.SamplerConfig(sampler="dpmpp", scg=scg), "stochastic"),
        (tconfig.SamplerConfig(sampler="ddim", dpmpp_sde=True), "dpmpp_sde"),
        (tconfig.SamplerConfig(sampler="dpmpp", dpmpp_order=3), "dpmpp_order"),
    ]
    for cfg, match in cases:
        with pytest.raises(ValueError, match=match):
            tsampling.sample_loop(lambda x, t, y: x, (1, 4, 16, 16), tt, cfg,
                                  noise_fn=tsampling.torch_noise_fn(None, "cpu"))
    # what JAX accepts of these fields, the port accepts too
    tsampling.sample_loop(lambda x, t, y: x, (1, 4, 16, 16), tt,
                          tconfig.SamplerConfig(sampler="dpmpp", dpmpp_order=1,
                                                reuse_interval=2),
                          noise_fn=tsampling.torch_noise_fn(None, "cpu"))


def test_top_m_breaks_ties_as_jax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 3, size=(16, 5)).astype(np.float32)   # many ties
    scores[:, 4] = 1.0                                             # all tied
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores.T), 4)[1]).T
    got = tsampling.top_m_indices(torch.as_tensor(scores), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:, 4]) == [0, 1, 2, 3]


def test_prefilter_chain_with_forced_tie_matches_jax(tiny):
    """A prefilter chain whose head scores every candidate the same (a
    constant feature head): the top m are the first m in both frameworks,
    then the decoder re-ranks them. Same selections, latents and record."""
    fx = tiny["fx"]
    jvae = JaxVAE(**TINY_VAE)
    jdecode = jdecode_fn(lambda c: jvae.apply(fx["vae"], c, method=JaxVAE.decode), 1.0)
    tvae = pipeline.create_vae(QUALITY, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu")
    rolls = make_rolls(2, seed=8)
    jrules = {n: JFUNC[n](jnp.asarray(rolls)) for n in RULES}
    trules = pipeline.extract_targets_from_rolls(RULES, torch.as_tensor(rolls))

    def jfeat(z):
        n = z.shape[0]
        return {"pitch_hist": jnp.full((n, 12), 1 / 12),
                "note_density": jnp.ones((n, 16)),
                "chord_progression": jnp.zeros((n, 8), jnp.int32)}

    def tfeat(z):
        n = z.shape[0]
        return {"pitch_hist": torch.full((n, 12), 1 / 12),
                "note_density": torch.ones((n, 16)),
                "chord_progression": torch.zeros((n, 8), dtype=torch.int32)}

    k, m, steps = 4, 2, 4
    kw = dict(guidance=None, scg=None, record=True)
    jcfg = jsampling.SamplerConfig(**dict(
        kw, guidance=jsampling.GuidanceConfig(schedule=True, t_start=steps),
        scg=jsampling.SCGConfig(num_samples=k, weights=WEIGHTS, prefilter=m)))
    tcfg = tconfig.SamplerConfig(**dict(
        kw, guidance=tconfig.GuidanceConfig(schedule=True, t_start=steps),
        scg=tconfig.SCGConfig(num_samples=k, weights=WEIGHTS, prefilter=m)))
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    with jax.default_matmul_precision("highest"):
        jx, jrec = jax.jit(lambda key: jsampling.sample_loop(
            key, tiny["jmodel"], SHAPE, jt, jcfg, rules=jrules,
            decode_fn=jdecode, scoring_feature_fn=jfeat))(jax.random.PRNGKey(9))
    with torch.no_grad():
        tx, trec = tsampling.sample_loop(
            lambda x, t, y: tiny["tdit"](x, t), SHAPE, tt, tcfg,
            noise_fn=replay_noise(jax.random.PRNGKey(9)), rules=trules,
            decode_fn=pipeline.make_decode_fn(tvae.decode, 1.0),
            scoring_feature_fn=tfeat)
    sel = trec["selected"].numpy()
    assert ((sel[:-1] >= 0) & (sel[:-1] < m)).all() and (sel[-1] == -1).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=CHAIN_TOL)
    for name in ("log_prob", "loss_std", "loss_range", "candidate_log_prob",
                 "loss/pitch_hist", "loss/note_density", "loss/chord_progression"):
        np.testing.assert_allclose(trec[name].numpy(), np.asarray(jrec[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- memory

PREFLIGHT_CASES = [
    dict(gen_shape=(2, 4, 128, 16), k=16, decode_chunks=1,
         param_count=700_000_000, hidden=1152),
    dict(gen_shape=(8, 4, 128, 16), k=16, decode_chunks=4,
         param_count=800_000_000, hidden=768, decoder_ch=64, compute_bytes=4),
    dict(gen_shape=(2, 4, 128, 16), k=16, decode_chunks=3,
         param_count=10_000, hidden=64, use_decode=False),
]


@pytest.mark.parametrize("case", PREFLIGHT_CASES)
def test_memory_estimate_matches_jax(case):
    assert memory.estimate_scg_peak_bytes(**case) == \
        jmemory.estimate_scg_peak_bytes(**case)
    assert memory.dit_param_count(1152, 28) == jmemory.dit_param_count(1152, 28)
    assert memory.vae_param_count(64) == jmemory.vae_param_count(64)


def test_preflight_error_matches_jax(monkeypatch):
    case = PREFLIGHT_CASES[1]
    with pytest.raises(jmemory.HBMPreflightError) as jerr:
        jmemory.preflight_scg(**case, limit_bytes=10**9)
    with pytest.raises(memory.HBMPreflightError) as terr:
        memory.preflight_scg(**case, limit_bytes=10**9)
    head = lambda e: str(e.value).split(" Reduce")[0]
    assert head(terr) == head(jerr)
    assert memory.preflight_scg(**case)["total"] > 10**9   # CPU: no limit
    monkeypatch.setenv("RGM_HBM_BYTES", "1e9")
    with pytest.raises(memory.HBMPreflightError):
        memory.preflight_scg(**case)
    monkeypatch.setenv("RGM_SKIP_HBM_PREFLIGHT", "1")
    memory.preflight_scg(**case)


def test_pipeline_preflight_counts_models_as_jax(monkeypatch):
    """pipeline.preflight at the serving geometry (XL_8 + production VAE +
    ch=64 scoring decoder + head + B_8 rollout, bf16, k=16, B=2) raises
    with the total the JAX package's make_sample_fn computes."""
    monkeypatch.setenv("RGM_HBM_BYTES", "1e6")
    scg = dict(num_samples=16, weights=WEIGHTS, prefilter=4)
    jcfg = jsampling.SamplerConfig(scg=jsampling.SCGConfig(**scg))
    tcfg = tconfig.SamplerConfig(scg=tconfig.SCGConfig(**scg))
    with pytest.raises(jmemory.HBMPreflightError) as jerr:
        jmake_sample_fn(
            denoiser_model=JaxDiT["DiTRotary_XL_8"](dtype=jnp.bfloat16),
            tables=None, sampler_config=jcfg, gen_shape=SHAPE,
            vae_model=JaxVAE(), scoring_vae_model=JaxScoringDecoder(ch=64),
            scoring_feature_model=JaxHead(),
            scoring_denoiser_model=JaxDiT["DiTRotary_B_8"]())
    with torch.device("meta"):
        dit = DiT_models["DiTRotary_XL_8"]().to(torch.bfloat16)
        scoring = pipeline.ScoringBundle(
            decoder=ScoringDecoder(), feature_head=RuleFeatureHead(),
            rollout=DiT_models["DiTRotary_B_8"]())
        vae = AutoencoderKL()
    with pytest.raises(memory.HBMPreflightError) as terr:
        pipeline.preflight(dit, vae, tcfg, SHAPE, scoring=scoring)
    head = lambda e: str(e.value).split(" Reduce")[0]
    assert head(terr) == head(jerr)


def test_scoring_rollout_without_weights_raises():
    with pytest.raises(ValueError, match="without weights"):
        pipeline.ScoringBundle.create(rollout="DiTRotary_B_8", device="cpu")


# ---------------------------------------------------------------- loader, CLI

def test_loader_accepts_the_serving_yamls():
    rules = ["pitch_hist", "note_density", "chord_progression"]
    want = {
        "scg_fast_pre4": dict(sampler="ddim", prefilter=4, reuse=0, sde=False),
        "scg_sde20_pre4": dict(sampler="dpmpp", prefilter=4, reuse=0, sde=True),
        "unguided_reuse2": dict(sampler="ddim", prefilter=None, reuse=2, sde=False),
    }
    for name, w in want.items():
        cfg = tconfig.sampler_config_from_yaml(
            tconfig.load_config(os.path.join(SERVING, name + ".yml")),
            rule_names=rules)
        assert cfg.sampler == w["sampler"] and cfg.dpmpp_sde == w["sde"]
        assert cfg.dpmpp_order == 2 and cfg.reuse_t_max == -1
        assert cfg.reuse_interval == w["reuse"]
        assert (cfg.scg.prefilter if cfg.scg else None) == w["prefilter"]
        if cfg.scg:
            assert cfg.scg.num_samples == 16 and dict(cfg.scg.weights) == dict(WEIGHTS)


LOADER_BLOCKS = [
    ({"sampling": {"diff_collage": True}}, "diff_collage"),
    ({"guidance": {"scg": True, "dc": {"base": 64}}}, "dc.base"),
]


@pytest.mark.parametrize("block,match", LOADER_BLOCKS)
def test_loader_accepts_diffcollage_and_windowed_scg(block, match):
    """The DiffCollage and windowed-SCG blocks load, with the windowed base."""
    cfg = tconfig.sampler_config_from_yaml(tconfig.dict_to_obj(block))
    if match == "dc.base":
        assert cfg.scg.dc_base == 64
    else:
        assert cfg.scg is None and cfg.sampler == "ddpm"


@pytest.mark.parametrize("block,match", LOADER_BLOCKS)
def test_loader_still_refuses(block, match):
    """Beside each block it now takes, the loader still refuses what is not
    ported: a sampler beyond ddpm/ddim/dpmpp and a guidance method beyond
    the three, each named in the error."""
    for key, extra in (("sampling", {"sampler": "heun"}),
                       ("guidance", {"method": "universal"})):
        merged = {**block, key: {**block.get(key, {}), **extra}}
        name, value = next(iter(extra.items()))
        with pytest.raises(NotImplementedError, match=f"{key}.{name}={value}"):
            tconfig.sampler_config_from_yaml(tconfig.dict_to_obj(merged))


CLI_FIXTURE_ARGS = [
    "--model", "DiTRotary_XS_8", "--num_classes", "0", "--class_cond", "True",
    "--model_path", QUALITY, "--vae_path", QUALITY,
    "--vae_arch", '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}',
    "--scoring_features_path", GATE, "--scoring_decoder_path", GATE,
    "--scoring_rollout", "DiTRotary_XS_8", "--scoring_rollout_path", GATE,
    "--batch_size", "1", "--num_samples", "1", "--device", "cpu",
    "--dtype", "float32"]


# scg_fast_pre4 runs its YAML's ddim100 chain: 99 guided steps, each
# decoding 32 chunks, ~130 s on one core, so it is marked slow; the loader
# test above reads it in tier 1, and chip_smoke.py runs it at full width
@pytest.mark.parametrize("name", [
    pytest.param("scg_fast_pre4", marks=pytest.mark.slow),
    "scg_sde20_pre4", "unguided_reuse2"])
def test_cli_runs_each_serving_yaml(tmp_path, name):
    rows = sample_rule.main(["--config_path", os.path.join(SERVING, name + ".yml"),
                             "--out_dir", str(tmp_path)] + CLI_FIXTURE_ARGS)
    assert len(rows) == 1
    assert os.path.exists(tmp_path / "sample_0_y_1.midi")
    for f in ("results.csv", "summary.csv"):
        assert (tmp_path / f).stat().st_size > 0
    assert {"pitch_hist.loss", "note_density.loss",
            "chord_progression.loss"} <= set(rows[0])


def test_cli_reuse_and_segment_flags(tmp_path, monkeypatch):
    """--reuse_interval 0 turns the YAML's reuse off and --reuse_t_max
    overrides its window, each on its own; --segments 1 runs the chain
    whole, and --segments > 1 (the JAX CLI's dispatch bound) is refused."""
    seen = []
    real = pipeline.generate

    def spy(*args, **kw):
        seen.append((args[3].reuse_interval, args[3].reuse_t_max))
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "generate", spy)
    argv = ["--config_path", os.path.join(SERVING, "unguided_reuse2.yml"),
            "--out_dir", str(tmp_path)] + CLI_FIXTURE_ARGS
    sample_rule.main(argv + ["--reuse_interval", "0", "--segments", "1"])
    sample_rule.main(argv + ["--reuse_t_max", "700"])
    # the YAML sets reuse_interval 2 and leaves reuse_t_max at -1
    assert seen == [(0, -1), (2, 700)]
    with pytest.raises(ValueError, match="JAX-only"):
        sample_rule.main(argv + ["--segments", "2"])


def test_chip_smoke_states_the_serving_yamls():
    """chip_smoke.py states the three YAMLs (the card has no PyYAML); they
    are what the loader reads from the files."""
    import chip_smoke

    assert set(chip_smoke.SERVING) == {
        f[:-4] for f in os.listdir(SERVING) if f.endswith(".yml")}
    for name in chip_smoke.SERVING:
        respacing, cfg = chip_smoke.serving_config(name, record=True)
        ns = tconfig.load_config(os.path.join(SERVING, name + ".yml"))
        assert respacing == ns.sampling.timestep_respacing
        assert cfg == tconfig.sampler_config_from_yaml(ns, rule_names=RULES,
                                                       record=True)
