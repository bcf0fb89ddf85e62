"""Windowed SCG, stitched DiffCollage chains and the long-form demos'
config against the JAX package.

``_scg_select`` with ``dc_base`` > 0 takes the argmax per window; the JAX
package records no per-window selection, so its selections are read off
the selected latent: each window of it is exactly one candidate's window
(:func:`jax_window_selections`). The selections must be equal; the
record's values agree to 1e-5 of their largest magnitude on the toy
decoder and 1e-3 on the fixture, as in ``test_torch_scg_chain`` (float32
both sides; the rule programs threshold the decoded rolls, so a value
near a threshold moves a rule value by a step). The stitched chain
(demo1's geometry: a circle of one image, overlap 64, windowed SCG with
``dc_base`` 16 and the three classifiers of ``test_torch_guidance``)
replays JAX's keys through ``noise_fn``: the same selection in every
window at every step, latents and recorded states within 1e-4 of their
largest magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu import config as jconfig
from rule_guided_music_tpu.diffusion import collage as jc
from rule_guided_music_tpu.diffusion import guidance as jguidance
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule

from test_torch_guidance import flagship_rules, flagship_specs
from test_torch_scg_chain import jax_replay_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
DEMOS = os.path.join(REPO, "scripts", "configs", "cond_demo")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0),
           ("chord_progression", 2.0))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), err


def window_picks(cands, sel, dc_base):
    """(windows, B): the candidate whose window equals ``sel``'s, from
    candidates (k, B, C, T, P) and the selected latent (B, C, T, P)."""
    k, b, c, t, p = cands.shape
    d = jnp.abs(cands - sel[None]).reshape(k, b, c, t // dc_base, dc_base, p)
    return jnp.argmin(d.sum(axis=(2, 4, 5)), axis=0).T.astype(jnp.int32)


def jax_window_selections(monkeypatch, k, dc_base, n_win):
    """Patch the JAX sampler so that its record holds ``selected`` per
    window (-1 where no search ran), as the port's does; undone by
    ``monkeypatch.undo()``."""
    orig_select, orig_empty = jsampling._scg_select, jsampling._empty_record

    def select(config, tables, model_fn, decode_fn, rules, rng, mean, g_coeff,
               t, y, **kw):
        sel, rec = orig_select(config, tables, model_fn, decode_fn, rules, rng,
                               mean, g_coeff, t, y, **kw)
        noise = jax.random.normal(rng, (k,) + mean.shape, dtype=mean.dtype)
        cands = mean[None] + g_coeff[None] * noise
        return sel, dict(rec, selected=window_picks(cands, sel, dc_base))

    def empty(config, rules, b=0):
        return dict(orig_empty(config, rules, b),
                    selected=jnp.full((n_win, b), -1, dtype=jnp.int32))

    monkeypatch.setattr(jsampling, "_scg_select", select)
    monkeypatch.setattr(jsampling, "_empty_record", empty)


def toy_decode_j(z):
    r = jnp.repeat(jnp.swapaxes(z, 2, 3), 8, axis=2)     # (N, 1, 128, T)
    return jnp.repeat(r, 8, axis=3)                      # (N, 1, 128, 8T)


def toy_decode_t(z):
    r = torch.repeat_interleave(z.transpose(2, 3), 8, dim=2)
    return torch.repeat_interleave(r, 8, dim=3)


def select_both(jdecode, tdecode, jmodel, tmodel, rules_np, mean, g_coeff,
                dc_base, k, t_step, tables_steps=50):
    b = mean.shape[0]
    jt = jschedule.make_schedule("linear", 1000, str(tables_steps)).tables()
    tt = tschedule.make_schedule("linear", 1000, str(tables_steps)).tables("cpu")
    names = list(rules_np)
    weights = tuple((n, w) for n, w in WEIGHTS if n in names)
    jcfg = jsampling.SamplerConfig(record=True, scg=jsampling.SCGConfig(
        num_samples=k, dc_base=dc_base, weights=weights))
    tcfg = tconfig.SamplerConfig(record=True, scg=tconfig.SCGConfig(
        num_samples=k, dc_base=dc_base, weights=weights))
    key = jax.random.PRNGKey(3)
    t = np.full((b,), t_step, np.int64)
    with jax.default_matmul_precision("highest"):
        jsel, jrec = jax.jit(lambda rules, key, mean, g, t: jsampling._scg_select(
            jcfg, jt, jmodel, jdecode, rules, key, mean, g, t, None))(
            {n: jnp.asarray(v) for n, v in rules_np.items()}, key,
            jnp.asarray(mean), jnp.asarray(g_coeff), jnp.asarray(t, jnp.int32))
    noise = jax.random.normal(key, (k,) + mean.shape, dtype=jnp.float32)
    jpicks = window_picks(jnp.asarray(mean)[None] + jnp.asarray(g_coeff)[None] * noise,
                          jsel, dc_base)
    with torch.no_grad():
        tsel, trec = tsampling._scg_select(
            tcfg, tt, tmodel, tdecode,
            {n: torch.as_tensor(np.array(v)) for n, v in rules_np.items()},
            torch.as_tensor(np.array(noise)), torch.as_tensor(mean),
            torch.as_tensor(g_coeff), torch.as_tensor(t), None)
    return jsel, jrec, jpicks, tsel, trec


@pytest.mark.parametrize("b", [1, 2])
def test_windowed_select_matches_jax_on_the_toy_decoder(b):
    """tests/test_sampling.py::test_scg_windowed_dc_selection's setting:
    32 latent columns, two windows of dc_base 16, pitch histogram and one
    chord per window."""
    k, shape = 4, (b, 1, 32, 16)
    target = np.zeros((b, 12), np.float32)
    target[:, 0] = 1.0
    rules = {"pitch_hist": target, "chord_progression": np.ones((b, 2), np.int32)}
    mean = np.full(shape, -1.0, np.float32)
    g_coeff = np.full(shape, 0.5, np.float32)
    zeros_j = lambda x, t, y=None: jnp.zeros_like(x)
    zeros_t = lambda x, t, y=None: torch.zeros_like(x)
    jsel, jrec, jpicks, tsel, trec = select_both(
        toy_decode_j, toy_decode_t, zeros_j, zeros_t, rules, mean, g_coeff,
        16, k, 20)
    np.testing.assert_array_equal(trec["selected"].numpy(), np.asarray(jpicks))
    close(tsel, jsel, 1e-6)     # jit fuses mean + g * noise: an ulp apart
    assert sorted(trec) == sorted(list(jrec) + ["selected"])
    for name in jrec:
        close(trec[name], jrec[name], 1e-5)


@pytest.fixture(scope="module")
def fixture_models():
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
        fx=fx, jdit=jdit, tdit=tdit, tvae=tvae,
        jdecode=jmake_decode(lambda z: jvae.apply(fx["vae"], z,
                                                  method=JaxVAE.decode), 1.0),
        tdecode=lambda z: pipeline.decode_rolls(tvae, z, 1.0))


@pytest.mark.parametrize("dc_base", [16, 128])
def test_windowed_select_matches_jax_on_a_decoded_fixture(fixture_models, dc_base):
    """quality_tiny's DiT rollout and ch-32 decoder, the three rules of
    demo1 (note density and chords sliced per window), k=4, B=2."""
    m = fixture_models
    k, shape = 4, (2, 4, 128, 16)
    rng = np.random.default_rng(4)
    mean = rng.normal(size=shape).astype(np.float32)
    g_coeff = np.full(shape, 0.6, np.float32)
    rules = {n: np.asarray(v) for n, v in flagship_rules(
        make_rolls(2, seed=12))[0].items()}
    jsel, jrec, jpicks, tsel, trec = select_both(
        m["jdecode"], m["tdecode"],
        lambda x, t, y=None: m["jdit"].apply(m["fx"]["dit"], x, t),
        lambda x, t, y=None: m["tdit"](x, t), rules, mean, g_coeff, dc_base, k, 30)
    assert trec["selected"].shape == (128 // dc_base, 2)
    np.testing.assert_array_equal(trec["selected"].numpy(), np.asarray(jpicks))
    close(tsel, jsel, 1e-6)     # jit fuses mean + g * noise: an ulp apart
    for name in jrec:
        close(trec[name], jrec[name], 1e-3)


def test_windowed_select_refuses_a_feature_head():
    """A rule-feature head pools fixed windows: the sampler refuses it with
    windowed SCG before any step, as the JAX package does."""
    cfg = tconfig.SamplerConfig(scg=tconfig.SCGConfig(num_samples=2, dc_base=16,
                                                      prefilter=2))
    tables = tschedule.make_schedule("linear", 1000, "4").tables("cpu")
    with pytest.raises(ValueError, match="dc_base"):
        tsampling.sample_loop(lambda x, t, y=None: x, (1, 4, 128, 16), tables,
                              cfg, noise_fn=lambda *a: torch.zeros(a[2]),
                              scoring_feature_fn=lambda z: {},
                              decode_fn=lambda z: z)


def test_stitched_windowed_classifier_chain_matches_jax(monkeypatch):
    """8 steps, k=4, B=2: demo1's stitched circle score (2 windows of 128
    over the wrapped 128 columns), SCG per 16-column window, classifier
    guidance on every step, states recorded."""
    steps, k, b, seed, dc_base = 8, 4, 2, 6, 16
    collage = dict(num_img=1, overlap=64, circle=True)
    shape = (b, 4, jc.circle_length(1, 64), 16)
    sched = dict(schedule=True, t_start=750)
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    jspecs, metas = flagship_specs()
    jrules, trules = flagship_rules(make_rolls(b, seed=21))
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(method="classifier_guidance", **sched),
        scg=jsampling.SCGConfig(num_samples=k, weights=WEIGHTS, dc_base=dc_base),
        record=True, record_states=True)
    model_fn = jc.make_cond_ind_eps_fn(
        lambda x, t, y=None: jdit.apply(fx["dit"], x, t), **collage)
    decode = jmake_decode(lambda z: jvae.apply(fx["vae"], z,
                                               method=JaxVAE.decode), 1.0)
    jax_window_selections(monkeypatch, k, dc_base, shape[2] // dc_base)
    run = jax.jit(lambda key, rules: jsampling.sample_loop(
        key, model_fn, shape, jt, jcfg, rules=rules,
        cond_fn=jguidance.make_grad_cond_fn(jspecs), decode_fn=decode))
    with jax.default_matmul_precision("highest"):
        jx, jrec = run(jax.random.PRNGKey(seed), jrules)
    monkeypatch.undo()

    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tvae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu")
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(method="classifier_guidance", **sched),
        scg=tconfig.SCGConfig(num_samples=k, weights=WEIGHTS, dc_base=dc_base),
        record=True, record_states=True)
    tx, trec = pipeline.generate(tdit, tvae, tt, tcfg, shape, trules,
                                 noise_fn=jax_replay_noise(seed, steps),
                                 classifier_metas=metas, num_classes=0,
                                 scale_factor=1.0, collage=collage)
    jsel = np.asarray(jrec["selected"])
    assert (jsel[:-1] >= 0).all() and (jsel[-1] == -1).all()  # t == t_end
    np.testing.assert_array_equal(trec["selected"].numpy(), jsel)
    # the windowed record: no per-rule loss, no candidate matrix
    assert not any(n.startswith("loss/") for n in trec)
    assert "candidate_log_prob" not in trec and "candidate_log_prob" not in jrec
    close(tx, jx, 1e-4)
    close(trec["state"], jrec["state"], 1e-4)
    np.testing.assert_array_equal(trec["state"][-1].numpy(), tx.numpy())
    for name in ("log_prob", "loss_std", "loss_range"):
        close(trec[name], jrec[name], 1e-4)


@pytest.mark.parametrize("demo", ["demo1", "demo2", "demo3"])
def test_demo_configs_translate_as_jax(demo):
    """The loader on each long-form demo against JAX's
    ``sampler_config_from_yaml``, with record and record_states, and the
    geometry the JAX CLI computes from the ``dc:`` block."""
    path = os.path.join(DEMOS, demo + ".yml")
    tree = tconfig.load_config(path)
    names = list(vars(tree.target_rules))
    if "vertical_nd" in names:
        names = [n for n in names if "_nd" not in n] + ["note_density"]
    for record, states in ((False, True), (True, True), (True, False)):
        want = jconfig.sampler_config_from_yaml(
            jconfig.load_config(path), record=record, record_states=states,
            rule_names=names)
        got = tconfig.sampler_config_from_yaml(tree, record=record,
                                               record_states=states,
                                               rule_names=names)
        assert (got.record, got.record_states) == (want.record, want.record_states)
        assert (got.scg.num_samples, got.scg.weights, got.scg.dc_base) == \
            (want.scg.num_samples, want.scg.weights, want.scg.dc_base)
        for field in ("method", "schedule", "t_start", "t_end", "interval"):
            assert getattr(got.guidance, field) == getattr(want.guidance, field)
        assert (got.sampler, got.t_end) == (want.sampler, want.t_end)
    assert got.scg.dc_base == {"demo1": 16, "demo2": 128, "demo3": 0}[demo]
    collage, shape = tconfig.collage_from_config(tree, 2)
    assert collage == dict(num_img=1, overlap=64, circle=True)
    assert shape == (2, 4, jc.circle_length(1, 64), 16) == (2, 4, 128, 16)


@pytest.mark.parametrize("tree,dc_base", [
    # the top-level dc.base counts only on a DiffCollage chain
    ({"guidance": {"scg": True}, "dc": {"base": 32}}, 0),
    ({"guidance": {"scg": True}, "dc": {"base": 32, "type": "linear",
                                        "overlap_size": 32, "num_img": 3},
      "sampling": {"diff_collage": True}}, 32),
    ({"guidance": {"scg": True, "dc": {"base": 64}}}, 64),
])
def test_dc_base_fallback_as_jax(tree, dc_base):
    got = tconfig.sampler_config_from_yaml(tconfig.dict_to_obj(tree))
    want = jconfig.sampler_config_from_yaml(jconfig.dict_to_obj(tree))
    assert got.scg.dc_base == want.scg.dc_base == dc_base
    collage, shape = tconfig.collage_from_config(tconfig.dict_to_obj(tree), 1)
    if "sampling" in tree:
        assert collage == dict(num_img=3, overlap=32, circle=False)
        assert shape == (1, 4, jc.linear_length(3, 32), 16)
    else:
        assert collage is None and shape == (1, 4, 128, 16)


@pytest.mark.parametrize("dc_type", ["circle", "linear"])
def test_cfg_inside_the_stitching_matches_jax(dc_type):
    """diffcollage_sample's chain: a class-conditional XS DiT (random
    non-zero weights shared by both frameworks) made classifier-free guided
    first and stitched around that, as the JAX package's ``wrap_model``
    does; a 4-step DDPM chain over 256 columns (three images, overlap 64)
    on JAX's keys, within 1e-4 of the largest latent. Each window call
    runs both CFG halves: 2 * B * n windows."""
    from rule_guided_music_tpu.pipeline import make_sample_fn
    from rule_guided_music_tpu.utils.fixtures import flatten_tree, unflatten_tree
    from rule_guided_music_tpu_torch import convert
    from rule_guided_music_tpu_torch.models.dit import DiT_models

    steps, b, seed = 4, 2, 8
    circle = dc_type == "circle"
    collage = dict(num_img=3, overlap=64, circle=circle)
    shape = (b, 4, 256, 16)
    jmodel = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                     num_classes=3)
    x = np.zeros((1, 4, 128, 16), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((1,)),
                         jnp.zeros((1,), jnp.int32))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(3)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, unflatten_tree(
        {k[len("params/"):]: v for k, v in flat.items()}))}
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    gen = make_sample_fn(denoiser_model=jmodel, tables=jt,
                         sampler_config=jsampling.SamplerConfig(),
                         gen_shape=shape, use_decode=False, num_classes=3,
                         class_cond=True, cfg=True, w=2.0, collage=collage)
    y = np.array([1, 2], np.int32)
    with jax.default_matmul_precision("highest"):
        jx, _ = gen(jax.random.PRNGKey(seed), {"denoiser": jparams}, {},
                    jnp.asarray(y))

    model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    model.load_state_dict(convert.dit_state_dict(flat))
    model.eval().requires_grad_(False)
    batches = []
    forward = model.forward
    model.forward = lambda x, t, y=None: batches.append(x.shape[0]) or forward(x, t, y)
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    tx, _ = pipeline.generate(model, None, tt, tconfig.SamplerConfig(), shape,
                              {}, y=torch.as_tensor(y).long(),
                              noise_fn=jax_replay_noise(seed, steps),
                              num_classes=3, use_decode=False, collage=collage,
                              cfg=True, w=2.0)
    n = 4 if circle else 3
    assert batches == [2 * b * n] * (2 * steps)     # full and half windows
    close(tx, jx, 1e-4)
