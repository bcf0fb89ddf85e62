"""DPS guidance in the port against the JAX package (CPU, float32): the
mean shift against ``jax.grad``, DPS chains with JAX's noise replayed, DPS
ignored on DDIM, the loader on the DPS and edit YAMLs, and the CLI on a
DPS YAML with test-set targets.

Models: the trained quality_tiny DiTRotary_XS_8 and ch-32 KL-VAE, and the
XS classifiers of ``test_torch_guidance`` standing in for
scg_dps_nn_all.yml's three S/8 classifiers (same functions, rules and
scales 40/1/1). Tolerances: the DPS shift within 1e-4 of its largest
magnitude (fp32 gradients through the denoiser, and the decoder or a
classifier; observed ~1e-6); chains as in ``test_torch_scg_chain``.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu import config as jconfig
from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion import guidance as jguidance
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline
from rule_guided_music_tpu_torch.diffusion import gaussian as tgd
from rule_guided_music_tpu_torch.diffusion import guidance as tguidance
from rule_guided_music_tpu_torch.diffusion import sampling as tsampling
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.diffusion.latent import make_decode_fn

import chip_smoke
from test_torch_guidance import paired_classifier
from test_torch_scg_chain import jax_replay_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
CONFIGS = os.path.join(REPO, "scripts", "configs")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
# scg_dps_nn_all.yml's cond_fn: (fn, rule, scale, classes, chord)
DPS_NN_TERMS = (("nn_z0_mse_dummy", "pitch_hist", 40.0, 12, False),
                ("nn_z0_mse_dummy", "note_density", 1.0, 16, False),
                ("nn_z0_chord_dummy", "chord_progression", 1.0, 8, True))
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0), ("chord_progression", 1.0))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on one machine; torch's default of a
    thread per core makes the conv-heavy chains here contend badly there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
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
        jdecode=jmake_decode(lambda z: jvae.apply(fx["vae"], z,
                                                  method=JaxVAE.decode),
                             fx["scale"]),
        tdit=tdit, tvae=tvae,
        tmodel=tguidance.make_model_fn(tdit, 0, class_cond=False),
        tdecode=make_decode_fn(tvae.decode, fx["scale"]), scale=fx["scale"])


def _specs(variant, terms=DPS_NN_TERMS):
    """(JAX specs, port specs, rule names) of a DPS cond_fn: classifier
    ``terms`` on z0 (scg_dps_nn_all's three by default), or a rule program
    on the decoded x0 (dps_rule/pitch.yml)."""
    if variant == "rule":
        spec = dict(fn="rule_x0_mse_dummy", rule_name="pitch_hist", scale=1.0)
        return ([jguidance.CondFnSpec(**spec)], [tguidance.CondFnSpec(**spec)],
                ["pitch_hist"])
    jspecs, tspecs = [], []
    for i, (fn, rule, scale, ncls, chord) in enumerate(terms):
        jcls, tcls = paired_classifier(ncls, chord, seed=20 + i)
        jspecs.append(jguidance.CondFnSpec(fn=fn, rule_name=rule, scale=scale,
                                           classifier=jcls))
        tspecs.append(tguidance.CondFnSpec(fn=fn, rule_name=rule, scale=scale,
                                           classifier=tcls))
    return jspecs, tspecs, [r for _, r, _, _, _ in terms]


def _configs(variant, edit=None, scg=0, sampler="ddpm", record=False,
             **guidance):
    """The JAX and port SamplerConfigs of a DPS chain: nn on z0 (the
    decoder only ranks SCG candidates), or the rule on decoded rolls (vae
    on, nn off); SCG with ``scg`` candidates where it is not 0."""
    g = dict(method="dps", step_size=0.7, nn=variant == "nn", **guidance)
    return [mod.SamplerConfig(
        sampler=sampler, guidance=mod.GuidanceConfig(**g),
        edit=mod.EditConfig(**edit) if edit else None,
        scg=mod.SCGConfig(num_samples=scg, weights=WEIGHTS) if scg else None,
        record=record) for mod in (jsampling, tconfig)]


def _rules(names, cols):
    rolls = make_rolls(3, seed=17)[1:, ..., cols]
    return ({n: JFUNC[n](jnp.asarray(rolls)) for n in names},
            pipeline.extract_targets_from_rolls(names, torch.as_tensor(rolls)))


def _jax_dps_slicing_latents(config, tables, model_fn, decode_fn, cond_fn, rules,
                             x, t, pmv):
    """The JAX package's DPS mean shift with the edit slice cut from the
    latents before the decode, as its SCG search cuts it (its
    ``_dps_mean_shift`` cuts the decoded rolls' pitch axis instead:
    ROADMAP.md section 3), built from the JAX package's own pieces."""
    g, sl = config.guidance, slice(config.edit.l_start, config.edit.l_end)
    model_t = tables.model_t[t]

    def logp_sum(xin):
        x0 = jgd.predict_xstart_from_eps(tables, xin, t, model_fn(xin, model_t))
        lp = cond_fn(decode_fn(x0[:, :, sl, :]), model_t, rules)
        return lp.sum(), lp

    grad, lp = jax.grad(logp_sum, has_aux=True)(x)
    grad = grad / jnp.sqrt(-lp + 1e-12)[:, None, None, None]
    return pmv.mean.at[:, :, sl, :].add(g.step_size * grad[:, :, sl, :])


@pytest.mark.parametrize("edit", [False, True], ids=["whole", "edit_slice"])
@pytest.mark.parametrize("variant", ["nn", "rule"])
def test_dps_mean_shift_matches_jax_grad(models, variant, edit):
    """One DPS step at t = 6 of a 10-step chain: the shifted mean, and the
    shift alone within 1e-4 of its largest magnitude."""
    # on an edit slice of z0 the note-density and chord classifiers give
    # fewer windows than their targets hold: only the pitch term applies
    jspecs, tspecs, names = _specs(variant, DPS_NN_TERMS[:1] if edit
                                   else DPS_NN_TERMS)
    edit_kw = dict(noise_level=10, l_start=32, l_end=64) if edit else None
    jcfg, tcfg = _configs(variant, edit_kw)
    cols = slice(256, 512) if edit else slice(None)
    jrules, trules = _rules(names, cols)
    x = np.random.default_rng(3).standard_normal((2, 4, 128, 16)).astype(np.float32)
    t = np.array([6, 6])
    jt = jschedule.make_schedule("linear", 1000, "10").tables()
    tt = tschedule.make_schedule("linear", 1000, "10").tables("cpu")
    jdecode = models["jdecode"] if variant == "rule" else None
    jcond = jguidance.make_value_cond_fn(jspecs)

    @jax.jit
    def jax_step(jx, jtt):
        jpmv = jgd.p_mean_variance(jt, models["jmodel"](jx, jt.model_t[jtt]), jx, jtt)
        if edit and variant == "rule":
            return jpmv.mean, _jax_dps_slicing_latents(
                jcfg, jt, models["jmodel"], jdecode, jcond, jrules, jx, jtt, jpmv)
        return jpmv.mean, jsampling._dps_mean_shift(
            jcfg, jt, models["jmodel"], jdecode, jcond, jrules, jx, jtt, None, jpmv)

    with jax.default_matmul_precision("highest"):
        jmean, ref = (np.asarray(a) for a in jax_step(jnp.asarray(x), jnp.asarray(t)))
    tx, ttt = torch.as_tensor(x), torch.as_tensor(t)
    with torch.no_grad():
        tpmv = tgd.p_mean_variance(tt, models["tmodel"](tx, tt.model_t[ttt]), tx, ttt)
        mean, grad = tsampling._dps_mean_shift(
            tcfg, tt, models["tmodel"],
            models["tdecode"] if variant == "rule" else None,
            tguidance.make_value_cond_fn(tspecs), trules, tx, ttt, None, tpmv)
    assert not mean.requires_grad and mean.shape == x.shape
    shift, want = mean.numpy() - tpmv.mean.numpy(), ref - jmean
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(shift, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(mean.numpy(), ref, rtol=1e-5, atol=1e-5)
    if edit:
        outside = np.ones(128, bool)
        outside[32:64] = False
        assert (shift[:, :, outside] == 0).all()


def test_dps_on_a_rule_without_gradient_is_zero(models):
    """dps_rule/nd.yml: note density thresholds the roll, so x_t gets a
    zero gradient (jax.grad's), not an error."""
    spec = dict(fn="rule_x0_mse_dummy", rule_name="note_density", scale=1.0)
    _, tcfg = _configs("rule")
    _, trules = _rules(["note_density"], slice(None))
    tt = tschedule.make_schedule("linear", 1000, "10").tables("cpu")
    x = torch.randn((2, 4, 128, 16), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([6, 6])
    with torch.no_grad():
        pmv = tgd.p_mean_variance(tt, models["tmodel"](x, tt.model_t[t]), x, t)
        mean, grad = tsampling._dps_mean_shift(
            tcfg, tt, models["tmodel"], models["tdecode"],
            tguidance.make_value_cond_fn([tguidance.CondFnSpec(**spec)]), trules,
            x, t, None, pmv)
    assert (grad == 0).all() and torch.equal(mean, pmv.mean)


@pytest.mark.parametrize("variant", ["rule", "scg_nn"])
def test_dps_chain_matches_jax(models, variant):
    """A 6-step DDPM chain with JAX's noise replayed: DPS on the decoded
    pitch histogram (dps_rule/pitch.yml), and SCG k=4 + DPS on z0 through
    the three classifiers (scg_dps_nn_all.yml): the same selections, and
    the final latents within 1e-3."""
    steps, seed, b = 6, 7, 2
    if variant == "rule":
        jspecs, tspecs, names = _specs("rule")
        jcfg, tcfg = _configs("rule", record=True)
    else:
        jspecs, tspecs, names = _specs("nn")
        jcfg, tcfg = _configs("nn", scg=4, record=True, schedule=True,
                              t_start=750)
    jrules, trules = _rules(names, slice(None))
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    with jax.default_matmul_precision("highest"):
        jx, jrec = jax.jit(lambda key: jsampling.sample_loop(
            key, models["jmodel"], (b, 4, 128, 16), jt, jcfg, rules=jrules,
            cond_fn=jguidance.make_value_cond_fn(jspecs),
            decode_fn=models["jdecode"]))(jax.random.PRNGKey(seed))
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    metas = [pipeline.ClassifierSpecMeta(fn=s.fn, rule_name=s.rule_name,
                                         scale=s.scale, model=s.classifier)
             for s in tspecs]
    tx, trec = pipeline.generate(models["tdit"], models["tvae"], tt, tcfg,
                                 (b, 4, 128, 16), trules, classifier_metas=metas,
                                 noise_fn=jax_replay_noise(seed, steps),
                                 num_classes=0, scale_factor=models["scale"])
    if variant == "scg_nn":
        np.testing.assert_array_equal(
            trec["candidate_log_prob"].numpy().argmax(axis=1),
            np.asarray(jrec["candidate_log_prob"]).argmax(axis=1))
    assert (trec["guidance_grad_norm"].numpy() > 0).all()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-3)


def test_dps_is_ignored_on_ddim(models):
    """On DDIM the JAX loop never calls a DPS cond_fn (sampling.py:660): the
    port's chain calls it neither, and equals JAX's chain, guided or not."""
    steps, seed = 4, 2
    jspecs, tspecs, names = _specs("rule")
    jcfg, tcfg = _configs("rule", sampler="ddim")
    jrules, trules = _rules(names, slice(None))
    jt = jschedule.make_schedule("linear", 1000, f"ddim{steps}").tables()
    tt = tschedule.make_schedule("linear", 1000, f"ddim{steps}").tables("cpu")
    with jax.default_matmul_precision("highest"):
        jx, _ = jsampling.sample_loop(
            jax.random.PRNGKey(seed), models["jmodel"], (1, 4, 128, 16), jt, jcfg,
            rules=jrules, cond_fn=jguidance.make_value_cond_fn(jspecs),
            decode_fn=models["jdecode"])

    def cond_fn(*args):
        raise AssertionError("a DPS cond_fn was called on a DDIM chain")

    with torch.no_grad():
        tx, _ = tsampling.sample_loop(
            models["tmodel"], (1, 4, 128, 16), tt, tcfg,
            noise_fn=jax_replay_noise(seed, steps), rules=trules, cond_fn=cond_fn,
            decode_fn=models["tdecode"])
        plain, _ = tsampling.sample_loop(
            models["tmodel"], (1, 4, 128, 16), tt,
            tconfig.SamplerConfig(sampler="ddim"),
            noise_fn=jax_replay_noise(seed, steps))
    np.testing.assert_array_equal(tx.numpy(), plain.numpy())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-3)


DPS_YAMLS = sorted(
    [os.path.join(CONFIGS, "cond_table", "all", n)
     for n in ("scg_dps_nn_all.yml", "dps_nn.yml")]
    + glob.glob(os.path.join(CONFIGS, "cond_table", "single", "dps_*", "*.yml"))
    + glob.glob(os.path.join(CONFIGS, "edit", "*.yml")))


@pytest.mark.parametrize("path", DPS_YAMLS,
                         ids=[os.path.relpath(p, CONFIGS) for p in DPS_YAMLS])
def test_loader_accepts_dps_and_edit_yamls_as_jax(path):
    rules = ["pitch_hist", "note_density", "chord_progression"]
    tree = tconfig.load_config(path)
    got = tconfig.sampler_config_from_yaml(tree, rule_names=rules)
    want = jconfig.sampler_config_from_yaml(jconfig.load_config(path),
                                            rule_names=rules)
    for name in ("method", "schedule", "t_start", "t_end", "interval",
                 "step_size", "nn"):
        assert getattr(got.guidance, name) == getattr(want.guidance, name), name
    # the CLIs read the decode switch from the YAML tree (sample_rule.build)
    assert bool(getattr(tree.guidance, "vae", True)) == want.guidance.vae
    assert (got.edit is None) == (want.edit is None)
    if want.edit is not None:
        assert got.edit.__dict__ == want.edit.__dict__
    assert (got.scg is None) == (want.scg is None)
    if want.scg is not None:
        assert (got.scg.num_samples, got.scg.weights) == \
            (want.scg.num_samples, want.scg.weights)
    assert got.sampler == want.sampler


DC_BLOCKS = [
    ({"sampling": {"diff_collage": True}}, "diff_collage"),
    ({"guidance": {"scg": True, "method": "dps", "dc": {"base": 64}}}, "dc.base"),
    ({"edit": {"noise_level": 5}, "sampling": {"diff_collage": True}},
     "diff_collage"),
]


@pytest.mark.parametrize("block,match", DC_BLOCKS)
def test_loader_translates_windowed_scg_and_diffcollage_as_jax(block, match):
    """Each windowed-SCG and DiffCollage block translates as JAX's loader
    translates it."""
    got = tconfig.sampler_config_from_yaml(tconfig.dict_to_obj(block))
    want = jconfig.sampler_config_from_yaml(jconfig.dict_to_obj(block))
    assert (got.scg is None) == (want.scg is None)
    if match == "dc.base":
        assert got.scg.dc_base == want.scg.dc_base == 64
        assert got.guidance.method == want.guidance.method == "dps"
    assert (got.edit is None) == (want.edit is None)
    if want.edit is not None:
        assert got.edit.__dict__ == want.edit.__dict__


@pytest.mark.parametrize("block,match", DC_BLOCKS)
def test_loader_still_refuses_windowed_scg_and_diffcollage(block, match):
    """A windowed-SCG or DiffCollage block that also names a sampler the
    port lacks (beyond ddpm/ddim/dpmpp) is still refused, naming the
    samplers JAX documents."""
    merged = {**block, "sampling": {**block.get("sampling", {}), "sampler": "heun"}}
    with pytest.raises(NotImplementedError,
                       match="sampler: ddpm, ddim, dpmpp.*sampling.sampler=heun"):
        tconfig.sampler_config_from_yaml(tconfig.dict_to_obj(merged))


@pytest.mark.parametrize("name", sorted(chip_smoke.YAML_TREES))
def test_chip_smoke_states_this_slices_yamls(tmp_path, name):
    """The card has no PyYAML: chip_smoke.py states each YAML of the edit,
    DPS and test-set paths as the tree yaml.safe_load reads, and passes
    the flagship to the CLI as JSON, which the loader reads without
    PyYAML into the same SamplerConfig."""
    import yaml

    path = os.path.join(CONFIGS, name)
    with open(path) as f:
        assert chip_smoke.YAML_TREES[name] == yaml.safe_load(f)
    as_json = tmp_path / "config.json"
    as_json.write_text(json.dumps(chip_smoke.YAML_TREES[name]))
    rules = ["pitch_hist", "note_density", "chord_progression"]
    assert tconfig.sampler_config_from_yaml(
        tconfig.load_config(str(as_json)), rule_names=rules) == \
        tconfig.sampler_config_from_yaml(tconfig.load_config(path),
                                         rule_names=rules)
