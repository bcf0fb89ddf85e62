"""Classifier-guided chains and the flagship CLI against the JAX package.

The chains run on the quality_tiny fixture (trained DiTRotary_XS_8 + ch-32
KL-VAE) with the three XS classifiers of ``test_torch_guidance`` standing in
for scg_classifier_all.yml's (same functions, rules and scales 400/10/10).
The port's ``noise_fn`` replays the JAX sampler's key split order, so both
chains see the same numbers; classifier guidance draws no noise. The SCG
chain must select the same candidate at every step. Final latents agree to
1e-3 + 1e-4 |x| (float32 both sides): the random classifiers at scale 400
push the latents to ~1e3, the models differ by ~1e-5 relative, and the
recursion amplifies that through the 1/sqrt(alpha) factors of the x0
rollout and the guidance (observed: max |diff| 2.9e-3 on both chains,
2.2e-6 and 8.8e-6 of the largest latent).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion import guidance as jguidance
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jmake_decode
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.pipeline import eval_rule_loss, summarize_losses
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline, sample_rule
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule

from test_torch_guidance import flagship_rules, flagship_specs
from test_torch_scg_chain import jax_replay_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0), ("chord_progression", 1.0))


def _run_both(jcfg, tcfg, respacing, steps, b, seed, use_decode):
    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    jspecs, metas = flagship_specs()
    jrules, trules = flagship_rules(make_rolls(b + 1, seed=21)[1:])
    decode = jmake_decode(
        lambda z: jvae.apply(fx["vae"], z, method=JaxVAE.decode), 1.0) \
        if use_decode else None
    jt = jschedule.make_schedule("linear", 1000, respacing).tables()
    run = jax.jit(lambda key, rules: jsampling.sample_loop(
        key, lambda x, t, y=None: jdit.apply(fx["dit"], x, t), (b, 4, 128, 16),
        jt, jcfg, rules=rules, cond_fn=jguidance.make_grad_cond_fn(jspecs),
        decode_fn=decode))
    with jax.default_matmul_precision("highest"):
        jx, jrec = run(jax.random.PRNGKey(seed), jrules)

    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tvae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                               device="cpu")
    tt = tschedule.make_schedule("linear", 1000, respacing).tables("cpu")
    tx, trec = pipeline.generate(tdit, tvae, tt, tcfg, (b, 4, 128, 16), trules,
                                 noise_fn=jax_replay_noise(seed, steps),
                                 classifier_metas=metas, num_classes=0,
                                 use_decode=use_decode, scale_factor=1.0)
    return np.asarray(jx), jrec, tx.numpy(), trec


def test_classifier_scg_chain_matches_jax():
    """8 steps, k=4: classifier guidance on every step, SCG where the
    schedule says; the same selections and latents as the JAX package."""
    steps, k = 8, 4
    sched = dict(schedule=True, t_start=750)
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(method="classifier_guidance", **sched),
        scg=jsampling.SCGConfig(num_samples=k, weights=WEIGHTS), record=True)
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(method="classifier_guidance", **sched),
        scg=tconfig.SCGConfig(num_samples=k, weights=WEIGHTS), record=True)
    jx, jrec, tx, trec = _run_both(jcfg, tcfg, str(steps), steps, b=1, seed=5,
                                   use_decode=True)
    jlp = np.asarray(jrec["candidate_log_prob"])
    assert jlp.any(axis=(1, 2)).sum() == steps - 1   # every step but t == t_end
    np.testing.assert_array_equal(trec["candidate_log_prob"].numpy().argmax(1),
                                  jlp.argmax(1))
    assert np.isfinite(tx).all()
    np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-3)


def test_ddim_chain_with_classifier_guidance_matches_jax():
    """DDIM without SCG: the guidance shifts eps where the schedule holds
    (t < 600 here, so the first steps run unguided)."""
    sched = dict(schedule=True, t_start=600)
    jcfg = jsampling.SamplerConfig(
        sampler="ddim", guidance=jsampling.GuidanceConfig(
            method="classifier_guidance", **sched))
    tcfg = tconfig.SamplerConfig(
        sampler="ddim", guidance=tconfig.GuidanceConfig(
            method="classifier_guidance", **sched))
    jx, _, tx, _ = _run_both(jcfg, tcfg, "ddim5", 5, b=2, seed=2,
                             use_decode=False)
    assert np.isfinite(tx).all()
    np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-3)


def test_rule_results_match_eval_rule_loss():
    """results.csv rows, the chord key columns included, against the JAX
    package's eval_rule_loss on the same rolls."""
    rolls = make_rolls(3, seed=9)
    targets = make_rolls(3, seed=10)
    names = ["pitch_hist", "note_density", "chord_progression"]
    jrules = {n: JFUNC[n](jnp.asarray(targets)) for n in names}
    ref = eval_rule_loss(jnp.asarray(rolls), jrules)
    rows = sample_rule.rule_results(
        torch.as_tensor(rolls),
        pipeline.extract_targets_from_rolls(names, torch.as_tensor(targets)))
    assert list(rows[0]) == list(ref.columns)
    assert "chord_progression.key_str" in ref.columns
    _assert_frame_equal(pd.DataFrame(rows), ref)


def _assert_frame_equal(got, ref):
    for col in ref.columns:
        for a, b in zip(got[col], ref[col]):
            if isinstance(b, str):
                assert a == b, col
            else:
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64),
                                           rtol=1e-5, atol=1e-6, err_msg=col)


@pytest.mark.parametrize("yml", ["scg_classifier_all.yml", "classifier.yml"])
def test_flagship_cli_writes_results_and_summary(tmp_path, monkeypatch, yml):
    """The flagship YAML (and classifier guidance without SCG) at fixture
    size on the CPU: MIDI, results.csv (rewritten per batch, with the chord
    key columns) and summary.csv, whose values are the JAX package's
    eval_rule_loss and summarize_losses on the rolls the CLI generated."""
    finals = []
    finalize = sample_rule.finalize_decoded_sample

    def keep(*args, **kw):
        finals.append(finalize(*args, **kw))
        return finals[-1]

    monkeypatch.setattr(sample_rule, "finalize_decoded_sample", keep)
    cfg = os.path.join(REPO, "scripts", "configs", "cond_table", "all", yml)
    out = tmp_path / "out"
    rows = sample_rule.main([
        "--config_path", cfg, "--model", "DiTRotary_XS_8", "--num_classes", "0",
        "--model_path", FIXTURE, "--vae_path", FIXTURE,
        "--vae_arch", TINY_VAE_ARCH, "--batch_size", "1", "--num_samples", "2",
        "--timestep_respacing", "2", "--device", "cpu", "--dtype", "float32",
        "--out_dir", str(out)])
    assert len(rows) == 2 and len(finals) == 2
    assert (out / "sample_0_y_1.midi").exists() and (out / "sample_1_y_1.midi").exists()
    results = pd.read_csv(out / "results.csv")
    assert {"chord_progression.key_str", "chord_progression.key_corr"} <= set(results)
    # the CLI's targets: make_rolls excerpts at its batch size and seed
    targets = make_rolls(1, seed=0)
    names = [c[:-len(".loss")] for c in results.columns if c.endswith(".loss")]
    jrules = {n: JFUNC[n](jnp.asarray(targets)) for n in names}
    ref = pd.concat([eval_rule_loss(
        jnp.asarray(arr.astype(np.float32) / 63.5 - 1.0), jrules)
        for arr in finals], ignore_index=True)
    assert list(results.columns) == list(ref.columns)
    for col in ref.columns:
        if isinstance(ref[col][0], list):
            results[col] = results[col].map(ast.literal_eval)
    _assert_frame_equal(results, ref)
    summary = pd.read_csv(out / "summary.csv", index_col=0)
    want = summarize_losses(ref)
    assert list(summary["Attr"]) == list(want["Attr"])
    np.testing.assert_allclose(summary[["Mean", "Std"]].to_numpy(),
                               want[["Mean", "Std"]].to_numpy(), rtol=1e-5,
                               atol=1e-7)
