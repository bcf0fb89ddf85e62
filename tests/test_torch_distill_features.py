"""The rule-feature head's distill step and metrics against
``scripts/distill_scoring_features.py`` on the CPU, at small widths and
fp32 (the tolerances and the step's harness are test_torch_distill.py's):
the teacher's features, three updates under the cosine schedule (the trap:
optax reads the schedule at the update's count before it increments), and
the agreement metrics on shared inputs.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jdecode_fn
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import RuleFeatureHead as JaxHead
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch import distill_scoring_features as tfeat
from test_torch_allrules_gate import tied_rolls
from test_torch_distill import (STEPS, check_steps, decoder_pair,  # noqa: F401
                                few_threads, head_pair, jax_adam, latents)


def jax_teacher_features(d, z):
    decode = jdecode_fn(lambda c: d["jteacher"].apply(d["tp"], c, method=JaxVAE.decode))
    roll = decode(jnp.asarray(z))
    return {name: np.asarray(JFUNC[name](roll)) for name in tfeat.RULES}, np.asarray(roll)


def test_feature_teacher_matches_jax(head_pair):
    """The teacher's features: the float rules within 1e-4, the chord tags
    equal on every roll with no window tied (tests/test_torch_allrules_gate
    .py::tied_rolls)."""
    z = latents(20, (2, 4, 128, 16))
    want, roll = jax_teacher_features(head_pair, z)
    got = tfeat.make_teacher_features(head_pair["teacher"], bf16=False)(
        torch.as_tensor(z))
    for name in ("pitch_hist", "note_density"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4, atol=1e-5)
    clean = ~tied_rolls(roll)
    np.testing.assert_array_equal(got["chord_progression"].numpy()[clean],
                                  want["chord_progression"][clean])


def test_feature_distill_steps_match_optax_cosine(head_pair):
    """Three updates under the cosine schedule over three steps: the lr
    factors 1, 0.75 and 0.25; a schedule read one count late would give
    0.75, 0.25 and 0 and miss the second and third losses."""
    d = head_pair
    lr = 1e-3
    zs = [latents(30 + i, (2, 4, 128, 16)) for i in range(STEPS)]
    tgts = [jax_teacher_features(d, z)[0] for z in zs]

    def loss_fn(p, z, tgt):
        out = d["jhead"].apply(p, z)
        ph = ((out["pitch_hist"] - tgt["pitch_hist"]) ** 2).mean()
        nd = ((out["note_density"] - tgt["note_density"]) ** 2).mean()
        ce = optax.softmax_cross_entropy_with_integer_labels(
            out["chord_logits"], tgt["chord_progression"]).mean()
        return 40.0 * ph + nd + ce, (ph, nd, ce)

    jparams, jlosses, grads = jax_adam(
        loss_fn, d["hp"], [(jnp.asarray(z), {k: jnp.asarray(v) for k, v in t.items()})
                           for z, t in zip(zs, tgts)],
        optax.adam(optax.cosine_decay_schedule(lr, STEPS)))
    head = copy.deepcopy(d["head"])
    opt = lambda m: tfeat.make_optimizer(m, lr, STEPS)
    step = tfeat.make_step(head, *opt(head), bf16=False)
    check_steps(head, "head", convert.feature_head_state_dict,
                lambda z, t: step(z, t)[0],
                [(torch.as_tensor(z), {k: torch.as_tensor(v) for k, v in t.items()})
                 for z, t in zip(zs, tgts)], jparams, jlosses, grads, opt)
    assert [tfeat.cosine_decay(STEPS)(i) for i in range(STEPS)] == pytest.approx(
        [1.0, 0.75, 0.25])


def test_feature_group_scores_match_jax(head_pair):
    """The metrics and selection totals (the script's group_scores) on shared
    latents and targets, given the same teacher features."""
    d = head_pair
    k, w = 4, 8
    rng = np.random.default_rng(41)
    z = latents(40, (k, 4, 128, 16))
    targets = {"pitch_hist": np.tile(rng.dirichlet(np.ones(12)), (k, 1)),
               "note_density": np.tile(rng.uniform(1, 5, 2 * w), (k, 1)),
               "chord_progression": np.tile(rng.integers(0, 8, w), (k, 1))}
    targets = {n: v.astype(np.int32 if n.startswith("chord") else np.float32)
               for n, v in targets.items()}
    t_feats, _ = jax_teacher_features(d, z)
    h_feats = {n: np.asarray(v) for n, v in d["jhead"].apply(
        d["hp"], jnp.asarray(z), method=JaxHead.features).items()}

    def total(feats):
        s = 0.0
        for name in tfeat.RULES:
            gen, tgt = feats[name], targets[name]
            loss = (gen != tgt).mean(-1) if name == "chord_progression" else \
                ((gen - tgt) ** 2).mean(-1)
            s = s + tfeat.WEIGHTS[name] * loss
        return s

    fixed = {n: torch.as_tensor(v) for n, v in t_feats.items()}
    tf, th, errs = tfeat.group_scores(lambda _: fixed, d["head"], torch.as_tensor(z),
                                      {n: torch.as_tensor(v) for n, v in targets.items()},
                                      bf16=False)
    np.testing.assert_allclose(tf.numpy(), total(t_feats), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), total(h_feats), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(errs["ph_mse"]), ((t_feats["pitch_hist"]
                               - h_feats["pitch_hist"]) ** 2).mean(), rtol=1e-4)
    np.testing.assert_allclose(float(errs["nd_mse"]), ((t_feats["note_density"]
                               - h_feats["note_density"]) ** 2).mean(), rtol=1e-4)
    assert float(errs["chord_acc"]) == pytest.approx(
        (t_feats["chord_progression"] == h_feats["chord_progression"]).mean())
