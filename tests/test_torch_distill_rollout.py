"""The rollout distill against ``scripts/distill_scoring_rollout.py`` on
the CPU: DiTRotary_XS_8 for teacher and student (the registries' smallest
name), three classes, no learned sigma, fp32. The random teacher's
perturbation equals the JAX script's tree; three x̂0-MSE steps from JAX's
initialisation match optax's (test_torch_distill.py's harness and
tolerances); the agreement gate's group ranks match on shared inputs; and
the CLI runs end to end at a tiny size.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.diffusion import gaussian as jgd
from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jdecode_fn
from rule_guided_music_tpu.diffusion.schedule import make_schedule as jmake_schedule
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import flatten_tree
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch import distill_scoring_rollout as troll
from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL
from test_torch_distill import (STEPS, TOL, check_steps, few_threads,  # noqa: F401
                                jax_adam, jax_init, np_tree, to_port)

NAME = "DiTRotary_XS_8"
KW = dict(input_size=(128, 16), in_channels=4, num_classes=3, learn_sigma=False)


def jax_dit_init(seed):
    model = JaxDiT[NAME](**KW)
    return model, jax_init(model, jnp.zeros((1, 4, 128, 16)), jnp.zeros((1,)),
                           jnp.zeros((1,), jnp.int32), seed=seed)


def jax_perturbed(params, seed):
    """The JAX script's random teacher (:83-91)."""
    rngp = np.random.default_rng(seed)
    return np_tree(jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.02 * rngp.standard_normal(a.shape), dtype=a.dtype),
        params))


@pytest.fixture(scope="module")
def pair():
    jteacher, tp = jax_dit_init(1)
    tp = jax_perturbed(tp, 0)
    jstudent, sp = jax_dit_init(2)
    teacher = to_port(DiT_models[NAME](**KW), tp, convert.dit_state_dict).eval()
    student = to_port(DiT_models[NAME](**KW), sp, convert.dit_state_dict)
    return dict(jteacher=jteacher, tp=tp, jstudent=jstudent, sp=sp, teacher=teacher,
                student=student, jtables=jmake_schedule("linear", 1000).tables(),
                tables=make_schedule("linear", 1000).tables("cpu"))


@pytest.mark.parametrize("seed", [0, 7])
def test_teacher_perturbation_matches_jax(seed):
    """``perturb_`` walks the Flax paths in ``jax.tree_util``'s leaf order
    (every dict's keys sorted), whatever the state_dict's order: the
    perturbed trees are equal, leaf for leaf."""
    _, params = jax_dit_init(1)
    paths = [tuple(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert paths == sorted(paths)
    # the state_dict's order is another one: a walk in its order would differ
    in_state_dict_order = [tuple(("params/" + convert.flax_path(
        n, tuple(p.shape), "dit", n.endswith("embedding_table.weight"))[0]).split("/"))
        for n, p in DiT_models[NAME](**KW).named_parameters()]
    assert sorted(in_state_dict_order) == paths != in_state_dict_order
    model = to_port(DiT_models[NAME](**KW), params, convert.dit_state_dict)
    troll.perturb_(model, seed)
    got, want = convert.flax_params(model, "dit"), flatten_tree(jax_perturbed(params, seed))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def batch(seed, b=2, t_max=750, num_classes=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, 128, 16)).astype(np.float32),
            rng.integers(0, t_max, b), rng.integers(0, num_classes, b))


def test_rollout_distill_steps_match_optax(pair):
    d = pair
    lr = 1e-3
    jt = d["jtables"]

    def jx0(model, p, x_t, t, y):
        eps = model.apply(p, x_t, jt.model_t[t], y)
        return jgd.predict_xstart_from_eps(jt, x_t, t, eps)

    batches = [batch(70 + i) for i in range(STEPS)]
    jtargets = [np.asarray(jx0(d["jteacher"], d["tp"], jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(y, jnp.int32))) for x, t, y in batches]
    with torch.no_grad():
        ttargets = [troll.x0_from(d["teacher"], d["tables"], torch.as_tensor(x),
                                  torch.as_tensor(t), torch.as_tensor(y), bf16=False)
                    for x, t, y in batches]
    for a, b in zip(ttargets, jtargets):
        np.testing.assert_allclose(a.numpy(), b, **TOL)

    def loss_fn(p, x_t, t, y, target):
        return ((jx0(d["jstudent"], p, x_t, t, y) - target) ** 2).mean(), None

    jparams, jlosses, grads = jax_adam(loss_fn, d["sp"], [
        (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y, jnp.int32), jnp.asarray(tg))
        for (x, t, y), tg in zip(batches, jtargets)], optax.adam(lr))
    student = copy.deepcopy(d["student"])
    adam = lambda m: (torch.optim.Adam(m.parameters(), lr=lr), None)
    check_steps(student, "dit", convert.dit_state_dict,
                troll.make_step(student, adam(student)[0], d["tables"], bf16=False),
                [(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(y),
                  torch.as_tensor(tg)) for (x, t, y), tg in zip(batches, jtargets)],
                jparams, jlosses, grads, adam)


def test_gate_group_rank_matches_jax(pair):
    """The gate's group (the script's group_rank) on a shared x_t, t and
    target: the same argmins, and the rank-loss MSE and spread within
    1e-4 relative, through a ch=16 VAE."""
    d = pair
    k = 2
    jvae = JaxVAE(ch=16)
    vp = jax_init(jvae, jnp.zeros((1, 3, 128, 128)), seed=3, rng=jax.random.PRNGKey(4))
    vae = to_port(AutoencoderKL(ch=16), vp, convert.vae_state_dict).eval()
    rng = np.random.default_rng(80)
    x_t = rng.standard_normal((k, 4, 128, 16)).astype(np.float32)
    t = np.full(k, 300)
    ph = np.tile(rng.dirichlet(np.ones(12)), (k, 1)).astype(np.float32)
    jt = d["jtables"]
    dec = jdecode_fn(lambda c: jvae.apply(vp, c, method=JaxVAE.decode))
    losses = {}
    for name, model, p in (("t", d["jteacher"], d["tp"]), ("s", d["jstudent"], d["sp"])):
        eps = model.apply(p, jnp.asarray(x_t), jt.model_t[t], jnp.zeros(k, jnp.int32))
        x0 = jgd.predict_xstart_from_eps(jt, jnp.asarray(x_t), jnp.asarray(t), eps)
        losses[name] = np.asarray(((JFUNC["pitch_hist"](dec(x0)) - ph) ** 2).mean(-1))
    a, b, mse, spread = troll.group_rank(d["teacher"], d["student"], vae, d["tables"],
                                         torch.as_tensor(x_t), torch.as_tensor(t),
                                         torch.as_tensor(ph), bf16=False)
    assert (a, b) == (int(np.argmin(losses["t"])), int(np.argmin(losses["s"])))
    assert mse == pytest.approx(float(((losses["t"] - losses["s"]) ** 2).mean()),
                                rel=1e-4, abs=1e-9)
    assert spread == pytest.approx(float(losses["t"].max() - losses["t"].min()),
                                   rel=1e-4, abs=1e-9)


def test_rollout_cli_end_to_end_tiny(tmp_path):
    res = troll.main(["--teacher", NAME, "--student", NAME, "--vae_ch", "32",
                      "--steps", "2", "--agree_groups", "2", "--k", "4", "--batch", "2",
                      "--bf16", "False", "--device", "cpu",
                      "--out", str(tmp_path / "{student}.npz")])
    assert res["out"].endswith(f"{NAME}.npz")
    assert [s for s, _ in res["losses"]] == [0] and math.isfinite(res["losses"][0][1])
    bundle = pipeline.ScoringBundle.create(rollout=NAME, rollout_path=res["out"],
                                           num_classes=3, dtype=torch.float32,
                                           device="cpu")
    x, t, y = (torch.as_tensor(a) for a in batch(90))
    with torch.no_grad():
        assert torch.equal(bundle.rollout(x, t.float(), y), res["student"](x, t.float(), y))
    assert bundle.agreements["scoring_rollout"] == pytest.approx(res["agreement"])
