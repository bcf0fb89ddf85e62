"""The distill CLIs against the JAX scripts
(``scripts/distill_scoring_{decoder,features}.py``) on the CPU, at small
widths and fp32: the scoring decoder's step and agreement here, with the
npz round trip and both CLIs; the feature head's step and metrics in
test_torch_distill_features.py, the rollout's in
test_torch_distill_rollout.py (each file runs on one worker).

Each JAX script keeps its step inside ``main``; the test writes that step
out as the script has it (optax.adam, and for the head
``optax.cosine_decay_schedule``) and runs it from the JAX initialisation
carried into the port by ``convert.py``, on the same numpy inputs as the
port's step. Tolerances: the losses within 1e-5 (relative and absolute)
at every step, the first step's gradients within 1e-4 of the module's
largest (the port's model tolerance: fp32 reduction order carried back
through the convolutions), and the port's optimizer (torch Adam, with the
schedule where there is one) fed JAX's gradients within 1e-5 of optax's
parameters after the last step. The parameters of the port's own steps
are not held element by element: Adam's update is m / sqrt(v), about
+-lr for any gradient far above eps, so a gradient that is rounding noise
(a conv bias right ahead of a GroupNorm keeps only what the group's mean
removal leaves; the ScoringDecoder has such biases by construction) or
that changes sign between steps moves its parameter by up to lr either
way (up to 2.5e-3 seen after three steps).

The npz round trip runs both ways: the port's file through the JAX
package's ``_load_scoring_npz`` + ``apply``, JAX's file through the port's
``ScoringBundle.create``, outputs within 1e-5, key sets and shapes equal.
Each CLI also runs end to end at a tiny size.
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.diffusion.latent import make_decode_fn as jdecode_fn
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import RuleFeatureHead as JaxHead
from rule_guided_music_tpu.models import ScoringDecoder as JaxScoringDecoder
from rule_guided_music_tpu.pipeline import _load_scoring_npz as jload_scoring
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.utils.fixtures import flatten_tree
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch import distill_scoring_decoder as tdec
from rule_guided_music_tpu_torch import distill_scoring_features as tfeat
from rule_guided_music_tpu_torch.models.scoring_head import RuleFeatureHead
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL, ScoringDecoder
from rule_guided_music_tpu_torch.training import distill

TOL = dict(rtol=1e-5, atol=1e-5)
TEACHER_CH, CH, HEAD = 32, 16, dict(ch=16, depth=2)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def jax_init(model, *args, seed=0, **kw):
    return np_tree(model.init(jax.random.PRNGKey(seed), *args, **kw))


def to_port(module, params, convert_fn):
    module.load_state_dict(convert_fn(flatten_tree(params)))
    return module


def jax_adam(loss_fn, params, batches, opt):
    """The scripts' step: value_and_grad, opt.update, apply_updates;
    returns (params, losses, grads of every step as flat dicts)."""
    @jax.jit
    def step(p, s, *batch):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, *batch)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss, grads

    state, losses, grads = opt.init(params), [], []
    for batch in batches:
        params, state, loss, g = step(params, state, *batch)
        losses.append(float(loss))
        grads.append(flatten_tree(np_tree(g)))
    return np_tree(params), losses, grads


def grads_flax(module, kind):
    """The gradients ``backward`` left on ``module`` as a flat Flax tree."""
    holder = copy.deepcopy(module)
    for p, q in zip(holder.parameters(), module.parameters()):
        p.data = q.grad.detach().clone()
    return convert.flax_params(holder, kind)


def check_steps(module, kind, to_sd, port_step, batches, jparams, jlosses, jgrads,
                make_optimizer):
    """The port's steps against JAX's (``jax_adam``'s outputs): the losses
    within TOL at every step; the first step's gradients within 1e-4 of
    the module's largest; and the port's optimizer, fed JAX's gradients
    from JAX's initial weights, within TOL of optax's parameters."""
    start = copy.deepcopy(module.state_dict())
    losses, grads = [], None
    for batch in batches:
        losses.append(float(port_step(*batch)))
        grads = grads or grads_flax(module, kind)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    largest = max(np.abs(g).max() for g in jgrads[0].values())
    for key, g in jgrads[0].items():
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=1e-4 * largest,
                                   err_msg=key)
    # the optimizer alone, on JAX's gradients
    module.load_state_dict(start)
    optimizer, scheduler = make_optimizer(module)
    named = dict(module.named_parameters())
    for step_grads in jgrads:
        for name, g in to_sd(step_grads).items():
            named[name].grad = g.clone()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    got, want = convert.flax_params(module, kind), flatten_tree(jparams)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def latents(seed, shape, std=1.0 / 1.2465):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# --- the scoring decoder -----------------------------------------------------


@pytest.fixture(scope="module")
def decoder_pair():
    jteacher, jstudent = JaxVAE(ch=TEACHER_CH), JaxScoringDecoder(ch=CH)
    tp = jax_init(jteacher, jnp.zeros((1, 3, 128, 128)), seed=1,
                  rng=jax.random.PRNGKey(2))
    sp = jax_init(jstudent, jnp.zeros((1, 4, 16, 16)), seed=3)
    teacher = to_port(AutoencoderKL(ch=TEACHER_CH), tp, convert.vae_state_dict).eval()
    student = to_port(ScoringDecoder(ch=CH), sp, convert.vae_state_dict)
    return dict(jteacher=jteacher, jstudent=jstudent, tp=tp, sp=sp, teacher=teacher,
                student=student)


@pytest.fixture(scope="module")
def head_pair(decoder_pair):
    jhead = JaxHead(**HEAD)
    hp = jax_init(jhead, jnp.zeros((1, 4, 128, 16)), seed=3)
    head = to_port(RuleFeatureHead(**HEAD), hp, convert.feature_head_state_dict)
    return dict(decoder_pair, jhead=jhead, hp=hp, head=head)


def test_decoder_distill_steps_match_optax(decoder_pair):
    d = decoder_pair
    lr = 2e-3
    zs = [latents(10 + i, (2, 4, 16, 16)) for i in range(STEPS)]
    jtargets = [np.asarray(d["jteacher"].apply(d["tp"], jnp.asarray(z),
                                               method=JaxVAE.decode)) for z in zs]
    with torch.no_grad():
        ttargets = [d["teacher"].decode(torch.as_tensor(z)) for z in zs]
    for a, b in zip(ttargets, jtargets):
        np.testing.assert_allclose(a.numpy(), b, **TOL)

    def loss_fn(p, z, target):
        rec = d["jstudent"].apply(p, z, method=JaxScoringDecoder.decode)
        return jnp.abs(rec - target).mean(), None

    jparams, jlosses, grads = jax_adam(loss_fn, d["sp"], [
        (jnp.asarray(z), jnp.asarray(t)) for z, t in zip(zs, jtargets)],
        optax.adam(lr))
    student = copy.deepcopy(d["student"])
    adam = lambda m: (torch.optim.Adam(m.parameters(), lr=lr), None)
    check_steps(student, "vae", convert.vae_state_dict,
                tdec.make_step(student, adam(student)[0], bf16=False),
                [(torch.as_tensor(z), torch.as_tensor(t)) for z, t in zip(zs, jtargets)],
                jparams, jlosses, grads, adam)


def test_decoder_group_losses_match_jax(decoder_pair):
    """The agreement gate's per-candidate losses and rule MSEs (the script's
    group_losses) on shared latents and targets."""
    d = decoder_pair
    k = 2
    rng = np.random.default_rng(5)
    z_img = latents(6, (k, 4, 128, 16))
    ph = np.tile(rng.dirichlet(np.ones(12)), (k, 1)).astype(np.float32)
    nd = np.tile(rng.uniform(1, 5, 16), (k, 1)).astype(np.float32)
    full = jdecode_fn(lambda c: d["jteacher"].apply(d["tp"], c, method=JaxVAE.decode))
    light = jdecode_fn(lambda c: d["jstudent"].apply(d["sp"], c,
                                                     method=JaxScoringDecoder.decode))
    rf, rl = full(jnp.asarray(z_img)), light(jnp.asarray(z_img))
    want = {}
    for name, tgt in (("pitch_hist", ph), ("note_density", nd)):
        vf, vl = JFUNC[name](rf), JFUNC[name](rl)
        want[f"{name}_f"] = ((vf - tgt) ** 2).mean(axis=-1)
        want[f"{name}_l"] = ((vl - tgt) ** 2).mean(axis=-1)
        want[f"{name}_mse"] = ((vf - vl) ** 2).mean()
    got = tdec.group_losses(d["teacher"], d["student"], torch.as_tensor(z_img),
                            torch.as_tensor(ph), torch.as_tensor(nd), bf16=False)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    total = lambda o, s: np.asarray(o[f"pitch_hist_{s}"]) * 40 + np.asarray(
        o[f"note_density_{s}"])
    assert tdec.group_agrees(got) == (int(np.argmin(total(want, "f")))
                                      == int(np.argmin(total(want, "l"))))


# --- the npz both ways, and the CLIs -----------------------------------------


@pytest.mark.parametrize("kind", ["decoder", "features"])
def test_npz_round_trip_both_ways(tmp_path, decoder_pair, head_pair, kind):
    """The port's file loads in JAX's pipeline and JAX's file in the port's
    ScoringBundle.create: same keys, shapes and dtypes, and the same outputs
    within 1e-5 on a shared input."""
    d = head_pair
    if kind == "decoder":
        jmodel, jp, module, vkind = d["jstudent"], d["sp"], d["student"], "vae"
        x = latents(50, (2, 4, 16, 16))
        japply = lambda p: np.asarray(jmodel.apply(p, jnp.asarray(x),
                                                   method=JaxScoringDecoder.decode))
        bundle_kw = lambda path: dict(decoder_path=path)
        tapply = lambda b: b.decoder.decode(torch.as_tensor(x)).numpy()
    else:
        jmodel, jp, module, vkind = d["jhead"], d["hp"], d["head"], "head"
        x = latents(51, (2, 4, 128, 16))
        japply = lambda p: np.asarray(jmodel.apply(p, jnp.asarray(x))["pitch_hist"])
        bundle_kw = lambda path: dict(features_path=path)
        tapply = lambda b: b.feature_head(torch.as_tensor(x))["pitch_hist"].numpy()
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    distill.write_npz(str(ours), module, vkind, 0.5)
    # the JAX scripts' writer
    np.savez_compressed(theirs, agreement=np.float32(0.25), **flatten_tree(jp))
    a, b = np.load(ours), np.load(theirs)
    assert set(a.files) == set(b.files)
    for key in a.files:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
    tree, meta = jload_scoring(str(ours))
    assert meta == {"agreement": 0.5}
    want = japply(jp)
    np.testing.assert_allclose(japply(tree), want, **TOL)
    bundle = pipeline.ScoringBundle.create(**bundle_kw(str(theirs)),
                                           dtype=torch.float32, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(tapply(bundle), want, **TOL)


TINY = ["--steps", "2", "--agree_groups", "2", "--k", "4", "--bf16", "False",
        "--device", "cpu", "--batch", "2"]


@pytest.mark.parametrize("cli", ["decoder", "features"])
def test_cli_end_to_end_tiny(tmp_path, cli):
    """``main`` at a tiny size: a finite loss logged, the agreement printed
    and written, and the npz loading through ScoringBundle.create to the
    trained module's outputs."""
    if cli == "decoder":
        res = tdec.main(["--teacher_ch", "32", "--ch", "16", *TINY,
                         "--out", str(tmp_path / "ch{ch}.npz")])
        assert res["out"].endswith("ch16.npz")
        bundle = pipeline.ScoringBundle.create(decoder_path=res["out"],
                                               dtype=torch.float32, device="cpu")
        x = torch.as_tensor(latents(60, (2, 4, 16, 16)))
        run = lambda m: m.decode(x)
        loaded = bundle.decoder
    else:
        res = tfeat.main(["--teacher_ch", "32", "--ch", "16", "--depth", "2", *TINY,
                          "--out", str(tmp_path / "ch{ch}.npz")])
        bundle = pipeline.ScoringBundle.create(features_path=res["out"],
                                               dtype=torch.float32, device="cpu")
        x = torch.as_tensor(latents(61, (2, 4, 128, 16)))
        run = lambda m: m(x)["pitch_hist"]
        loaded = bundle.feature_head
    assert [s for s, _ in res["losses"]] == [0]
    assert all(math.isfinite(v) for _, v in res["losses"])
    assert len(res["step_ms"]) == 2
    assert bundle.agreements[next(iter(bundle.agreements))] == pytest.approx(
        res["agreement"])
    with torch.no_grad():
        assert torch.equal(run(loaded), run(res["student"]))
    assert os.path.getsize(res["out"]) > 0
