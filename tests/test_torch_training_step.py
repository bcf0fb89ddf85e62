"""One train step of the port against the JAX package's on the same
parameters, batch, t, noise and label-dropout mask (CPU): the DiT step
(fp32, bf16, microbatches, a skipped NaN step, the LR anneal), the EMA
eval loss, and the VAE step with and without the patch-GAN and LPIPS.

The JAX step draws its noise and its dropout mask from the key it is
given; the test draws the same noise with JAX and reads JAX's mask from
the label embedder's output, then hands both to the port's step.
Parameters start from JAX's ``model.init`` with a seeded perturbation of
every leaf (so the zero-initialised adaLN and final layers are functions
and every parameter gets a gradient), converted by ``convert.py``.

Tolerances. fp32: 1e-5 (relative and absolute) on the loss, the gradient
norm, the per-example losses, the parameters after the update and the
EMA; Adam's first update is lr * g / (|g| + eps), about +-lr whatever
|g|, so the parameters agree as long as no gradient's sign is within
rounding of 0 (none is here). bf16: JAX rounds every op's output to
bf16 (flax modules with ``dtype=bfloat16``), the port runs under
``torch.autocast`` (bf16 matmuls, fp32 norms and elementwise ops), so
the two differ by bf16 rounding (2^-8 relative per rounding) carried
through the blocks; the loss and the per-example losses are held within
2e-3 relative (1.5e-4 observed), the gradient norm within 1e-2 (5.8e-5
observed), and the update (params after minus before, and likewise the
EMA) by its direction: cosine similarity >= 0.99 with JAX's (0.9967
observed), since Adam's first update turns every gradient element into
+-lr and elements whose gradient is within bf16 noise of 0 may take
either sign (0.2% of them do here).

The VAE has such gradients by construction (a conv bias right before a
GroupNorm keeps only what the group's mean removal leaves; the mid
attention's key bias none at all, softmax being shift-invariant), so its
step is held element by element. The gradients, read from both Adams'
first moments ((1 - b1) g after one step), within 1e-4 of the module's
largest gradient, the port's model tolerance (fp32 reduction order
carried back through ~40 convolutions and, where on, the discriminator
or VGG: 1.2e-5 of it observed, up to 3.5e-4 of a small tensor's own
largest); where |g| >= 1e-3 of that largest, far from 0 and from eps,
the parameters after the update within 1e-5; elsewhere the update no
larger than 2 lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.training import train_loop as jtl
from rule_guided_music_tpu.training.perceptual import LPIPS as JaxLPIPS
from rule_guided_music_tpu.training.vae_train import NLayerDiscriminator as JaxDisc
from rule_guided_music_tpu.training.vae_train import VAETrainConfig as JaxVAEConfig
from rule_guided_music_tpu.training.vae_train import make_vae_train_steps as jvae_steps
from rule_guided_music_tpu.utils.fixtures import flatten_tree, unflatten_tree
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL
from rule_guided_music_tpu_torch.training import train_loop as ttl
from rule_guided_music_tpu_torch.training.perceptual import LPIPS
from rule_guided_music_tpu_torch.training.vae_train import (NLayerDiscriminator,
                                                            VAETrainConfig,
                                                            make_vae_train_steps)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4
NUM_CLASSES = 3


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    flat = {k: np.asarray(v) + scale * rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in flatten_tree(params).items()}
    return flat, jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))


def _dit_setup(seed=0, learn_sigma=False):
    jmodel = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                     num_classes=NUM_CLASSES, learn_sigma=learn_sigma)
    x = jnp.zeros((1, 4, 128, 16))
    params = jmodel.init({"params": jax.random.PRNGKey(seed),
                          "label_dropout": jax.random.PRNGKey(seed + 1)},
                         x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32), train=True)
    flat, params = _perturbed(params, seed + 10)
    model = DiT_models["DiTRotary_XS_8"](num_classes=NUM_CLASSES,
                                         learn_sigma=learn_sigma)
    model.load_state_dict(convert.dit_state_dict(flat), strict=True)
    return jmodel, params, model


def _batch(seed, tables_n=1000):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 4, 128, 16)).astype(np.float32)
    t = rng.integers(0, tables_n, size=B).astype(np.int32)
    w = (0.5 + rng.random(B)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, size=B).astype(np.int32)
    return lat, t, w, y


def _jax_draws(jmodel, params, key, lat, y, n_micro, dtype=None):
    """The noise and the dropout mask JAX's step draws from ``key``
    (split per microbatch as its scan does); the mask read from the label
    embedder's output against the null row."""
    keys = jax.random.split(key, n_micro) if n_micro > 1 else [key]
    m = lat.shape[0] // n_micro
    noise, drop = [], []
    table = np.asarray(params["params"]["y_embedder"]["embedding_table"])
    for i, k in enumerate(keys):
        noise_rng, dropout_rng = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(noise_rng, (m,) + lat.shape[1:])))
        _, inter = jmodel.apply(params, jnp.asarray(lat[i * m:(i + 1) * m]),
                                jnp.zeros((m,)), jnp.asarray(y[i * m:(i + 1) * m]),
                                train=True, rngs={"label_dropout": dropout_rng},
                                capture_intermediates=True, mutable=["intermediates"])
        emb = np.asarray(inter["intermediates"]["y_embedder"]["__call__"][0],
                         dtype=np.float32)
        null = table[NUM_CLASSES].astype(emb.dtype)
        if dtype is not None:
            null = np.asarray(jnp.asarray(table[NUM_CLASSES]).astype(dtype), np.float32)
        drop.append(np.all(emb == null, axis=1))
    return np.concatenate(noise), np.concatenate(drop)


def _run_both(config_kw, steps=1, bf16=False, nan=False, seed=0, learn_sigma=False):
    """``steps`` steps of JAX's make_train_step and the port's, from the
    same parameters and inputs. Returns (jax state, jax metrics, port
    state, port metrics, params before) of the last step."""
    jmodel, params, model = _dit_setup(seed, learn_sigma)
    if bf16:
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
    jtables = jschedule.make_schedule("linear", 1000).tables()
    ttables = tschedule.make_schedule("linear", 1000).tables("cpu")
    var = "LEARNED_RANGE" if learn_sigma else "FIXED_LARGE"
    loss = "RESCALED_MSE" if learn_sigma else "MSE"
    jcfg = jtl.TrainConfig(**config_kw, var_type=getattr(jtl.gd.ModelVarType, var),
                           loss_type=getattr(jtl.gd.LossType, loss))
    tcfg = ttl.TrainConfig(**config_kw, var_type=getattr(ttl.gd.ModelVarType, var),
                           loss_type=getattr(ttl.gd.LossType, loss))
    optimizer = jtl.make_optimizer(jcfg)

    def model_apply(p, x, model_t, y, rng):
        return jmodel.apply(p, x, model_t, y, train=True, rngs={"label_dropout": rng})

    jstep = jax.jit(jtl.make_train_step(model_apply, jtables, optimizer, jcfg))
    jstate = {"params": params,
              "ema_params": jax.tree_util.tree_map(jnp.copy, params),
              "opt_state": optimizer.init(params), "step": jnp.zeros((), jnp.int32)}
    tstate = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                            optimizer=ttl.make_optimizer(tcfg, model.parameters()))
    tstep = ttl.make_train_step(model, ttables, tcfg,
                                torch.bfloat16 if bf16 else None)
    n_micro = (max(B // tcfg.microbatch, 1) if tcfg.microbatch > 0 else 1)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for s in range(steps):
        lat, t, w, y = _batch(100 + s)
        if nan:
            lat[1, 0, 3, 3] = np.nan
        key = jax.random.PRNGKey(50 + s)
        noise, drop = _jax_draws(jmodel, jstate["params"], key, lat, y, n_micro,
                                 jnp.bfloat16 if bf16 else None)
        with jax.default_matmul_precision("highest"):
            jstate, jm = jstep(jstate, jnp.asarray(lat), jnp.asarray(t),
                               jnp.asarray(w), jnp.asarray(y), key)
        T = torch.as_tensor
        tm = tstep(tstate, T(lat), T(t).long(), T(w), T(y).long(), T(noise), T(drop))
    return jstate, jm, tstate, tm, before


def _flat_port(named):
    return {k: v.detach().float().numpy() for k, v in named}


def _flat_jax(tree):
    sd = convert.dit_state_dict(flatten_tree(tree))
    return {k: v.numpy() for k, v in sd.items()}


def _assert_state_close(jstate, tstate, tol=TOL):
    jp, je = _flat_jax(jstate["params"]), _flat_jax(jstate["ema_params"])
    tp = _flat_port(tstate.model.named_parameters())
    te = _flat_port(tstate.ema_params.items())
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **tol)
        np.testing.assert_allclose(te[k], je[k], err_msg=k, **tol)


def _assert_metrics_close(jm, tm, tol=TOL):
    for key in ("loss", "grad_norm", "param_norm", "skipped", "per_example_loss",
                "per_example_mse", "vb"):
        if key in jm:
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                       err_msg=key, **tol)
    assert sorted(tm) == sorted(jm)


@pytest.mark.parametrize("learn_sigma", [False, True])
def test_fp32_dit_step_matches_jax(learn_sigma):
    """DiTRotary_XS_8, class-conditional, AdamW with weight decay; with
    learn_sigma the RESCALED_MSE + vb loss."""
    jstate, jm, tstate, tm, _ = _run_both(dict(lr=1e-4, weight_decay=0.01,
                                               ema_rate=0.9), learn_sigma=learn_sigma)
    _assert_metrics_close(jm, tm)
    _assert_state_close(jstate, tstate)
    assert tstate.step == 1 == int(jstate["step"]) and tstate.updates == 1


def test_fp32_dit_microbatches_match_jax():
    """microbatch=2: two microbatches, gradients summed then halved, the
    per-example terms in batch order; then a second step."""
    jstate, jm, tstate, tm, _ = _run_both(dict(lr=1e-4, microbatch=2, ema_rate=0.9),
                                          steps=2)
    _assert_metrics_close(jm, tm)
    _assert_state_close(jstate, tstate)


def test_lr_anneal_matches_jax():
    """lr_anneal_steps=3: the updates use lr, 2/3 lr, 1/3 lr, as optax's
    linear schedule."""
    jstate, jm, tstate, tm, _ = _run_both(dict(lr=1e-3, lr_anneal_steps=3,
                                               ema_rate=0.9), steps=3)
    _assert_metrics_close(jm, tm)
    _assert_state_close(jstate, tstate)
    assert ttl.lr_at(ttl.TrainConfig(lr=1e-3, lr_anneal_steps=3), 2) == \
        pytest.approx(float(optax.linear_schedule(1e-3, 0.0, 3)(2)))


def test_nan_step_is_skipped_as_in_jax():
    """A NaN in the batch: both skip; params, EMA and the optimizer's
    state stay bit for bit as they were, the step count moves."""
    jstate, jm, tstate, tm, before = _run_both(dict(lr=1e-4, ema_rate=0.9), nan=True)
    assert float(jm["skipped"]) == 1.0 == float(tm["skipped"])
    assert not np.isfinite(float(tm["grad_norm"]))
    for k, v in tstate.model.named_parameters():
        assert torch.equal(v, before[k])
        assert torch.equal(tstate.ema_params[k], before[k])
    assert tstate.optimizer.state_dict()["state"] == {}
    assert tstate.step == 1 and tstate.updates == 0
    _assert_state_close(jstate, tstate, dict(rtol=0, atol=0))


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bf16_dit_step_matches_jax():
    """bf16 compute over fp32 masters in both: autocast in the port,
    bf16 flax modules in JAX (tolerances in the module docstring)."""
    jstate, jm, tstate, tm, before = _run_both(dict(lr=1e-4, ema_rate=0.9), bf16=True)
    for key in ("loss", "per_example_loss", "per_example_mse"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   rtol=2e-3, err_msg=key)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-2)
    start = {k: v.numpy() for k, v in before.items()}
    jp, je = _flat_jax(jstate["params"]), _flat_jax(jstate["ema_params"])
    tp = _flat_port(tstate.model.named_parameters())
    te = _flat_port(tstate.ema_params.items())
    keys = sorted(start)
    dj = np.concatenate([(jp[k] - start[k]).ravel() for k in keys])
    dt = np.concatenate([(tp[k] - start[k]).ravel() for k in keys])
    ej = np.concatenate([(je[k] - start[k]).ravel() for k in keys])
    et = np.concatenate([(te[k] - start[k]).ravel() for k in keys])
    assert _cos(dt, dj) >= 0.99 and _cos(et, ej) >= 0.99, (_cos(dt, dj), _cos(et, ej))
    assert all(p.dtype == torch.float32 for p in tstate.model.parameters())


def test_eval_loss_step_matches_jax():
    """The EMA eval loss: forward only, under the EMA parameters, label
    dropout on (as JAX's eval step calls the train-mode apply)."""
    jmodel, params, model = _dit_setup(3)
    jtables = jschedule.make_schedule("linear", 1000).tables()
    ttables = tschedule.make_schedule("linear", 1000).tables("cpu")

    def model_apply(p, x, model_t, y, rng):
        return jmodel.apply(p, x, model_t, y, train=True, rngs={"label_dropout": rng})

    lat, t, _, y = _batch(7)
    key = jax.random.PRNGKey(9)
    noise, drop = _jax_draws(jmodel, params, key, lat, y, 1)
    with jax.default_matmul_precision("highest"):
        want = jtl.make_eval_loss_step(model_apply, jtables, jtl.TrainConfig())(
            params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(y), key)
    ema = ttl.init_ema(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)                         # the live weights are not used
    T = torch.as_tensor
    got = ttl.make_eval_loss_step(model, ttables, ttl.TrainConfig())(
        ema, T(lat), T(t).long(), T(y).long(), T(noise), T(drop))
    for key_ in want:
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]), **TOL)


# -- the VAE step ----------------------------------------------------------

VAE_ARCH = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1)   # GroupNorm(32): 2-4 channels a group


def _vae_setup(disc, lpips):
    x = jnp.zeros((2, 3, 32, 32))
    jvae = JaxVAE(**VAE_ARCH)
    vparams = jvae.init(jax.random.PRNGKey(0), x, rng=jax.random.PRNGKey(1))
    vae = AutoencoderKL(**VAE_ARCH, encoder=True)
    vae.load_state_dict(convert.vae_state_dict(flatten_tree(vparams), encoder=True))
    out = dict(jvae=jvae, vparams=vparams, vae=vae, jdisc=None, dparams=None,
               disc=None, jlp=None, lparams=None, lpips=None)
    if disc:
        out["jdisc"] = JaxDisc(ndf=8)
        out["dparams"] = out["jdisc"].init(jax.random.PRNGKey(2), x)
        out["disc"] = NLayerDiscriminator(ndf=8)
        out["disc"].load_state_dict(convert.discriminator_state_dict(
            flatten_tree(out["dparams"])))
    if lpips:
        out["jlp"] = JaxLPIPS()
        out["lparams"] = out["jlp"].init(jax.random.PRNGKey(3), x, x)
        out["lpips"] = LPIPS()
        out["lpips"].load_state_dict(convert.lpips_state_dict(
            flatten_tree(out["lparams"])))
    return out


@pytest.mark.parametrize("disc,lpips", [(False, False), (True, False), (False, True)],
                         ids=["l1_kl", "patch_gan", "lpips"])
def test_vae_step_matches_jax(disc, lpips):
    """L1 + KL (the released config); with the patch-GAN from step 0
    (disc_start 0, disc_weight 0.5: the generator term, then the
    discriminator's hinge step on a fresh posterior draw); with LPIPS
    (perceptual_weight 0.5, random weights carried across). fp32, the
    posterior noise fed to both."""
    s = _vae_setup(disc, lpips)
    kw = dict(lr=1e-4, kl_weight=1e-2, disc_weight=0.5 if disc else 0.0,
              disc_start=0, perceptual_weight=0.5 if lpips else 0.0)
    ae_opt, disc_opt, jae, jdisc_step = jvae_steps(s["jvae"], JaxVAEConfig(**kw),
                                                   s["jdisc"], lpips=s["jlp"])
    tae_opt, tdisc_opt, tae, tdisc_step = make_vae_train_steps(s["vae"], VAETrainConfig(**kw),
                                                 s["disc"], lpips=s["lpips"])
    rng = np.random.default_rng(4)
    batch = np.clip(rng.standard_normal((2, 3, 32, 32)) * 0.7, -1, 1).astype(np.float32)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    noise1, noise2 = (np.asarray(jax.random.normal(k, (2, 4, 16, 16))) for k in (k1, k2))
    with jax.default_matmul_precision("highest"):
        vparams, vopt, jaux = jae(s["vparams"], ae_opt.init(s["vparams"]),
                                  s["dparams"], jnp.asarray(batch), k1, jnp.int32(0),
                                  s["lparams"])
        if disc:
            dparams, dopt, jd = jdisc_step(s["dparams"], disc_opt.init(s["dparams"]),
                                           vparams, jnp.asarray(batch), k2)
            jaux.update(jd)
    T = torch.as_tensor
    taux = tae(T(batch), 0, noise=T(noise1))
    if disc:
        taux.update(tdisc_step(T(batch), noise=T(noise2)))
    assert sorted(taux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), err_msg=key, **TOL)
    _assert_adam_step(s["vae"], tae_opt, convert.vae_state_dict(
        flatten_tree(vparams), encoder=True), convert.vae_state_dict(
        flatten_tree(vopt[0].mu), encoder=True), kw["lr"])
    if disc:
        _assert_adam_step(s["disc"], tdisc_opt, convert.discriminator_state_dict(
            flatten_tree(dparams)), convert.discriminator_state_dict(
            flatten_tree(dopt[0].mu)), kw["lr"])
    if lpips:
        assert all(p.grad is None for p in s["lpips"].parameters())


def _assert_adam_step(module, opt, want_params, want_mu, lr):
    """One Adam step, element by element (see the module docstring)."""
    gmax = max(float(np.abs(v.numpy()).max()) for v in want_mu.values())
    for name, p in module.named_parameters():
        mu, jmu = opt.state[p]["exp_avg"].numpy(), want_mu[name].numpy()
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-4 * gmax, err_msg=name)
        clear = np.abs(jmu) >= 1e-3 * gmax
        got, want = p.detach().numpy(), want_params[name].numpy()
        np.testing.assert_allclose(got[clear], want[clear], err_msg=name, **TOL)
        assert np.all(np.abs(got - want)[~clear] <= 2 * lr * (1 + 1e-5)), name


def test_lpips_loads_torch_files_and_matches_jax(tmp_path):
    """LPIPS from torchvision-layout and taming-layout state dicts saved
    with torch.save (as --lpips_vgg_path/--lpips_lins_path name them)
    equals JAX's LPIPS on JAX's converter of the same dicts."""
    from rule_guided_music_tpu.training.perceptual import convert_torch_lpips

    rng = np.random.default_rng(5)
    lp = LPIPS()
    vgg = {k: T_(rng.standard_normal(v.shape) * 0.05) for k, v in lp.net.state_dict().items()}
    lins = {f"lins.{i}.model.1.weight": T_(np.abs(rng.standard_normal(
        getattr(lp, f"lin{i}").model[1].weight.shape))) for i in range(5)}
    torch.save(vgg, tmp_path / "vgg.pt")
    torch.save(lins, tmp_path / "lins.pth")
    lp.load_torch(torch.load(tmp_path / "vgg.pt"), torch.load(tmp_path / "lins.pth"))
    x = np.clip(rng.standard_normal((2, 3, 32, 32)) * 0.5, -1, 1).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert_torch_lpips(
        {k: v.numpy() for k, v in vgg.items()}, {k: v.numpy() for k, v in lins.items()}))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxLPIPS().apply(jparams, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = lp(torch.as_tensor(x), torch.as_tensor(y)).numpy()
        assert torch.all(lp(torch.as_tensor(x), torch.as_tensor(x)).abs() < 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def T_(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))
