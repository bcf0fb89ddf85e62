"""Pixel-space training in the port against the JAX package (CPU, fp32).

One train step of the ADM UNet and of the 2-D DiT through the port's
``make_train_step`` and JAX's ``make_train_step`` from the same
parameters (seeded at the shapes of JAX's init, converted by
``convert.py``), batch, t, noise and (for the DiT) label-dropout mask,
with ``learn_sigma`` off (FIXED_LARGE, MSE) and on (LEARNED_RANGE,
RESCALED_MSE); each pixel CLI for 2 steps; each CLI's flags and defaults
against its JAX script's parser.

Tolerances, as tests/test_torch_training_step.py holds the VAE step: the
loss and the per-example terms within 1e-5 (relative and absolute); the
gradients, read from both AdamWs' first moments, within 1e-4 of the
model's largest; where |g| >= 1e-3 of that largest, the parameters after
the update within 1e-5; elsewhere the update no larger than 2 lr (Adam's
first update is about +-lr whatever |g|, and both models have gradients
that are structurally 0 up to rounding: a conv bias ahead of a
one-channel GroupNorm group, an attention's key bias).
"""

import csv
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models.dit import DiT as JaxDiT2D
from rule_guided_music_tpu.models.unet import UNetModel as JaxUNet
from rule_guided_music_tpu.training import train_loop as jtl
from rule_guided_music_tpu.utils.fixtures import flatten_tree, make_rolls, unflatten_tree
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT
from rule_guided_music_tpu_torch.models.unet import UNetModel
from rule_guided_music_tpu_torch.pixel import (train_classifier_pixel, train_dit_pixel,
                                               train_unet_pixel)
from rule_guided_music_tpu_torch.training import train_loop as ttl
from rule_guided_music_tpu_torch.utils import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
B, LR = 4, 1e-4
UNET = dict(in_channels=3, model_channels=8, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
            num_classes=3)
HW = {"unet": (16, 16), "dit": (32, 32)}
DIT = dict(input_size=(32, 32), patch_size=8, in_channels=3, hidden_size=64,
           depth=2, num_heads=2, num_classes=3)


@pytest.fixture(autouse=True)
def _threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _setup(kind, learn_sigma):
    """(JAX model, flax params, the port's model on them, the converter):
    every leaf seeded from numpy at the shape JAX's init gives it (kernels
    N(0, 1 / fan_in), norm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2)),
    so the zero-initialised output conv and projections are functions."""
    x = jnp.zeros((1, 3, *HW[kind]))
    y = jnp.zeros((1,), jnp.int32)
    if kind == "unet":
        kw = dict(UNET, out_channels=6 if learn_sigma else 3)
        jmodel, model = JaxUNet(**kw), UNetModel(**kw)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, jnp.zeros((1,)), y)
        to_sd = convert.unet_state_dict
    else:
        kw = dict(DIT, learn_sigma=learn_sigma)
        jmodel, model = JaxDiT2D(**kw), DiT(**kw)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)},
            x, jnp.zeros((1,)), y, train=True))
        to_sd = convert.dit_state_dict
    rng = np.random.default_rng(3)
    flat = {}
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    for k, v in flatten_tree(zeros).items():
        noise = rng.standard_normal(v.shape)
        if k.endswith(("kernel", "embedding")):
            val = noise / np.sqrt(np.prod(v.shape[:-1]))
        elif k.endswith("scale"):
            val = 1.0 + 0.05 * noise
        else:
            val = 0.05 * noise
        flat[k] = val.astype(np.float32)
    model.load_state_dict(to_sd(flat), strict=True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)), model, to_sd


def _draws(kind, jmodel, params, key, x, y):
    """The noise JAX's step draws from ``key``, and for the DiT the label
    dropout mask, read from the label embedder's output against the null
    row."""
    noise_rng, dropout_rng = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_rng, x.shape))
    if kind == "unet":
        return noise, None
    _, inter = jmodel.apply(params, jnp.asarray(x), jnp.zeros((B,)), jnp.asarray(y),
                            train=True, rngs={"label_dropout": dropout_rng},
                            capture_intermediates=True, mutable=["intermediates"])
    emb = np.asarray(inter["intermediates"]["y_embedder"]["__call__"][0])
    null = np.asarray(params["params"]["y_embedder"]["embedding_table"])[3]
    return noise, np.all(emb == null, axis=1)


@pytest.mark.parametrize("learn_sigma", [False, True])
@pytest.mark.parametrize("kind", ["unet", "dit"])
def test_pixel_train_step_matches_jax(kind, learn_sigma):
    jmodel, params, model, to_sd = _setup(kind, learn_sigma)
    var = "LEARNED_RANGE" if learn_sigma else "FIXED_LARGE"
    loss = "RESCALED_MSE" if learn_sigma else "MSE"
    kw = dict(lr=LR, weight_decay=0.01, ema_rate=0.9, encode_rep=1)
    jcfg = jtl.TrainConfig(**kw, var_type=getattr(jtl.gd.ModelVarType, var),
                           loss_type=getattr(jtl.gd.LossType, loss))
    tcfg = ttl.TrainConfig(**kw, var_type=getattr(ttl.gd.ModelVarType, var),
                           loss_type=getattr(ttl.gd.LossType, loss))
    optimizer = jtl.make_optimizer(jcfg)
    if kind == "unet":          # as scripts/pixel/train_unet_pixel.py calls it
        def model_apply(p, x, model_t, y, rng):
            return jmodel.apply(p, x, model_t, y)
    else:
        def model_apply(p, x, model_t, y, rng):
            return jmodel.apply(p, x, model_t, y, train=True,
                                rngs={"label_dropout": rng})
    jstep = jax.jit(jtl.make_train_step(model_apply, jschedule.make_schedule(
        "linear", 1000).tables(), optimizer, jcfg))
    jstate = {"params": params, "ema_params": jax.tree_util.tree_map(jnp.copy, params),
              "opt_state": optimizer.init(params), "step": jnp.zeros((), jnp.int32)}
    rng = np.random.default_rng(8)
    x = np.clip(rng.standard_normal((B, 3, *HW[kind])), -1, 1).astype(np.float32)
    t = rng.integers(0, 1000, size=B).astype(np.int32)
    w = (0.5 + rng.random(B)).astype(np.float32)
    y = rng.integers(0, 3, size=B).astype(np.int32)
    key = jax.random.PRNGKey(21)
    noise, drop = _draws(kind, jmodel, params, key, x, y)
    with jax.default_matmul_precision("highest"):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(t), jnp.asarray(w),
                           jnp.asarray(y), key)
    state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                           optimizer=ttl.make_optimizer(tcfg, model.parameters()))
    T = torch.as_tensor
    tm = ttl.make_train_step(model, tschedule.make_schedule("linear", 1000).tables(
        "cpu"), tcfg)(state, T(x), T(t).long(), T(w), T(y).long(), T(noise),
                      None if drop is None else T(drop))
    for k in ("loss", "per_example_loss", "per_example_mse", "vb"):
        if k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), err_msg=k, **TOL)
    assert ("vb" in tm) == learn_sigma == ("vb" in jm)
    want_params = to_sd(flatten_tree(jstate["params"]))
    want_mu = to_sd(flatten_tree(jstate["opt_state"][0].mu))
    gmax = max(float(np.abs(v.numpy()).max()) for v in want_mu.values())
    for name, p in model.named_parameters():
        mu = state.optimizer.state[p]["exp_avg"].numpy()
        jmu = want_mu[name].numpy()
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-4 * gmax, err_msg=name)
        clear = np.abs(jmu) >= 1e-3 * gmax
        got, want = p.detach().numpy(), want_params[name].numpy()
        np.testing.assert_allclose(got[clear], want[clear], err_msg=name, **TOL)
        assert np.all(np.abs(got - want)[~clear] <= 2 * LR * (1 + 1e-5)), name


def test_unet_init_follows_flax_defaults():
    """``init_unet_weights_`` against the JAX UNet's initialisers, leaf by
    leaf at the shapes of JAX's init: kernels of the zero-initialised
    output convs and attention projections zero, every other kernel with
    the std of lecun-normal (sqrt(1 / fan_in), flax's fans) within 10%,
    the label table's 1 / sqrt(width) within 10%, biases zero, norm scales
    one."""
    from rule_guided_music_tpu_torch.models.unet import init_unet_weights_

    kw = dict(UNET, model_channels=32, out_channels=3)
    x = jnp.zeros((1, 3, 16, 16))
    shapes = jax.eval_shape(JaxUNet(**kw).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    model = init_unet_weights_(UNetModel(**kw), torch.Generator().manual_seed(5))
    got = dict(model.named_parameters())
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    names = convert.unet_state_dict(flatten_tree(zeros))
    assert set(names) == set(got)
    # the converter renames leaves in the flat tree's order
    for (flat_key, leaf), name in zip(flatten_tree(zeros).items(), names):
        path = flat_key.split("/")
        p = got[name].detach()
        if path[-1] == "kernel" and path[-2] in ("out_conv", "proj"):
            assert torch.count_nonzero(p) == 0, name
        elif path[-1] == "kernel":
            want = np.prod(leaf.shape[:-1]) ** -0.5
            assert abs(p.std().item() / want - 1) < 0.1, name
        elif path[-1] == "embedding":
            assert abs(p.std().item() * leaf.shape[1] ** 0.5 - 1) < 0.1, name
        elif path[-1] == "scale":
            assert torch.all(p == 1), name
        else:
            assert torch.count_nonzero(p) == 0, name


def _manifest(tmp_path, n=4, length=160):
    rows = []
    for i, roll in enumerate(make_rolls(n, length=length, seed=12)):
        path = str(tmp_path / f"roll{i}.npy")
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, i % 3])
    with open(tmp_path / "train.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return str(tmp_path / "train.csv")


COMMON = ["--image_size", "128", "32", "--batch_size", "2", "--log_interval", "1",
          "--device", "cpu", "--bf16", "False"]


def test_train_unet_pixel_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loop = train_unet_pixel.main([
        "--data_dir", _manifest(tmp_path), "--num_channels", "8", "--num_res_blocks",
        "1", "--attention_resolutions", "16,8", "--max_steps", "2", "--dir", "unet",
        "--learn_sigma", "True", *COMMON])
    assert isinstance(loop.model, UNetModel) and loop.state.updates == 2
    assert loop.config.var_type == ttl.gd.ModelVarType.LEARNED_RANGE
    assert loop.vae_encode is None
    assert os.listdir(tmp_path / "loggings" / "unet" / "checkpoints") == ["step_000002"]


def test_train_dit_pixel_cli_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--data_dir", _manifest(tmp_path), "--model", "DiT-S/8", "--dir", "dit",
             *COMMON]
    loop = train_dit_pixel.main([*flags, "--max_steps", "2"])
    assert isinstance(loop.model, DiT) and loop.state.updates == 2
    again = train_dit_pixel.main([*flags, "--max_steps", "2", "--resume", "True"])
    assert again.resume_step == 2 and again.state.updates == 4
    assert sorted(os.listdir(tmp_path / "loggings" / "dit" / "checkpoints")) == [
        "step_000002", "step_000004"]


@pytest.mark.parametrize("rule,classes", [("note_density_pixel", 4),
                                          ("pitch_hist", 12)])
def test_train_classifier_pixel_cli(tmp_path, monkeypatch, rule, classes):
    """DiT-XS/2-cls on 128 x 32 rolls (1024 patches + CLS) for 2 steps, on
    note_density_pixel (2 windows x 2 values) and pitch_hist (12 values),
    with a save after step 1."""
    monkeypatch.chdir(tmp_path)
    model, history = train_classifier_pixel.main([
        "--data_dir", _manifest(tmp_path), "--classifier_name", "DiT-XS/2-cls",
        "--rule", rule, "--num_classes", str(classes), "--iterations", "2",
        "--save_interval", "1", "--dir", "pcls", *COMMON])
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    assert os.listdir(tmp_path / "loggings" / "pcls" / "checkpoints") == [
        "model000001.pt"]


def _jax_parser(name):
    path = os.path.join(REPO, "scripts", "pixel", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.create_argparser()


@pytest.mark.parametrize("module", [train_unet_pixel, train_dit_pixel,
                                    train_classifier_pixel])
def test_flags_and_defaults_match_the_jax_scripts(module):
    want = vars(_jax_parser(module.__name__.rsplit(".", 1)[1]).parse_args([]))
    got = vars(module.create_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_mesh_and_card_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for module in (train_unet_pixel, train_dit_pixel):
        with pytest.raises(ValueError, match="cannot factor 1 device"):
            module.main(["--data_dir", "unused.csv", "--device", "cpu", "--dp", "2"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                module.main(["--data_dir", "unused.csv"])
