"""The pixel-space CLIs and their chains against the JAX package (CPU, fp32).

The chains: JAX initialises a small UNet or 2-D DiT, every leaf is moved by
seeded numpy noise, the same tree goes into the port through
``convert.py``, and the port's ``noise_fn`` replays the JAX sampler's key
splits (``test_torch_scg_chain.jax_replay_noise``), so both see the same
numbers. The pixel SCG chain must pick the same candidate at every step,
with the final rolls within 1e-3 of the largest magnitude (the models
agree to ~1e-5 per call, which the chain's 1/sqrt(alpha) factors amplify);
the CFG chain's final rolls within 1e-3 of the largest magnitude likewise.
Both CLIs run at fixture size and write their MIDI files.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.diffusion.guidance import make_model_fn as jmake_model_fn
from rule_guided_music_tpu.models.dit import DiT as JaxDiT2d
from rule_guided_music_tpu.models.unet import UNetModel as JaxUNet
from rule_guided_music_tpu.utils.fixtures import flatten_tree, unflatten_tree
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.data.midi_io import read_midi
from rule_guided_music_tpu_torch.diffusion.guidance import make_model_fn
from rule_guided_music_tpu_torch.diffusion.sampling import sample_loop
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT
from rule_guided_music_tpu_torch.models.unet import UNetModel
from rule_guided_music_tpu_torch.pixel import cfg_sample_pixel, sample_pixel

from test_torch_scg_chain import jax_replay_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_TOL = 1e-3
UNET = dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_heads=2,
            num_classes=3)
DIT = dict(input_size=(16, 16), patch_size=4, in_channels=3, hidden_size=64,
           depth=2, num_heads=2, num_classes=3)
# fixture size for the CLIs: a narrow UNet on 16 x 16 rolls (in bf16, the
# script's fixed dtype); DiT-S/8 on 16 x 16 is 4 tokens
UNET_CLI = ["--num_channels", "8", "--num_res_blocks", "1", "--image_size",
            "16", "16"]
DIT_CLI = ["--model", "DiT-S/8", "--image_size", "16", "16", "--bf16", "False"]
# flags of the JAX scripts the port leaves out: the logger's project and
# directory (the port writes under --out_dir) and training-only switches
LEFT_OUT = {"project", "dir", "use_kl", "predict_xstart", "rescale_learned_sigmas"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def noisy(jmodel, args, seed):
    params = jmodel.init(jax.random.PRNGKey(0), *args)
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    return jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)), flat


def close(got, want, rel=CHAIN_TOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def test_pixel_scg_chain_matches_jax():
    """sample_pixel's chain at a small width: a class-conditional UNet on
    (3, 32, 32), SCG k=4 on note_density_pixel (target 2.0) on every step
    of a 4-step DDPM chain, decode the identity."""
    steps, k, b, seed = 4, 4, 2, 3
    shape = (b, 3, 32, 32)
    y = np.array([1, 1], np.int32)
    jmodel = JaxUNet(**UNET)
    params, flat = noisy(jmodel, [jnp.zeros((1, 3, 32, 32)), jnp.zeros((1,)),
                                  jnp.zeros((1,), jnp.int32)], seed=4)
    jt = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(method="no_guidance", schedule=True,
                                          t_start=steps, t_end=0),
        scg=jsampling.SCGConfig(num_samples=k,
                                weights=(("note_density_pixel", 1.0),)),
        record=True)
    jrules = {"note_density_pixel": jnp.full((b, 2 * 32 // 16), 2.0)}
    run = jax.jit(lambda key, rules: jsampling.sample_loop(
        key, lambda x, t, yy: jmodel.apply(params, x, t, yy), shape, jt, jcfg,
        y=jnp.asarray(y), rules=rules, decode_fn=lambda v: v))
    with jax.default_matmul_precision("highest"):
        jx, jrec = run(jax.random.PRNGKey(seed), jrules)
    jsel = np.asarray(jrec["candidate_log_prob"]).argmax(axis=1)

    model = UNetModel(**UNET)
    model.load_state_dict(convert.unet_state_dict(flat), strict=True)
    tt = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(method="no_guidance", schedule=True,
                                        t_start=steps, t_end=0),
        scg=tconfig.SCGConfig(num_samples=k,
                              weights=(("note_density_pixel", 1.0),)),
        record=True)
    with torch.no_grad():
        tx, trec = sample_loop(
            lambda x, t, yy: model(x, t, yy), shape, tt, tcfg,
            noise_fn=jax_replay_noise(seed, steps), y=torch.as_tensor(y),
            rules={"note_density_pixel": torch.full((b, 4), 2.0)},
            decode_fn=lambda v: v)
    tsel = trec["candidate_log_prob"].argmax(1).numpy()
    # the SCG search runs on every step but the last (t == t_end)
    assert (jsel[:-1] >= 0).all() and len(set(jsel[:-1].ravel())) > 1
    np.testing.assert_array_equal(tsel, jsel)
    close(tx.numpy(), jx)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_pixel_cfg_chain_matches_jax(sampler):
    """cfg_sample_pixel's chain at a small width: a 2-D DiT on (3, 16, 16)
    with CFG w=4 inside JAX's make_model_fn, 4 steps."""
    steps, b, seed, w = 4, 2, 5, 4.0
    shape = (b, 3, 16, 16)
    y = np.array([1, 2], np.int32)
    jmodel = JaxDiT2d(**DIT)
    params, flat = noisy(jmodel, [jnp.zeros((1, 3, 16, 16)), jnp.zeros((1,)),
                                  jnp.zeros((1,), jnp.int32)], seed=6)
    respacing = f"ddim{steps}" if sampler == "ddim" else str(steps)
    jt = jschedule.make_schedule("linear", 1000, respacing).tables()
    jfn = jmake_model_fn(lambda xx, tt, yy: jmodel.apply(params, xx, tt, yy),
                         num_classes=3, class_cond=True, cfg=True, w=w)
    with jax.default_matmul_precision("highest"):
        jx, _ = jax.jit(lambda key: jsampling.sample_loop(
            key, jfn, shape, jt, jsampling.SamplerConfig(sampler=sampler, eta=1.0),
            y=jnp.asarray(y)))(jax.random.PRNGKey(seed))

    model = DiT(**DIT)
    model.load_state_dict(convert.dit_state_dict(flat), strict=True)
    tt = tschedule.make_schedule("linear", 1000, respacing).tables("cpu")
    with torch.no_grad():
        tx, _ = sample_loop(make_model_fn(model, 3, True, cfg=True, w=w), shape,
                            tt, tconfig.SamplerConfig(sampler=sampler, eta=1.0),
                            noise_fn=jax_replay_noise(seed, steps),
                            y=torch.as_tensor(y))
    close(tx.numpy(), jx)


@pytest.mark.parametrize("module,flags", [
    (sample_pixel, UNET_CLI + ["--scg", "True"]),
    (sample_pixel, UNET_CLI + ["--class_cond", "False"]),
    (cfg_sample_pixel, DIT_CLI + ["--use_ddim", "True"]),
    (cfg_sample_pixel, DIT_CLI + ["--sampler", "dpmpp"])])
def test_pixel_cli_writes_midi(tmp_path, module, flags):
    out = tmp_path / "out"
    arr = module.main([*flags, "--timestep_respacing", "3", "--num_samples", "4",
                       "--device", "cpu", "--out_dir", str(out)])
    assert arr.shape == (4, 3, 16, 16) and arr.dtype == np.uint8
    label = "" if "--class_cond" in flags else "_y_1"
    midis = sorted(os.listdir(out))
    assert midis == [f"sample_{i}{label}.midi" for i in range(4)]
    for name in midis:
        assert read_midi(str(out / name)).get_end_time() >= 0.0


def _jax_parser(name):
    path = os.path.join(REPO, "scripts", "pixel", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.create_argparser()


@pytest.mark.parametrize("module", [sample_pixel, cfg_sample_pixel])
def test_pixel_cli_flags_and_defaults_are_jax(module):
    """Every flag of the JAX script, with its default, except the logger's
    and the training-only ones; the port adds --out_dir and --device."""
    jax_args = vars(_jax_parser(module.__name__.rsplit(".", 1)[-1]).parse_args([]))
    ours = vars(module.create_argparser().parse_args([]))
    want = {k: v for k, v in jax_args.items() if k not in LEFT_OUT}
    assert {k: ours[k] for k in want} == want
    assert set(ours) - set(want) <= {"out_dir", "device"}


@pytest.mark.parametrize("module", [sample_pixel, cfg_sample_pixel])
def test_pixel_cli_ignores_rescale_timesteps_as_jax(module):
    """The JAX pixel scripts build their schedule without
    --rescale_timesteps: at 500 diffusion steps, where rescaling would
    double them, the denoiser still sees JAX's unscaled timesteps."""
    flags = ["--diffusion_steps", "500", "--timestep_respacing", "4"]
    want = jschedule.make_schedule("linear", 500, "4").tables()
    for extra in ([], ["--rescale_timesteps", "True"]):
        args = module.create_argparser().parse_args(flags + extra)
        tables, _ = sample_pixel.tables_and_noise(args, "cpu")
        np.testing.assert_array_equal(tables.model_t.numpy(),
                                      np.asarray(want.model_t))
