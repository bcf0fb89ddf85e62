"""The port's device mesh against the JAX package (CPU): the placement of
every parameter, the sharded sample chain, and the CLIs, ``build_mesh``
and the logger on 2 gloo ranks.

Placements are pure functions: the port's spec of every parameter of
DiTRotary_XL_8, the production KL-VAE and the pixel UNet (built on the
meta device), carried back through the converter's permutation, equals
JAX's ``shard_params`` spec of the same Flax parameter (shapes from
``jax.eval_shape``) on the virtual 8-device mesh, divisibility fallback
included. One group of 2 spawned ranks (``torch_parallel_ranks.
mesh_program``) runs the rest; the sample chain (SCG k=2 over 4 steps on
the quality_tiny fixture, batch 2, one row a rank) replays the draws of
JAX's chain for its global batch, so it takes the port's single-process
chain's steps: the two agree within 1e-4, the float32 rounding of the
CPU's matrix products at one row against two (5e-5 observed; on the card
``chip_smoke.py`` holds a world of one bit-equal), and both match JAX's
mesh chain within the SCG chain test's 1e-3.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import torch_parallel_ranks as ranks
from rule_guided_music_tpu import pipeline as jpipeline
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.unet import UNetModel as JaxUNet
from rule_guided_music_tpu.parallel.mesh import make_mesh as jmake_mesh
from rule_guided_music_tpu.parallel.mesh import _path_str
from rule_guided_music_tpu.parallel.mesh import shard_params as jshard_params
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.models.unet import UNetModel
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL
from rule_guided_music_tpu_torch.parallel import mesh as pm
from rule_guided_music_tpu_torch.parallel.comm import Axis
from test_torch_scg_chain import jax_replay_noise

STEPS, K, B = 4, 2, 2
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0))
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX's parameter shapes, the port's module on the meta device)."""
    key = jax.random.PRNGKey(0)
    if kind == "dit":
        args = (jnp.zeros((1, 4, 128, 16)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
        jmodel, kw = JaxDiT["DiTRotary_XL_8"](), {}
        with torch.device("meta"):
            tmodel = DiT_models["DiTRotary_XL_8"]()
    elif kind == "vae":
        args, jmodel, kw = (jnp.zeros((1, 3, 128, 128)),), JaxVAE(), {"rng": key}
        with torch.device("meta"):
            tmodel = AutoencoderKL(encoder=True)
    else:
        args = (jnp.zeros((1, 3, 128, 128)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
        jmodel, kw = JaxUNet(num_classes=3), {}
        with torch.device("meta"):
            tmodel = UNetModel(num_classes=3)
    return jax.eval_shape(lambda: jmodel.init(key, *args, **kw)), tmodel


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (1, 8, 1)])
@pytest.mark.parametrize("kind", ["dit", "vae", "unet"])
def test_placements_equal_jax_shard_params(kind, shape):
    shapes, tmodel = _models(kind)
    jspecs = jshard_params(shapes, jmake_mesh(*shape))
    specs = {_path_str(k): tuple(sh.spec)
             for k, sh in jax.tree_util.tree_leaves_with_path(jspecs)}
    # a one-element array of each leaf's rank carries its name through
    flat = {_path_str(k): (np.zeros((1,) * len(s.shape), np.float32), specs[_path_str(k)])
            for k, s in jax.tree_util.tree_leaves_with_path(shapes)}
    sizes = dict(zip(("data", "fsdp", "model"), shape))
    got = pm.param_specs(tmodel, sizes, kind)
    modules = dict(tmodel.named_modules())
    matched = 0
    for path, (arr, spec) in flat.items():
        path = path[len("params/"):]
        if kind == "vae" and not path.startswith(tuple(
                ("encoder/", "decoder/", "quant_conv/", "post_quant_conv/"))):
            continue
        name = next(iter(getattr(convert, f"{kind}_state_dict" if kind != "vae"
                                 else "vae_state_dict")(
            {path: arr}, **({"encoder": True} if kind == "vae" else {}))))
        t = dict(tmodel.named_parameters())[name]
        perm = convert.flax_path(name, tuple(t.shape), kind,
                                 isinstance(modules[name.rpartition(".")[0]],
                                            nn.Embedding))[1]
        spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
        assert got[name] == tuple(spec[perm[j]] for j in range(arr.ndim)), name
        matched += 1
    assert matched == len(got)
    if kind == "dit":          # P("fsdp", "model") on the (in, out) kernel
        assert got["blocks.0.attn.qkv.weight"] == ("model", "fsdp")


def test_shard_noise_fn_keeps_this_ranks_rows():
    """A draw of the chain's rank, or with the SCG candidates' leading dim,
    is drawn for the global batch and cut to this rank's rows."""
    draws = []

    def noise(kind, step, shape):
        draws.append(shape)
        return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)

    mesh = SimpleNamespace(rgm_batch=Axis(None, 2, 1))
    fn = pm.shard_noise_fn(noise, mesh, (4, 3))
    got = fn("scg", 0, (3, 2, 3))          # k = 3 candidates of this rank's 2
    torch.testing.assert_close(got, torch.arange(36.0).reshape(3, 4, 3)[:, 2:4],
                               rtol=0, atol=0)
    got = fn("step", 0, (2, 3))
    torch.testing.assert_close(got, torch.arange(12.0).reshape(4, 3)[2:4],
                               rtol=0, atol=0)
    assert draws == [(3, 4, 3), (4, 3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh_ranks"))
    rolls = make_rolls(B, seed=21)
    ts = os.path.join(work, "ts")
    os.makedirs(ts)
    for i, x in enumerate(make_rolls(4, length=1100)):
        np.save(f"{ts}/r{i}.npy", np.round((x + 1) * 63.5).astype(np.uint8))
    with open(f"{ts}/data_test_cls_1.csv", "w") as f:
        f.write("midi_filename,classes\n" + "".join(f"{ts}/r{i}.npy,1\n" for i in range(4)))
    # the port's single-process chain on JAX's draws, recording them
    draws, replay = {}, jax_replay_noise(5, STEPS)

    def record(kind, step, shape):
        a = replay(kind, step, shape)
        draws["draw/init" if kind == "init" else f"draw/{kind}/{step}"] = a.numpy()
        return a

    dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                   model_path=ranks.FIXTURE, dtype=torch.float32,
                                   device="cpu")
    vae = pipeline.create_vae(ranks.FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                              device="cpu")
    tt = tschedule.make_schedule("linear", 1000, str(STEPS)).tables("cpu")
    tcfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(schedule=True, t_start=750),
        scg=tconfig.SCGConfig(num_samples=K, weights=WEIGHTS))
    trules = pipeline.extract_targets_from_rolls(("pitch_hist", "note_density"),
                                                 torch.as_tensor(rolls))
    single, _ = pipeline.generate(dit, vae, tt, tcfg, (B, 4, 128, 16), trules,
                                  noise_fn=record, num_classes=0, scale_factor=1.0)
    np.savez(os.path.join(work, "inputs.npz"), chain_steps=STEPS, chain_k=K,
             chain_shape=np.array([B, 4, 128, 16]), chain_rolls=rolls, **draws)
    ranks.launch("mesh", 2, work)
    out = [dict(np.load(os.path.join(work, f"mesh_r{r}.npz"))) for r in range(2)]
    return work, out, single.numpy(), rolls


def test_generate_on_a_mesh_equals_one_process_and_jax(world):
    _, out, single, rolls = world
    for r in range(2):
        np.testing.assert_allclose(out[r]["chain"], single, rtol=0, atol=1e-4)
    fx = load_fixture_npz(ranks.FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4, num_classes=0)
    jvae = JaxVAE(**TINY_VAE)
    jcfg = jsampling.SamplerConfig(
        guidance=jsampling.GuidanceConfig(schedule=True, t_start=750),
        scg=jsampling.SCGConfig(num_samples=K, weights=WEIGHTS))
    gen = jpipeline.make_sample_fn(
        denoiser_model=jdit, tables=jschedule.make_schedule("linear", 1000,
                                                            str(STEPS)).tables(),
        sampler_config=jcfg, gen_shape=(B, 4, 128, 16), vae_model=jvae,
        use_decode=True, scale_factor=1.0, num_classes=0, class_cond=False,
        mesh=jmake_mesh(dp=2, devices=jax.devices()[:2]))
    from rule_guided_music_tpu.rules.registry import FUNC_DICT
    jrules = {n: FUNC_DICT[n](jnp.asarray(rolls)) for n in ("pitch_hist", "note_density")}
    with jax.default_matmul_precision("highest"):
        jx, _ = gen(jax.random.PRNGKey(5), {"denoiser": fx["dit"], "vae": fx["vae"],
                                            "classifiers": ()}, jrules)
    np.testing.assert_allclose(out[0]["chain"], np.asarray(jx), rtol=0, atol=1e-3)


def test_mesh_clis_run_on_two_ranks(world):
    """train_dit with --dp/--fsdp/--tp 2, the pixel trainers with mesh
    flags and ``sample_rule --mesh 2`` ran one step / one batch on each
    rank through DTensor parameters; rank 0 wrote the files."""
    work, out, _, _ = world
    for r in range(2):
        for key in ("train_ditdp", "train_ditfsdp", "train_dittp", "unet", "ditpix"):
            assert out[r][key].tolist() == [1.0, 1.0], (r, key)
    assert out[0]["sample_rows"] == 2 and out[1]["sample_rows"] == 0
    assert sorted(f for f in os.listdir(f"{work}/sample") if f.endswith(".midi")) == \
        ["sample_0.midi", "sample_1.midi"]
    for flag in ("dp", "fsdp", "tp"):
        assert sorted(os.listdir(f"{work}/td{flag}")) == [
            "log-rank001.txt", "log.txt", "progress.csv"]


def test_build_mesh_and_the_logger_on_two_ranks(world):
    work, out, _, _ = world
    assert out[0]["auto4"].tolist() == [2, 1, 1]
    assert not out[0]["auto3_idle"] and out[1]["auto3_idle"]
    assert "divisible by the batch-sharded mesh extent data*fsdp = 2" in str(out[0]["assert"])
    assert "cannot factor 2 device(s) as dp=3 x fsdp=1 x tp=1" in str(out[0]["factor"])
    files = sorted(os.listdir(f"{work}/logrun"))
    assert files == ["log-rank001.txt", "log.txt", "progress.csv"], files
