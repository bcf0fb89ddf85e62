"""The port's mesh train step and loop on 4 gloo ranks against JAX's mesh
TrainLoop and the port's single-process step (CPU).

One group of 4 spawned ranks (``torch_parallel_ranks.train_program``)
takes two steps of DiTRotary_XS_8 over (data 2, fsdp 2) and over (fsdp 2,
model 2), with AdamW and with Adafactor, from JAX's perturbed init
carried by ``convert.py``, on the batches, t, noise and dropout masks of
``test_torch_training_step`` (global batch 4). JAX takes the same steps
in its ``TrainLoop(mesh=)`` on 4 of the virtual CPU devices (Adafactor
on one device: JAX's mesh loop cannot build its state), and the port on
one process. Then a mesh ``TrainLoop`` with the loss-aware sampler
takes two steps, saves, and restores on the mesh and on one process.

Tolerances (fp32): against the single-process port 1e-5 (relative and
absolute) on the loss, the norms and the per-example losses, 2e-6 on the
parameters and the EMA (the mesh changes only the order of the sums);
against JAX as ``test_torch_training_step`` holds one process: 1e-5 on the
metrics; the parameters and the EMA after the second step within 2e-5
(the optimizer's second step divides by moments of gradients that agree
to 1e-5). The key third of each ``attn.qkv.bias`` has no gradient
(softmax is shift-invariant in the key bias): what each side computes
there is rounding noise, which Adam and Adafactor scale to about +-lr
with either sign, so those elements are held to have moved less than
4 lr over the two steps, on every side.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.parallel.mesh import make_mesh as jmake_mesh
from rule_guided_music_tpu.training import train_loop as jtl
from rule_guided_music_tpu.utils.fixtures import flatten_tree
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.parallel import mesh as pm
from rule_guided_music_tpu_torch.training import train_loop as ttl
from rule_guided_music_tpu_torch.training.resample import create_named_schedule_sampler
from test_torch_training_step import _batch, _dit_setup, _jax_draws

TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = ("loss", "grad_norm", "param_norm", "per_example_loss", "per_example_mse")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the 4-rank run, JAX's mesh steps and the single-process
    port's, each case's metrics and final state."""
    work = str(tmp_path_factory.mktemp("train_ranks"))
    jmodel, params, _ = _dit_setup(0)
    flat = {f"p/{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    inputs = dict(flat)
    for s in range(2):
        lat, t, w, y = _batch(100 + s)
        noise, drop = _jax_draws(jmodel, params, jax.random.PRNGKey(50 + s), lat, y, 1)
        inputs.update({f"lat{s}": lat, f"t{s}": t.astype(np.int64), f"w{s}": w,
                       f"y{s}": y.astype(np.int64), f"noise{s}": noise,
                       f"drop{s}": drop})
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    ranks.launch("train", 4, work)
    return work, jmodel, params, inputs


def _jax_steps(jmodel, params, inputs, shape, opt):
    cfg = jtl.TrainConfig(optimizer=opt, ema_rate=0.9, lr=1e-3)
    # JAX's mesh TrainLoop gives optax.adafactor's 1-D factored moments
    # their parameter's 2-D sharding and fails at init (ROADMAP 3.17): its
    # Adafactor step is taken on one device, the value a mesh would give
    mesh = jmake_mesh(*shape, devices=jax.devices()[:4]) if opt == "adamw" else None

    def model_apply(p, x, model_t, y, rng):
        return jmodel.apply(p, x, model_t, y, train=True, rngs={"label_dropout": rng})

    loop = jtl.TrainLoop(model_apply=model_apply, init_params=params,
                         tables=jschedule.make_schedule("linear", 1000).tables(),
                         data=None, config=cfg, mesh=mesh)
    out = {}
    for s in range(2):
        args = [jnp.asarray(inputs[f"{k}{s}"]) for k in ("lat", "t", "w", "y")]
        if mesh is not None:
            args = [jax.device_put(a, loop._batch_sharding) for a in args]
        with jax.default_matmul_precision("highest"):
            loop.state, m = loop.step_fn(loop.state, *args, jax.random.PRNGKey(50 + s))
        out.update({f"{k}{s}": np.asarray(m[k]) for k in METRICS})
    sd = convert.dit_state_dict(flatten_tree(loop.state["params"]))
    ema = convert.dit_state_dict(flatten_tree(loop.state["ema_params"]))
    out.update({f"param/{k}": v.numpy() for k, v in sd.items()})
    out.update({f"ema/{k}": v.numpy() for k, v in ema.items()})
    return out


def _port_steps(inputs, opt):
    model = ranks._dit(ranks._params(inputs))
    cfg = ttl.TrainConfig(optimizer=opt, ema_rate=0.9, lr=1e-3)
    state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                           optimizer=ttl.make_optimizer(cfg, list(model.parameters())))
    step = ttl.make_train_step(model, tschedule.make_schedule("linear", 1000).tables("cpu"),
                               cfg)
    T = torch.as_tensor
    out = {}
    for s in range(2):
        m = step(state, T(inputs[f"lat{s}"]), T(inputs[f"t{s}"]), T(inputs[f"w{s}"]),
                 T(inputs[f"y{s}"]), T(inputs[f"noise{s}"]), T(inputs[f"drop{s}"]))
        out.update({f"{k}{s}": m[k].detach().numpy() for k in METRICS})
    out.update({f"param/{k}": v.detach().numpy() for k, v in model.named_parameters()})
    out.update({f"ema/{k}": v.numpy() for k, v in state.ema_params.items()})
    return out


@pytest.mark.parametrize("shape,opt", [((2, 2, 1), "adamw"), ((2, 2, 1), "adafactor"),
                                       ((1, 2, 2), "adamw"), ((1, 2, 2), "adafactor")])
def test_mesh_step_matches_jax_and_one_process(world, shape, opt):
    work, jmodel, params, inputs = world
    got = dict(np.load(os.path.join(work, f"train_{','.join(map(str, shape))}_{opt}.npz")))
    want = _jax_steps(jmodel, params, inputs, shape, opt)
    single = _port_steps(inputs, opt)
    assert sorted(got) == sorted(single)
    before = ranks._dit(ranks._params(inputs)).state_dict()
    for k in got:
        if k.startswith(("param/", "ema/")):
            start = before[k.split("/", 1)[1]].numpy()
            _assert_state(k, got[k], single[k], start, 2e-6)
            _assert_state(k, got[k], want[k], start, 2e-5)
        else:
            np.testing.assert_allclose(got[k], single[k], err_msg=k, **TOL)
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_mesh_step_with_remat_matches_one_process(world):
    """The (fsdp 2, model 2) AdamW steps with every block under
    ``torch.utils.checkpoint``: each block gathers its parameters in its
    forward and again in its recompute, and the steps equal the
    single-process port's (without remat) as the case without remat
    does."""
    work, _, _, inputs = world
    got = dict(np.load(os.path.join(work, "train_1,2,2_adamw+remat.npz")))
    single = _port_steps(inputs, "adamw")
    assert sorted(got) == sorted(single)
    before = ranks._dit(ranks._params(inputs)).state_dict()
    for k in got:
        if k.startswith(("param/", "ema/")):
            _assert_state(k, got[k], single[k], before[k.split("/", 1)[1]].numpy(), 2e-6)
        else:
            np.testing.assert_allclose(got[k], single[k], err_msg=k, **TOL)


def _assert_state(name, got, want, start, atol):
    """Parameters (or EMA) within ``atol``; the key bias (no gradient) only
    within 4 lr of where it started, on both sides."""
    if name.endswith("attn.qkv.bias"):
        n = got.shape[0] // 3
        for side in (got, want):
            assert np.abs(side[n:2 * n] - start[n:2 * n]).max() < 4 * 1e-3, name
        keep = np.r_[0:n, 2 * n:3 * n]
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("shape", ["2,2,1", "1,2,2"])
def test_mesh_placements_follow_the_rules(world, shape):
    """Every DTensor parameter sits as ``param_specs`` says: fsdp shards the
    qkv weight's input dim and model its output dim, as JAX's
    P('fsdp', 'model') on the (in, out) kernel."""
    work = world[0]
    got = json.load(open(os.path.join(work, f"placements_{shape}.json")))
    dp, fsdp, tp = map(int, shape.split(","))
    with torch.device("meta"):
        from rule_guided_music_tpu_torch.models.dit import DiT_models
        model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    specs = pm.param_specs(model, {"data": dp, "fsdp": fsdp, "model": tp})
    for name, spec in specs.items():
        want = []
        for axis, size in (("data", dp), ("fsdp", fsdp), ("model", tp)):
            dims = [d for d, a in enumerate(spec) if a == axis]
            want.append(f"S({dims[0]})" if dims and size > 1 else "R")
        assert got[name] == want, name
    assert got["blocks.0.attn.qkv.weight"] == (["R", "S(1)", "S(0)"] if tp > 1
                                               else ["R", "S(1)", "R"])


def test_mesh_loop_saves_and_restores_anywhere(world):
    """Two steps of a (2, 2) mesh TrainLoop with the loss-aware sampler take
    the single-process loop's draws and update its sampler alike; its
    checkpoint restores on the mesh (placements and every shard equal) and
    on one process."""
    work, _, _, inputs = world
    loop_out = dict(np.load(os.path.join(work, "loop.npz")))
    restored = dict(np.load(os.path.join(work, "restored.npz")))
    assert restored["same"] and restored["opt_same"] and restored["resume_step"] == 2
    tables = tschedule.make_schedule("linear", 1000).tables("cpu")
    sampler = create_named_schedule_sampler("loss-second-moment", 1000)
    single = ttl.TrainLoop(model=ranks._dit(ranks._params(inputs)), tables=tables,
                           data=None, config=ttl.TrainConfig(optimizer="adafactor",
                                                             ema_rate=0.9),
                           schedule_sampler=sampler, seed=3)
    for s in range(2):
        single.run_step(inputs[f"lat{s}"], {"y": inputs[f"y{s}"]})
    np.testing.assert_array_equal(loop_out["counts"], sampler._loss_counts)
    np.testing.assert_allclose(loop_out["history"], sampler._loss_history, **TOL)
    start = ranks._dit(ranks._params(inputs)).state_dict()
    for k, v in single.model.named_parameters():
        _assert_state(k, loop_out[f"param/{k}"], v.detach().numpy(),
                      start[k].numpy(), 2e-6)
    one = ttl.TrainLoop(model=ranks._dit(ranks._params(inputs)), tables=tables,
                        data=None, config=ttl.TrainConfig(optimizer="adafactor"))
    one.restore(ttl.TrainLoop.latest_checkpoint(os.path.join(work, "ckpt")))
    assert one.resume_step == 2
    for k, v in one.model.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), loop_out[f"param/{k}"])
