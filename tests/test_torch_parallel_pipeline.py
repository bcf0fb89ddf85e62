"""The port's GPipe and circular pipelines, the pipelined DiTRotary and
sequence parallelism on 4 gloo ranks against the JAX package (CPU).

The cases are those of ``tests/test_pipeline_parallel.py``: one group of 4
spawned ranks (``torch_parallel_ranks.pipeline_program``) runs them all on
numpy-seeded inputs, with the DiT's parameters carried from JAX's
perturbed init by ``convert.py``; JAX runs its own over stage meshes of
the virtual CPU devices. Each rank's gradient of the stacked weights
covers its own blocks; their sum over ranks is compared.

Tolerances, float32 on both sides: the toy stacks 1e-6 (forward) and
1e-5 (gradients), as JAX holds its pipelines against the sequential
blocks; the DiT and sequence parallelism 2e-5, JAX's own tolerance for
them against ``model.apply``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.parallel.pipeline import (circular_pipeline_apply,
                                                     gpipe_apply,
                                                     pipelined_dit_rotary_apply)
from rule_guided_music_tpu.utils.fixtures import flatten_tree, unflatten_tree
from rule_guided_music_tpu_torch.models.dit import DiT_models


def _stage_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("stage",))


def _xs(**kw):
    return JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4, num_classes=3,
                                   **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pipeline_ranks"))
    rng = np.random.default_rng(0)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    inp = {"g_w": f32(8, 16, 16, scale=0.3), "g_x": f32(8, 16),
           "d_w": f32(4, 8, 8, scale=0.3), "d_x": f32(8, 8),
           "t_w": f32(4, 8, 8, scale=0.2), "t_x": f32(12, 8), "t_c": f32(12, 8),
           "c_w": f32(12, 8, 8, scale=0.3), "c_b": f32(12, 8, scale=0.1),
           "c_x": f32(8, 8), "cd_w": f32(4, 4, 4, scale=0.3), "cd_x": f32(2, 4),
           "dit_x": f32(8, 4, 128, 16), "dit_t": np.linspace(0, 100, 8, dtype=np.float32),
           "dit_y": np.arange(8) % 3, "sp_x": f32(2, 4, 128, 16),
           "sp_t": np.array([5.0, 50.0], np.float32), "sp_y": np.array([0, 2])}
    model = _xs()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 128, 16)),
                        jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    flat = {k: np.asarray(v) + f32(*np.shape(v), scale=0.02)
            for k, v in flatten_tree(params).items()}
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    inp.update({f"p/{k}": v for k, v in flat.items()})
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    ranks.launch("pipeline", 4, work)
    return dict(np.load(os.path.join(work, "pipeline.npz"))), inp, model, params


def test_gpipe_matches_jax(world):
    got, inp, _, _ = world
    block = lambda p, c: jnp.tanh(c @ p)
    want = gpipe_apply(block, jnp.asarray(inp["g_w"]), jnp.asarray(inp["g_x"]),
                       mesh=_stage_mesh(4), n_micro=4)
    np.testing.assert_allclose(got["gpipe"], np.asarray(want), rtol=1e-6, atol=1e-6)
    tree = lambda p, c: (jnp.tanh(c[0] @ p["w"]) + c[1], c[1])
    out, c = gpipe_apply(tree, {"w": jnp.asarray(inp["t_w"])},
                         (jnp.asarray(inp["t_x"]), jnp.asarray(inp["t_c"])),
                         mesh=_stage_mesh(2), n_micro=6)
    np.testing.assert_allclose(got["tree"], np.asarray(out), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["tree_c"], inp["t_c"], atol=1e-7)


def test_gpipe_gradient_matches_jax(world):
    got, inp, _, _ = world
    block = lambda p, c: jnp.tanh(c @ p)
    x = jnp.asarray(inp["d_x"])
    grad = jax.grad(lambda s: (gpipe_apply(block, s, x, mesh=_stage_mesh(4)) ** 2).sum())
    np.testing.assert_allclose(got["gpipe_grad"], np.asarray(grad(jnp.asarray(inp["d_w"]))),
                               rtol=1e-5, atol=1e-5)


def test_circular_matches_jax(world):
    got, inp, _, _ = world
    block = lambda p, c: jnp.tanh(c @ p["w"] + p["b"])
    want = circular_pipeline_apply(block, {"w": jnp.asarray(inp["c_w"]),
                                           "b": jnp.asarray(inp["c_b"])},
                                   jnp.asarray(inp["c_x"]), mesh=_stage_mesh(4))
    np.testing.assert_allclose(got["circular"], np.asarray(want), rtol=1e-6, atol=1e-6)
    x = jnp.asarray(inp["cd_x"])
    loss = lambda p: jnp.mean(circular_pipeline_apply(
        lambda q, c: jnp.tanh(c @ q["w"]), p, x, mesh=_stage_mesh(2)) ** 2)
    val, grads = jax.value_and_grad(loss)({"w": jnp.asarray(inp["cd_w"])})
    np.testing.assert_allclose(got["circ_loss"], float(val), rtol=1e-5)
    np.testing.assert_allclose(got["circ_grad"], np.asarray(grads["w"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "circular"])
def test_pipelined_dit_matches_jax(world, schedule):
    got, inp, model, params = world
    kw = dict(n_micro=4) if schedule == "gpipe" else {}
    want = pipelined_dit_rotary_apply(
        model, params, jnp.asarray(inp["dit_x"]), jnp.asarray(inp["dit_t"]),
        jnp.asarray(inp["dit_y"]), mesh=_stage_mesh(2), schedule=schedule, **kw)
    np.testing.assert_allclose(got[f"dit_{schedule}"], np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert got["roundtrip"]


@pytest.mark.parametrize("schedule", ["gpipe", "circular"])
def test_pipeline_stages_hold_only_their_blocks(world, schedule):
    """Under ``keep_stage_blocks_`` each of the 2 stage ranks holds the
    DiT's parameters outside its blocks and its L/S blocks alone, those of
    JAX's ``P(axis)`` placement (the outputs above come from these models)."""
    got = world[0]
    full = DiT_models["DiTRotary_XS_8"](num_classes=3)
    block = sum(p.numel() for p in full.blocks[0].parameters())
    rest = sum(p.numel() for p in full.parameters()) - block * len(full.blocks)
    per = len(full.blocks) // 2
    want = [list(range(s * per, (s + 1) * per)) if schedule == "gpipe"
            else list(range(s, len(full.blocks), 2)) for s in range(2)]
    assert got[f"held_{schedule}"].tolist() == want
    assert got[f"numel_{schedule}"].tolist() == [rest + per * block] * 2


def test_sequence_parallel_matches_jax(world):
    """Tokens over 4 ranks against JAX's (data 2, seq 4) ``token_spec``
    forward (which equals its unsharded one)."""
    got, inp, _, params = world
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))
    model = _xs(token_spec=NamedSharding(mesh, P("data", "seq", None)))
    want = jax.jit(lambda p, x: model.apply(p, x, jnp.asarray(inp["sp_t"]),
                                            jnp.asarray(inp["sp_y"])))(
        params, jnp.asarray(inp["sp_x"]))
    np.testing.assert_allclose(got["sp"], np.asarray(want), rtol=2e-5, atol=2e-5)
