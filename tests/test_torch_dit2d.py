"""The port's 2-D DiT against the JAX package (CPU, fp32).

The sin-cos tables are numpy copies and must equal JAX's exactly. The
models: JAX initialises a small 2-D DiT, every leaf is moved by seeded
numpy noise (so the zero-initialised adaLN and final layer are real
functions), ``convert.dit_state_dict`` loads it into the port, and the same
numpy inputs go through both under ``default_matmul_precision("highest")``.
Tolerance 1e-4 relative and absolute, as the other model parity tests
(fp32 summation order through two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.dit import DiT as JaxDiT2d
from rule_guided_music_tpu.models.layers import (
    get_1d_sincos_pos_embed as jpos1d,
    get_2d_sincos_pos_embed as jpos2d,
)
from rule_guided_music_tpu.utils.fixtures import flatten_tree, unflatten_tree
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.models.dit import DiT, DiT_models
from rule_guided_music_tpu_torch.models.layers import (get_1d_sincos_pos_embed,
                                                       get_2d_sincos_pos_embed)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(depth=2, hidden_size=64, num_heads=2, in_channels=3, num_classes=3)
NAMES_2D = [f"DiT-{s}/{p}" for s in ("XL", "L", "B", "S") for p in (2, 4, 8)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dim,grid", [(64, (4, 4)), (768, (16, 16)), (96, (3, 5))])
def test_2d_sincos_table_equals_jax(dim, grid):
    np.testing.assert_array_equal(get_2d_sincos_pos_embed(dim, *grid),
                                  jpos2d(dim, *grid))


@pytest.mark.parametrize("dim,n", [(64, 16), (768, 128)])
def test_1d_sincos_table_equals_jax(dim, n):
    pos = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(get_1d_sincos_pos_embed(dim, pos),
                                  jpos1d(dim, pos))


@pytest.mark.parametrize("patchify,learn_sigma,labels", [
    (True, False, True), (True, True, True), (False, False, True),
    (False, True, False)])
def test_dit2d_matches_jax(patchify, learn_sigma, labels):
    # patchify: 16 x 16 in 4 x 4 patches; else one token per row of a
    # 16 x 4 input (FlattenNorm; the width is the patch size)
    size = (16, 16) if patchify else (16, 4)
    kw = dict(SMALL, input_size=size, patch_size=4, patchify=patchify,
              learn_sigma=learn_sigma)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, *size)).astype(np.float32)
    t = np.array([4.0, 870.0], np.float32)
    y = np.array([2, 3], np.int32)            # 3 = the null label
    jmodel = JaxDiT2d(**kw)
    jargs = [jnp.asarray(x), jnp.asarray(t)] + ([jnp.asarray(y)] if labels else [])
    # initialised with labels, so the tree holds the label table either way
    params = jmodel.init(jax.random.PRNGKey(0), *jargs[:2], jnp.asarray(y))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    noise = np.random.default_rng(2)
    flat = {k: (v + 0.05 * noise.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(tree, *jargs))
    model = DiT(**kw)
    # strict: the position table is a non-persistent buffer, not a leaf
    model.load_state_dict(convert.dit_state_dict(flat), strict=True)
    assert "pos_embed" not in model.state_dict()
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t),
                    torch.as_tensor(y) if labels else None)
    assert out.shape == (2, 6 if learn_sigma else 3, *size)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES_2D)
def test_registry_names_match_jax(name):
    jmodel = JaxDiT[name](input_size=(128, 128), in_channels=3)
    with torch.device("meta"):
        model = DiT_models[name](input_size=(128, 128), in_channels=3)
    assert isinstance(model, DiT)
    assert (len(model.blocks), model.hidden_size, model.patch_size,
            model.num_heads) == (jmodel.depth, jmodel.hidden_size,
                                 jmodel.patch_size, jmodel.num_heads)
    grid = 128 // jmodel.patch_size
    assert tuple(model.pos_embed.shape) == (1, grid * grid, jmodel.hidden_size)


def test_pos_table_follows_the_model_dtype():
    model = DiT(**SMALL, input_size=(16, 16), patch_size=4).to(torch.bfloat16)
    assert model.pos_embed.dtype == torch.bfloat16
    out = model(torch.zeros(1, 3, 16, 16), torch.zeros(1))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
