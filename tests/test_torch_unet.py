"""The port's ADM UNet against the JAX package on shared weights (CPU, fp32).

JAX initialises each model; every leaf is then moved by seeded numpy noise
(so the zero-initialised output convs and attention projections are real
functions), goes through ``convert.unet_state_dict`` into the port's
module, and the same numpy inputs go through both. JAX runs under
``default_matmul_precision("highest")``. Tolerance: 1e-4 relative and
absolute, the fp32 summation-order allowance of the other model parity
tests (about twenty convs and GroupNorms deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.models.unet import SuperResModel as JaxSuperRes
from rule_guided_music_tpu.models.unet import UNetModel as JaxUNet
from rule_guided_music_tpu.utils.fixtures import flatten_tree
from rule_guided_music_tpu_torch import convert
from rule_guided_music_tpu_torch.models.unet import (AttentionBlock, SuperResModel,
                                                     UNetModel)
from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
            attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def noisy_params(model, args, seed, scale=0.05):
    """JAX's init moved by seeded noise: (flax params, flat numpy tree)."""
    params = model.init(jax.random.PRNGKey(0), *args)
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    return tree, flat


def unflatten(flat):
    from rule_guided_music_tpu.utils.fixtures import unflatten_tree

    return unflatten_tree(flat)


def inputs(b=2, c=3, hw=16, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, hw, hw)).astype(np.float32)
    t = np.array([3.0, 611.0][:b], np.float32)
    return x, t


@pytest.mark.parametrize("scale_shift,updown,labels", [
    (True, False, True), (False, False, True), (True, True, False),
    (False, True, True)])
def test_unet_matches_jax(scale_shift, updown, labels):
    kw = dict(TINY, use_scale_shift_norm=scale_shift, resblock_updown=updown,
              num_classes=3 if labels else None)
    x, t = inputs()
    y = np.array([0, 2], np.int32) if labels else None
    jmodel = JaxUNet(**kw)
    jargs = [jnp.asarray(x), jnp.asarray(t)] + ([jnp.asarray(y)] if labels else [])
    params, flat = noisy_params(jmodel, jargs, seed=2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(params, *jargs))
    model = UNetModel(**kw)
    model.load_state_dict(convert.unet_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t),
                    torch.as_tensor(y) if labels else None)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert np.abs(ref).max() > 1e-2          # the noise made it a real function
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_superres_matches_jax():
    kw = dict(TINY, in_channels=6)
    x, t = inputs()
    low = np.random.default_rng(5).standard_normal((2, 3, 8, 8)).astype(np.float32)
    jmodel = JaxSuperRes(JaxUNet(**kw))
    jargs = [jnp.asarray(x), jnp.asarray(t), jnp.asarray(low)]
    params, flat = noisy_params(jmodel, jargs, seed=6)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(params, *jargs))
    model = SuperResModel(UNetModel(**kw))
    model.load_state_dict(convert.unet_state_dict(flat), strict=True)
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(low))
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_unet_output_is_zero_at_init():
    """ADM zero-initialises the output conv, as the JAX UNet does."""
    x, t = inputs()
    with torch.no_grad():
        out = UNetModel(**TINY)(torch.as_tensor(x), torch.as_tensor(t))
    assert torch.count_nonzero(out) == 0


def test_kernel_calls_at_sample_pixel_defaults():
    """At sample_pixel's defaults (128 channels, mult (1,1,2,3,4), 2 res
    blocks, attention at 128 // (32, 16, 8)), one forward runs 16 attention
    blocks (6 down, 1 middle, 9 up) at (N, D) = (1024, 64), (256, 96) and
    (64, 128), 4 heads each, and 28 fused GroupNorm+swish calls (27
    ResBlock in_norms, the final out_norm) whose largest span is 8 channels
    of 128 x 128."""
    with torch.device("meta"):
        model = UNetModel(attention_resolutions=(4, 8, 16))
    attn = [m for m in model.modules() if isinstance(m, AttentionBlock)]
    norms = [m for m in model.modules() if isinstance(m, FusedNormSwish)]
    assert len(attn) == 16 and len(norms) == 28
    names = [n for n, m in model.named_modules() if isinstance(m, AttentionBlock)]
    assert sum(n.startswith("down_") for n in names) == 6
    assert sum(n.startswith("up_") for n in names) == 9
    shapes = set()
    for name, m in model.named_modules():
        if isinstance(m, AttentionBlock):
            level = 4 if name == "mid_attn" else int(name.split("_")[1])
            assert m.heads == 4
            shapes.add(((128 >> level) ** 2, m.qkv.in_features // m.heads))
    assert shapes == {(1024, 64), (256, 96), (64, 128)}
    # the largest span: the up path's first block at 128 x 128 normalises
    # 256 channels in 32 groups
    norm = model.up_0_res_0.in_norm
    assert (norm.weight.shape[0], norm.num_groups) == (256, 32)
    assert all(n.eps == 1e-5 for n in norms)
