"""Port models against the JAX package on shared weights (CPU, float32).

The committed ``quality_tiny.npz`` fixture (trained DiTRotary_XS_8 +
ch-32 KL-VAE) goes through ``rule_guided_music_tpu_torch/convert.py`` into
the port's modules; the same numpy inputs go through both frameworks. JAX
runs under ``default_matmul_precision("highest")``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.diffusion import latent as jlatent
from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.models.torch_port import convert_dit_rotary, convert_vae
from rule_guided_music_tpu.ops import rotary as jrotary
from rule_guided_music_tpu.utils.fixtures import flatten_tree, load_fixture_npz
from rule_guided_music_tpu_torch import convert, pipeline
from rule_guided_music_tpu_torch.diffusion import latent as tlatent
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.models.vae import AutoencoderKL, FusedNormSwish
from rule_guided_music_tpu_torch.ops import rotary as trotary

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
# fp32 both sides through 2 blocks / ~20 convs: observed ~1e-5 worst case.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def fixture_tree():
    return load_fixture_npz(FIXTURE)


def test_rotary_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 3, 72)).astype(np.float32)     # (B,N,H,D)
    table_j = jrotary.make_rotary_table(256, 36)
    ref = np.asarray(jrotary.apply_rotary(jnp.swapaxes(jnp.asarray(x), 1, 2),
                                          table_j))
    out = trotary.apply_rotary(torch.as_tensor(x),
                               trotary.make_rotary_table(256, 36))
    np.testing.assert_allclose(np.swapaxes(out.numpy(), 1, 2), ref,
                               rtol=1e-6, atol=1e-6)


def test_dit_xs_matches_jax_on_fixture(fixture_tree):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 128, 16)).astype(np.float32)
    t = np.array([0.0, 333.0, 999.0], np.float32)
    jmodel = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                     num_classes=0)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(fixture_tree["dit"], jnp.asarray(x),
                                      jnp.asarray(t)))
    model = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                     model_path=FIXTURE, dtype=torch.float32,
                                     device="cpu")
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_dit_class_conditional_matches_jax():
    """A class-conditional, learn_sigma XS trunk with random non-zero
    weights (label table, adaLN) in both frameworks."""
    jmodel = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                     num_classes=3, learn_sigma=True)
    x = np.random.default_rng(2).standard_normal((2, 4, 128, 16)).astype(np.float32)
    t = np.array([5.0, 700.0], np.float32)
    y = np.array([1, 3], np.int32)                  # 3 = the null label
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(y))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(3)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, load_fixture_like(flat))}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(y)))
    model = DiT_models["DiTRotary_XS_8"](num_classes=3, learn_sigma=True)
    model.load_state_dict(convert.dit_state_dict(flat))
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(y))
    assert out.shape == (2, 8, 128, 16)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def load_fixture_like(flat):
    from rule_guided_music_tpu.utils.fixtures import unflatten_tree

    return unflatten_tree({k[len("params/"):]: v for k, v in flat.items()})


def test_vae_decode_matches_jax_on_fixture(fixture_tree):
    z = np.random.default_rng(4).standard_normal((3, 4, 16, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxVAE(**TINY_VAE).apply(
            fixture_tree["vae"], jnp.asarray(z), method=JaxVAE.decode))
    vae = pipeline.create_vae(FIXTURE, arch=TINY_VAE, dtype=torch.float32,
                              device="cpu")
    with torch.no_grad():
        out = vae.decode(torch.as_tensor(z))
    assert out.shape == (3, 3, 128, 128)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_vae_norm_swish_calls_per_decode():
    """Every ResnetBlock norm1/norm2 and norm_out go through groupnorm_swish:
    29 calls per decode at the production geometry (14 blocks x 2 + 1)."""
    calls = lambda vae: sum(isinstance(m, FusedNormSwish) for m in vae.modules())
    assert calls(AutoencoderKL(**TINY_VAE)) == 4 * 2 * 2 + 2 * 2 + 1
    with torch.device("meta"):
        assert calls(AutoencoderKL()) == 29


def test_port_names_are_the_reference_torch_names():
    """The JAX package's torch->flax converter (written against the
    reference's module names) accepts the port's state_dicts as they are."""
    model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = convert_dit_rotary(sd, depth=2)["params"]
    back = convert.dit_state_dict(flatten_tree(tree))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])

    vae = AutoencoderKL(**TINY_VAE)
    vsd = {k: v.numpy() for k, v in vae.state_dict().items()}
    stub = {f"encoder.{k}": v for k, v in _encoder_stub().items()}
    stub["quant_conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    stub["quant_conv.bias"] = np.zeros((1,), np.float32)
    vtree = convert_vae({**vsd, **stub}, ch_mult=(1, 1, 2, 2),
                        num_res_blocks=1)["params"]
    vback = convert.vae_state_dict(flatten_tree(vtree))
    assert set(vback) == set(vsd)
    for k in vsd:
        np.testing.assert_array_equal(vback[k].numpy(), vsd[k])


def _encoder_stub():
    """Zero-size encoder tensors: convert_vae needs the encoder's names."""
    z = np.zeros((1, 1, 1, 1), np.float32)
    b = np.zeros((1,), np.float32)
    out = {"conv_in.weight": z, "conv_in.bias": b, "conv_out.weight": z,
           "conv_out.bias": b, "norm_out.weight": b, "norm_out.bias": b}
    res = ["norm1", "conv1", "norm2", "conv2"]

    def resblock(prefix):
        for name in res:
            out[f"{prefix}.{name}.weight"] = z if "conv" in name else b
            out[f"{prefix}.{name}.bias"] = b

    for lvl in range(4):
        resblock(f"down.{lvl}.block.0")
        if lvl != 3:
            out[f"down.{lvl}.downsample.conv.weight"] = z
            out[f"down.{lvl}.downsample.conv.bias"] = b
    resblock("mid.block_1")
    resblock("mid.block_2")
    for name in ("q", "k", "v", "proj_out"):
        out[f"mid.attn_1.{name}.weight"] = z
        out[f"mid.attn_1.{name}.bias"] = b
    out["mid.attn_1.norm.weight"] = b
    out["mid.attn_1.norm.bias"] = b
    return out


@pytest.mark.parametrize("shape", [(2, 4, 128, 16), (3, 4, 32, 16)])
def test_latent_chunk_order_matches_jax(shape):
    z = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    chunks_j = np.asarray(jlatent.latent_to_chunks(jnp.asarray(z)))
    chunks_t = tlatent.latent_to_chunks(torch.as_tensor(z))
    np.testing.assert_array_equal(chunks_t.numpy(), chunks_j)
    n = shape[2] // shape[3]
    pix = np.random.default_rng(6).standard_normal(
        (n * shape[0], 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tlatent.chunks_to_pixels(torch.as_tensor(pix), n).numpy(),
        np.asarray(jlatent.chunks_to_pixels(jnp.asarray(pix), n)))
