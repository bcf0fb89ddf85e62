"""The port's int8 serving (ops/quant.py) against the JAX package (CPU).

Tolerances, each with its reason:
  * ``quantize_dense``, ``quantize_``: int8 values and fp32
    scales equal JAX's bit for bit (the same numpy float operations).
  * ``quant_dense_apply`` / ``wo_dense_apply`` on the same fp32 inputs: the
    int8 activations and the int32 accumulation are exact, so only fp32
    rounding of the dequantization and of the fp32 product may differ:
    1e-6 of the largest output (observed: equal).
  * The quantized DiTRotary_XS_8 on quality_tiny against JAX's quantized
    model, relative L2 error of eps: w8a16 1e-5 (fp32 summation order;
    observed 2e-7); w8a8 1e-3 (observed 1.6e-4): a float32 difference of
    one ulp in an activation upstream can move its per-token int8 value by
    one step where it lies on a rounding boundary, which changes that
    output by s_x * scale.
  * Its eps against the fp trunk's, relative L2 across a 16-step chain:
    JAX's envelope, w8a8 0.05 and w8a16 0.04 (tests/test_quant.py).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.ops import quant as jquant
from rule_guided_music_tpu.utils.fixtures import flatten_tree, load_fixture_npz
from rule_guided_music_tpu_torch import convert, pipeline, sample_rule
from rule_guided_music_tpu_torch.models.dit import DiT_models
from rule_guided_music_tpu_torch.ops import quant as tquant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'
MODEL_REL_TOL = {"w8a8": 1e-3, "w8a16": 1e-5}
ENVELOPE = {"w8a8": 0.05, "w8a16": 0.04}
APPLY = {"w8a8": (jquant.quant_dense_apply, tquant.quant_dense_apply),
         "w8a16": (jquant.wo_dense_apply, tquant.wo_dense_apply)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_tree():
    return load_fixture_npz(FIXTURE)


@pytest.mark.parametrize("shape,seed", [((128, 256), 0), ((64, 192), 1),
                                        ((96, 8), 2)])
def test_quantize_dense_equals_jax(shape, seed):
    k = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    k[:, 0] = 0.0                                   # an all-zero column
    jq, js = jquant.quantize_dense(k)
    tq, ts = tquant.quantize_dense(k)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("lead", [(4, 32), (1, 16), (3, 5)])
def test_dense_apply_matches_jax(mode, lead):
    """(1, 16) and (3, 5) have 16 rows or fewer: the padded int_mm path."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, 96)).astype(np.float32)
    k = (rng.standard_normal((96, 192)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(192) * 0.1).astype(np.float32)
    q, s = jquant.quantize_dense(k)
    japply, tapply = APPLY[mode]
    ref = np.asarray(japply(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                            jnp.asarray(b), dtype=jnp.float32))
    out = tapply(torch.as_tensor(x), torch.as_tensor(np.ascontiguousarray(q.T)),
                 torch.as_tensor(s), torch.as_tensor(b), dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int_mm_is_exact(rows):
    rng = np.random.default_rng(rows)
    a = rng.integers(-127, 128, (rows, 64), dtype=np.int8)
    w = rng.integers(-127, 128, (24, 64), dtype=np.int8)
    out = tquant.int_mm(torch.as_tensor(a), torch.as_tensor(w))
    assert out.dtype == torch.int32 and out.shape == (rows, 24)
    np.testing.assert_array_equal(out.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("value,want", [
    (False, ""), ("", ""), ("False", ""), (True, "w8a8"), ("True", "w8a8"),
    ("W8A16", "w8a16"), ("int4", ValueError)])
def test_normalize_quant_mode(value, want):
    """Every case of tests/test_quant.py::test_normalize_quant_mode."""
    if want is ValueError:
        for fn in (jquant.normalize_quant_mode, tquant.normalize_quant_mode):
            with pytest.raises(ValueError):
                fn(value)
    else:
        assert tquant.normalize_quant_mode(value) == want
        assert jquant.normalize_quant_mode(value) == want


def test_quantize_dit_state_dict_equals_jax(fixture_tree):
    """The state_dict of quality_tiny's DiT quantized in place by
    ``quantize_`` against JAX's ``quantize_dit_params`` converted: int8
    weights and scales equal, every other leaf equal to the fp conversion."""
    jflat = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jquant.quantize_dit_params(fixture_tree["dit"])))
    fp = convert.dit_state_dict(flatten_tree(fixture_tree["dit"]))
    model = DiT_models["DiTRotary_XS_8"](num_classes=0)
    model.load_state_dict(fp, strict=True)
    sd = tquant.quantize_(model, "w8a8").state_dict()
    assert set(sd) - set(fp) == {f"blocks.{i}.{a}.{b}.scale" for i in range(2)
                                 for a, b in tquant.DIT_BLOCK_QUANT_LEAVES}
    n_quant = 0
    for key, val in sd.items():
        m = re.fullmatch(r"blocks\.(\d+)\.(attn|mlp)\.(\w+)\.weight", key)
        if m and val.dtype == torch.int8:
            n_quant += 1
            path = f"params/blocks_{m[1]}/{m[2]}/{m[3]}"
            np.testing.assert_array_equal(val.numpy().T, jflat[path + "/kernel_i8"])
            np.testing.assert_array_equal(sd[key[:-6] + "scale"].numpy(),
                                          jflat[path + "/scale"])
            assert sd[key[:-6] + "bias"].dtype == torch.float32
        elif not key.endswith(".scale"):
            assert torch.equal(val, fp[key]), key
    assert n_quant == 4 * 2                          # four linears x two blocks


def test_quant_linear_refuses_a_bf16_linear():
    """Quantizing bf16-rounded weights would give other int8 values than
    JAX's fold of the fp32 tree, so ``from_linear`` takes fp32 only."""
    lin = torch.nn.Linear(8, 8).to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        tquant.QuantLinear.from_linear(lin, "w8a8")


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_quantized_dit_matches_jax_on_fixture(fixture_tree, mode):
    """eps of the quantized XS_8 against JAX's quantized model, and both
    against their fp trunks within JAX's envelope, at four steps of a
    16-step chain (tests/test_quant.py's slow check, on numpy inputs)."""
    x = np.random.default_rng(7).standard_normal((4, 4, 128, 16)).astype(np.float32)
    kw = dict(input_size=(128, 16), in_channels=4, num_classes=0)
    jq = JaxDiT["DiTRotary_XS_8"](**kw, quant=mode)
    jfp = JaxDiT["DiTRotary_XS_8"](**kw)
    qparams = jquant.quantize_dit_params(fixture_tree["dit"])
    tq = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                  model_path=FIXTURE, dtype=torch.float32,
                                  device="cpu", quant=mode)
    tfp = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                   model_path=FIXTURE, dtype=torch.float32,
                                   device="cpu")
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for t_val in (2, 7, 12, 15):
        t = np.full((4,), t_val, np.int32)
        with jax.default_matmul_precision("highest"):
            e_jq = np.asarray(jq.apply(qparams, jnp.asarray(x), jnp.asarray(t)))
            e_jfp = np.asarray(jfp.apply(fixture_tree["dit"], jnp.asarray(x),
                                         jnp.asarray(t)))
        with torch.no_grad():
            e_tq = tq(torch.as_tensor(x), torch.as_tensor(t)).numpy()
            e_tfp = tfp(torch.as_tensor(x), torch.as_tensor(t)).numpy()
        assert rel(e_tq, e_jq) < MODEL_REL_TOL[mode], (t_val, rel(e_tq, e_jq))
        assert rel(e_tq, e_tfp) < ENVELOPE[mode]
        assert rel(e_jq, e_jfp) < ENVELOPE[mode]
        assert rel(e_tq, e_tfp) > 0                 # the trunk is quantized


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_bf16_cast_keeps_int8_weights_and_fp32_scales(mode):
    model = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                     model_path=FIXTURE, dtype=torch.bfloat16,
                                     device="cpu", quant=mode)
    fp32 = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu", quant=mode)
    for (name, mod), (_, ref) in zip(model.named_modules(), fp32.named_modules()):
        if isinstance(mod, tquant.QuantLinear):
            assert mod.weight.dtype == torch.int8
            assert mod.scale.dtype == mod.bias.dtype == torch.float32
            for buf in ("weight", "scale", "bias"):
                assert torch.equal(getattr(mod, buf), getattr(ref, buf)), name
        elif isinstance(mod, torch.nn.Linear):
            assert mod.weight.dtype == torch.bfloat16
    x = torch.randn(1, 4, 128, 16)                   # B=1: 16 tokens, padded
    with torch.no_grad():
        out = model(x, torch.tensor([5]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_quant_linear_forward_is_the_apply_function():
    lin = tquant.QuantLinear(32, 24, mode="w8a8")
    gen = torch.Generator().manual_seed(0)
    lin.weight.copy_(torch.randint(-127, 128, (24, 32), generator=gen,
                                   dtype=torch.int8))
    lin.scale.copy_(torch.rand(24, generator=gen))
    lin.bias.copy_(torch.randn(24, generator=gen))
    x = torch.randn(2, 20, 32, generator=gen)
    assert torch.equal(lin(x), tquant.quant_dense_apply(x, lin.weight, lin.scale,
                                                        lin.bias))
    lin.mode = "w8a16"
    assert torch.equal(lin(x), tquant.wo_dense_apply(x, lin.weight, lin.scale,
                                                     lin.bias))


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_sample_rule_quant_at_fixture_size(tmp_path, capsys, mode):
    cfg = os.path.join(REPO, "scripts", "configs", "cond_table", "all", "scg.yml")
    out = tmp_path / mode
    rows = sample_rule.main([
        "--config_path", cfg, "--model", "DiTRotary_XS_8", "--num_classes", "0",
        "--class_cond", "True", "--model_path", FIXTURE, "--vae_path", FIXTURE,
        "--vae_arch", TINY_VAE_ARCH, "--batch_size", "1", "--num_samples", "1",
        "--timestep_respacing", "2", "--device", "cpu", "--dtype", "float32",
        "--quant", mode, "--out_dir", str(out)])
    assert f"denoiser trunk quantized to int8 ({mode} serving)" in capsys.readouterr().out
    assert len(rows) == 1 and np.isfinite(rows[0]["pitch_hist.loss"])
    assert (out / "sample_0_y_1.midi").exists() and (out / "summary.csv").exists()
