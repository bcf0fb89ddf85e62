"""The port's int8 serving (ops/quant.py) against the JAX package (CPU).

Tolerances, each with its reason:
  * ``quantize_dense``, ``quantize_``: int8 values and fp32
    scales equal JAX's bit for bit (the same numpy float operations).
  * ``quant_dense_apply`` / ``wo_dense_apply`` on the same fp32 inputs: the
    int8 activations and the int32 accumulation are exact, so only fp32
    rounding of the dequantization and of the fp32 product may differ:
    1e-6 of the largest output (observed: equal).
  * The plain quantization and w8a8 linear on rows whose x / s land on
    halves, all-zero rows and ties at the amax (K = 16 and 96): JAX's bit
    for bit (the kernels on the card are held to these plain versions).
  * The same in bf16 at the XL_8 trunk's widths: w8a8 equal bit for bit
    (the same float operations in the same order); w8a16 takes the product
    in fp32 and rounds once after ``* scale + bias``, as JAX's, so only the
    order of the fp32 sums differs: at most 0.1% of outputs differ, each
    by one bf16 ulp, or, where the sum cancels to near zero, by no more
    than K 2^-24 sum_k |x_k w_k| scale, what an order of K fp32 additions
    can move it (observed 0.005% and 0.012%; rounding the product to bf16
    before the rescale made it 27%).
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
    """(1, 16) and (3, 5): 16 rows or fewer, which the card's
    ``torch._int_mm`` took only padded; the kernels take any M."""
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


def _bf16_case(m, k, n):
    """Inputs at (m tokens, k -> n) from a numpy seed: x (m, k) fp32, the
    JAX kernel (k, n) int8 and scale, a bias."""
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q, s = jquant.quantize_dense((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, q, s, b


def _bf16_pair(mode, x, q, s, b):
    """(the port's, JAX's) bf16 outputs of ``mode`` as float32 numpy."""
    japply, tapply = APPLY[mode]
    want = japply(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                  jnp.asarray(b), dtype=jnp.bfloat16)
    got = tapply(torch.as_tensor(x).bfloat16(), torch.as_tensor(np.ascontiguousarray(q.T)),
                 torch.as_tensor(s), torch.as_tensor(b), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), np.array(want.astype(jnp.float32))


BF16_SHAPES = [(512, 1152, 3456), (64, 4608, 1152)]


@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
def test_wo_dense_apply_bf16_matches_jax(m, k, n):
    """w8a16 in bf16 at XL_8's qkv (512 tokens) and fc2 (64 tokens)."""
    x, q, s, b = _bf16_case(m, k, n)
    got, want = _bf16_pair("w8a16", x, q, s, b)
    share, beyond = tquant.bf16_disagreement(
        torch.as_tensor(got), torch.as_tensor(want), torch.as_tensor(x).bfloat16(),
        torch.as_tensor(np.ascontiguousarray(q.T)), torch.as_tensor(s))
    assert share <= 1e-3 and beyond == 0, (share, beyond)


@pytest.mark.parametrize("m,k,n", BF16_SHAPES)
def test_quant_dense_apply_bf16_equals_jax(m, k, n):
    """w8a8 in bf16: JAX's result bit for bit."""
    got, want = _bf16_pair("w8a8", *_bf16_case(m, k, n))
    np.testing.assert_array_equal(got, want)


def _edge_rows(k: int, rows: int = 8) -> np.ndarray:
    """(rows, k) fp32, row i of kind i % 4: a row whose x / s all land on
    halves (the amax 127 c, the others odd multiples of c / 2 of both
    signs, c = 2^-3, so that s = c exactly; all exact in bf16), an all-zero
    row (the 1e-8 floor), a row whose largest |x| is tied three times with
    both signs, a row drawn from a normal (chip_smoke.quantize_edge_input's
    rows, which the card's kernel is held to)."""
    x = np.random.default_rng(k).standard_normal((rows, k)).astype(np.float32)
    col = np.arange(k)
    halves = ((col % 127) + 0.5) * 2.0 ** -3 * (1 - 2 * (col % 2))
    halves[5 % k] = 127 * 2.0 ** -3
    ties = np.clip(x[0], -2, 2)
    ties[[1, k // 2, k - 1]] = [2.5, -2.5, 2.5]
    for i in range(rows):
        x[i] = (halves, np.zeros(k), ties, x[i])[i % 4]
    return x.astype(np.float32)


EDGE_CASES = [(k, dtype) for k in (16, 96) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("k,dtype", EDGE_CASES)
def test_quantize_rows_reference_equals_jax_on_edge_rows(k, dtype):
    """The plain quantization against JAX's on rows of halves (rounded half
    to even), zeros and ties, K = 16 included: JAX's ``quant_dense_apply``
    through an identity int8 kernel gives x_i8 * s_x, which the port's x_i8
    and s_x must give bit for bit."""
    x = _edge_rows(k)
    got_q, got_s = tquant.quantize_rows_reference(torch.as_tensor(x).to(getattr(torch, dtype)))
    want = np.asarray(jquant.quant_dense_apply(
        jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.eye(k, dtype=jnp.int8),
        jnp.ones(k, jnp.float32), None, dtype=jnp.float32))
    np.testing.assert_array_equal((got_q.float() * got_s).numpy(), want)
    # the halves row rounds half to even; the zero row keeps the 1e-8 floor
    np.testing.assert_array_equal(got_q[0].numpy(), np.rint(x[0] / 2.0 ** -3).astype(np.int8))
    assert got_s[0, 0].item() == 2.0 ** -3 and not got_q[1].any()
    assert got_s[1, 0].item() == np.float32(1e-8) / np.float32(127)


@pytest.mark.parametrize("k,dtype", EDGE_CASES)
def test_quant_dense_reference_equals_jax_on_edge_rows(k, dtype):
    """The whole plain w8a8 linear against JAX's on the same edge rows, with
    a bias, in the input's dtype: bit for bit."""
    x = _edge_rows(k)
    rng = np.random.default_rng(k + 1)
    q, s = jquant.quantize_dense((rng.standard_normal((k, 40)) * 0.05).astype(np.float32))
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    want = jquant.quant_dense_apply(jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(q),
                                    jnp.asarray(s), jnp.asarray(b), dtype=getattr(jnp, dtype))
    got = tquant.quant_dense_reference(
        torch.as_tensor(x).to(getattr(torch, dtype)), torch.as_tensor(np.ascontiguousarray(q.T)),
        torch.as_tensor(s), torch.as_tensor(b))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _grad_case(dtype):
    """x (6, 96) in ``dtype`` with a row of zeros (the 1e-8 floor) and a
    row whose largest |x| is tied three ways; an int8 (40, 96) weight, its
    scale and bias; a cotangent of the (6, 40) output."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    x[2] = 0.0
    x[4, [3, 50, 95]] = [4.0, -4.0, 4.0]
    w = rng.integers(-127, 128, (40, 96), dtype=np.int8)
    scale = (rng.random(40) / 127).astype(np.float32)
    bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
    r = rng.standard_normal((6, 40)).astype(np.float32)
    return (torch.as_tensor(x).to(dtype), torch.as_tensor(w), torch.as_tensor(scale),
            torch.as_tensor(bias), torch.as_tensor(r))


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_autograd_of_plain_version(mode, dtype):
    """The backward of the card's autograd Functions (``w8a16_grad``;
    ``w8a8_grad_s_x`` then ``quantize_rows_grad``) equals autograd through
    the plain versions: the gradient DPS takes through a quantized trunk.
    w8a8's reaches x through s_x alone, so only each row's largest |x| has
    one, shared by the tie, and the zero row has none."""
    x, w, scale, bias, r = _grad_case(dtype)
    x_in = x.clone().requires_grad_()
    if mode == "w8a16":
        y = tquant.wo_dense_reference(x_in, w, scale, bias)
    else:
        y = tquant.quant_dense_reference(x_in, w, scale, bias)
    want = torch.autograd.grad((y.float() * r).sum(), x_in)[0]
    dy = r.to(dtype)
    if mode == "w8a16":
        got = tquant.w8a16_grad(dy, w, scale).to(dtype)
    else:
        q, s_x = tquant.quantize_rows_reference(x)
        acc_f = tquant.int_mm(q, w).float()
        got = tquant.quantize_rows_grad(x, tquant.w8a8_grad_s_x(dy, acc_f, scale))
        assert (got[2] == 0).all() and (got[4] != 0).sum() == 3
        assert ((got != 0).sum(-1)[[0, 1, 3, 5]] == 1).all()
    assert got.dtype == dtype and want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int_mm_is_exact(rows):
    rng = np.random.default_rng(rows)
    a = rng.integers(-127, 128, (rows, 64), dtype=np.int8)
    w = rng.integers(-127, 128, (24, 64), dtype=np.int8)
    out = tquant.int_mm(torch.as_tensor(a), torch.as_tensor(w))
    assert out.dtype == torch.int32 and out.shape == (rows, 24)
    np.testing.assert_array_equal(out.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


def _misaligned(shape, dtype):
    """A view of ``shape`` whose data starts one element past an allocation
    (which torch places on 64 bytes): not on 16 bytes for 1- and 2-byte
    elements."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# (wrapper, what is wrong, the words the error must hold): the GEMMs read
# the input and the weight by TMA, the quantization by 16-byte loads
TMA_REFUSALS = [(kernel, case, words)
                for kernel in ("w8a16", "w8a8", "quantize_rows", "w8a8_linear")
                for case, words in (("offset view", "16 bytes"),
                                    ("non-contiguous", "contiguous"),
                                    ("K not a multiple of 16", "multiple of 16"),
                                    ("weight offset view", "the weight"))
                if not (kernel == "quantize_rows" and case.startswith("weight"))]


@pytest.mark.parametrize("kernel,case,words", TMA_REFUSALS)
def test_kernel_wrappers_refuse_what_tma_cannot_read(kernel, case, words):
    """The kernels' wrappers check TMA's preconditions before any launch (a
    base on 16 bytes, contiguous rows, K a multiple of 16, so that every row
    stride is a multiple of 16 bytes) and raise a ValueError that says what
    is wrong, rather than a CUDA error. On CPU tensors: the check comes
    before the library is loaded, so nothing here needs a card."""
    dtype = torch.bfloat16 if kernel != "w8a8" else torch.int8
    m, k, n = 8, 64, 24
    x = torch.zeros(m, k, dtype=dtype)
    w = torch.zeros(n, k, dtype=torch.int8)
    if case == "offset view":
        x = _misaligned((m, k), dtype)
    elif case == "non-contiguous":
        x = torch.zeros(k, m, dtype=dtype).t()
    elif case == "K not a multiple of 16":
        x, w = torch.zeros(m, 40, dtype=dtype), torch.zeros(n, 40, dtype=torch.int8)
    else:
        w = _misaligned((n, k), torch.int8)
    scale, bias = torch.ones(n), torch.zeros(n)
    with pytest.raises(ValueError, match=words):
        if kernel == "w8a16":
            tquant.w8a16_gemm(x, w, scale, bias)
        elif kernel == "w8a8":
            tquant.w8a8_gemm(x, torch.ones(m), w, scale, bias)
        elif kernel == "w8a8_linear":
            tquant.w8a8_linear(x, w, scale, bias)
        else:
            tquant.quantize_rows(x)


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
