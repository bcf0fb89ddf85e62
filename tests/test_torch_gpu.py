"""The port's hand-written kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device (decided
inside the ``cuda`` fixture, never at import). The card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: max abs error against the plain version run in float32 on the
same values, as chip_smoke.py states them; fp32 allows summation-order
differences. In bf16, GroupNorm+swish allows the final rounding of outputs
below 8 (half an ulp <= 2^-7); attention's outputs, convex combinations of
V below 2 here, allow half an ulp of the final rounding (<= 2^-8) and as
much again for P rounded to bf16 before P V. Attention gradients (the
kernel's autograd Function replays the plain version's VJP on the same
inputs): max abs difference over the largest gradient, 1e-5 in fp32 and
1e-2 in bf16 (the final rounding of each gradient, 2^-8, plus as much
again). The classifier gradient, card against CPU in fp32: 1e-4 of its
largest magnitude (the forward's summation order through two blocks).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rule_guided_music_tpu_torch import pipeline  # noqa: E402
from rule_guided_music_tpu_torch.config import (  # noqa: E402
    GuidanceConfig,
    SCGConfig,
    SamplerConfig,
)
from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule  # noqa: E402
from rule_guided_music_tpu_torch.ops import flash_attention as fa  # noqa: E402
from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn  # noqa: E402
from rule_guided_music_tpu_torch.utils.fixtures import make_rolls  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 16, 72), (2, 257, 6, 64),
                                   (1, 5, 1, 128), (3, 70, 2, 1),
                                   (2, 100, 3, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    name = fa.KERNEL_NAME[dtype]
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.kernel_launches == {**before, name: before[name] + 1}
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 16, 72), (2, 257, 6, 64),
                                   (2, 100, 3, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_strided_qkv(cuda, shape, dtype):
    """q, k, v as views of one (B, N, 3, H, D) tensor, as the DiT passes them."""
    b, n, h, d = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= ATTN_TOL[dtype]


# the decoder's geometries (C, H=W) with G = 32, which plan clusters of
# 1, 2, 4 and 8 blocks across the two dtypes, and two narrow fixture ones
GN_SHAPES = [(512, 16, 32), (512, 32, 32), (256, 32, 32), (256, 64, 32),
             (256, 128, 32), (128, 128, 32), (8, 5, 4), (32, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw,groups", GN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel(cuda, c, hw, groups, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn((2, c, hw, hw), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    before = gn.launches
    out = gn.groupnorm_swish(x, w, b, groups)
    torch.cuda.synchronize()
    assert gn.launches == before + 1 and out.dtype == dtype
    ref = gn.groupnorm_swish_reference(x.float(), w.float(), b.float(), groups)
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
def test_groupnorm_swish_kernel_plans_every_cluster_size(cuda):
    sizes = {gn.plan_slices((c // g) * hw * hw, size)[0]
             for c, hw, g in GN_SHAPES for size in (2, 4)}
    assert sizes == {1, 2, 4, 8}


@pytest.mark.gpu
def test_groupnorm_swish_kernel_grad(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 64, 8, 8), generator=gen, device=cuda, requires_grad=True)
    w = torch.ones(64, device=cuda, requires_grad=True)
    b = torch.zeros(64, device=cuda, requires_grad=True)
    (gn.groupnorm_swish(x, w, b, 32) ** 2).sum().backward()
    grads = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    (gn.groupnorm_swish_reference(x, w, b, 32) ** 2).sum().backward()
    for got, t in zip(grads, (x, w, b)):
        torch.testing.assert_close(got, t.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda):
    """The tiny fixture through generate on the card (kernels, fp32, no
    TF32) and on the CPU (plain versions), with the same noise."""
    config = SamplerConfig(guidance=GuidanceConfig(schedule=True),
                           scg=SCGConfig(num_samples=4), record=True)
    arch = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    draws = {}
    gen = torch.Generator().manual_seed(3)

    def noise_for(device):
        def noise(kind, step, shape):
            if (kind, step) not in draws:
                draws[(kind, step)] = torch.randn(shape, generator=gen)
            return draws[(kind, step)].to(device)
        return noise

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for device in ("cpu", "cuda"):
            dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                           model_path=FIXTURE,
                                           dtype=torch.float32, device=device)
            vae = pipeline.create_vae(FIXTURE, arch=arch, dtype=torch.float32,
                                      device=device)
            tables = make_schedule("linear", 1000, "4").tables(device)
            rolls = torch.as_tensor(make_rolls(1, seed=21), device=device)
            rules = pipeline.extract_targets_from_rolls(["note_density"], rolls)
            lat, rec = pipeline.generate(dit, vae, tables, config, (1, 4, 128, 16),
                                         rules, noise_fn=noise_for(device),
                                         num_classes=0, scale_factor=1.0)
            out[device] = (lat.cpu(), rec["candidate_log_prob"].argmax(1).cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    assert (out["cpu"][0] - out["cuda"][0]).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 257, 6, 64), (32, 256, 16, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_grad(cuda, shape, dtype):
    """dq, dk, dv through the kernel (q, k, v views of one qkv tensor, as
    the DiT passes them) against autograd through the plain version."""
    b, n, h, d = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((b, n, 3, h, d), generator=gen,
                      device=cuda).to(dtype).requires_grad_()
    cot = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn.name() == "_FlashAttentionBackward"
    name = fa.KERNEL_NAME[dtype]
    assert fa.kernel_launches == {**before, name: before[name] + 1}
    got = torch.autograd.grad(out, qkv, cot)[0].float()
    want = torch.autograd.grad(fa.flash_attention_reference(q, k, v), qkv,
                               cot)[0].float()
    for i in range(3):
        err = (got[:, :, i] - want[:, :, i]).abs().max() / want[:, :, i].abs().max()
        assert err.item() <= GRAD_TOL[dtype], ("qkv"[i], err.item())
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.gpu
def test_classifier_cond_fn_on_card_matches_cpu(cuda):
    """The composite cond_fn of scg_classifier_all.yml (mse, mse, chord;
    scales 400/10/10) on tiny random classifiers, fp32 without TF32."""
    import copy

    from rule_guided_music_tpu_torch.diffusion.guidance import (
        CondFnSpec,
        make_grad_cond_fn,
    )
    from rule_guided_music_tpu_torch.models.dit import DiTRotaryClassifier

    terms = (("grad_nn_zt_mse", "pitch_hist", 400.0, 12),
             ("grad_nn_zt_mse", "note_density", 10.0, 16),
             ("grad_nn_zt_chord", "chord_progression", 10.0, 8))
    cpu_models = [pipeline.randomize_(DiTRotaryClassifier(
        num_classes=n, chord="chord" in fn, hidden_size=64, depth=2,
        num_heads=2), seed=100 + i).requires_grad_(False)
        for i, (fn, _, _, n) in enumerate(terms)]
    rolls = torch.as_tensor(make_rolls(2, seed=4))
    rules = pipeline.extract_targets_from_rolls([r for _, r, _, _ in terms], rolls)
    x = torch.randn((2, 4, 128, 16), generator=torch.Generator().manual_seed(6))
    t = torch.tensor([120.0, 743.0])
    grads = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            cond_fn = make_grad_cond_fn([
                CondFnSpec(fn=fn, rule_name=rule, scale=scale,
                           classifier=copy.deepcopy(c).to(device))
                for (fn, rule, scale, _), c in zip(terms, cpu_models)])
            before = fa.kernel_launches["flash_attention_fp32"]
            with torch.no_grad():
                grads[device] = cond_fn(x.to(device), t.to(device),
                                        {k: v.to(device) for k, v in rules.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert fa.kernel_launches["flash_attention_fp32"] == before + 6
    scale = grads["cpu"].abs().max()
    assert scale > 0
    assert ((grads["cuda"].cpu() - grads["cpu"]).abs().max() / scale).item() <= 1e-4
