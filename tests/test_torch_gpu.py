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
GroupNorm+swish on the scoring decoder's real activations, whose outputs
exceed 8, in bf16: 2e-2 + 2^-8 |y| elementwise (half an ulp of |y|). The
serving chain, card against CPU in fp32: the same selections, final
latents within 1e-3. GroupNorm+swish gradients at the decoder's shapes in
bf16: 1e-2 of the largest gradient, as attention's. The edit and DPS
chains, card against CPU in fp32: 1e-3 of the largest magnitude. The
long-form checks (the stitched eps, a stitched chain with SCG per window,
the EDM circle-loss worker and a Heun chain with it), card against CPU in
fp32: 1e-5 of the largest magnitude, the same picks in every window;
the Heun chain's final latents 1e-4 on each of four draws (a 4-step chain
carries a 5e-7 relative change of the denoiser's output to 1.1e-5-3.4e-5
of them), and at most 3 times what moving the DiT's output by the
worker's measured difference does to them on either device.
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

import chip_smoke  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality_tiny.npz")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
PORT = {"pipeline": pipeline, "fa": fa, "gn": gn}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 16, 72), (2, 257, 6, 64),
                                   (1, 5, 1, 128), (3, 70, 2, 1),
                                   (2, 100, 3, 36), (32, 256, 12, 64)])
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
                                   (2, 100, 3, 36), (32, 256, 12, 64)])
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
@pytest.mark.parametrize("shape", [(2, 257, 6, 64), (32, 256, 16, 72),
                                   (2, 256, 16, 72)])
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
    scales 400/10/10) on tiny random classifiers, fp32 without TF32:
    chip_smoke.py's check, within its COND_GRAD_TOL of the largest
    gradient and with 6 fp32 attention launches on the card."""
    chip_smoke.cond_fn_card_vs_cpu(torch, PORT)


@pytest.mark.gpu
def test_groupnorm_swish_kernel_on_scoring_decoder(cuda):
    """Every GroupNorm+swish call of a bf16 decode of 8 chunks through the
    ch=64 ScoringDecoder of assets/, on its own captured input."""
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dec = pipeline.ScoringBundle.create(
        decoder_path=os.path.join(repo, "assets", "scoring_decoder_ch64.npz"),
        dtype=torch.bfloat16, device=cuda).decoder
    calls = []
    for m in dec.modules():
        if isinstance(m, FusedNormSwish):
            m.register_forward_pre_hook(
                lambda mod, args: calls.append((args[0].clone(), mod)))
    gen = torch.Generator(device=cuda).manual_seed(9)
    with torch.no_grad():
        dec.decode(torch.randn((8, 4, 16, 16), generator=gen, device=cuda))
    assert len(calls) == 29
    for x, mod in calls:
        out = gn.groupnorm_swish(x, mod.weight, mod.bias, mod.num_groups)
        ref = gn.groupnorm_swish_reference(x.float(), mod.weight.float(),
                                           mod.bias.float(), mod.num_groups)
        excess = ((out.float() - ref).abs() - TOL[torch.bfloat16]
                  - 2.0 ** -8 * ref.abs()).max().item()
        assert excess <= 0, (tuple(x.shape), excess)


@pytest.mark.gpu
def test_serving_chain_on_card_matches_cpu(cuda):
    """The sde_feat_pre4_roll_light chain on the light-scoring fixtures (6
    SDE-DPM-Solver++ steps, k=4, prefilter 2) through generate on the card
    and on the CPU with the same noise, fp32 without TF32: chip_smoke.py's
    check (the same selections, latents within SERVING_AGREE_TOL, launches
    as the shapes predict)."""
    chip_smoke.serving_card_vs_cpu(torch, PORT)


@pytest.mark.gpu
def test_groupnorm_swish_kernel_on_encoder(cuda):
    """Every one of the 21 GroupNorm+swish calls of one production-encoder
    encode of 16 chunks (seeded random weights, bf16) against the plain
    version at the real activations' tolerance (chip_smoke.check_encoder),
    and 21 launches per encode."""
    vae = pipeline.randomize_(pipeline.create_vae(
        encoder=True, dtype=torch.float32, device=cuda), seed=3).to(torch.bfloat16)
    rolls = torch.as_tensor(make_rolls(2, seed=12), device=cuda)
    gn.launches = 0
    with torch.no_grad():
        pipeline.encode_rolls(vae, rolls)
    torch.cuda.synchronize()
    assert gn.launches == 21
    out = chip_smoke.check_encoder(torch, gn, vae)
    assert out["launches_per_call"] == 21


@pytest.mark.gpu
def test_groupnorm_swish_kernel_grad_at_decoder_shapes(cuda):
    """The gradient through kernel 2's autograd Function at the 29 call
    shapes of one production decode of 16 chunks, bf16, against autograd
    through the plain version: max abs difference over the largest
    gradient within 1e-2 (chip_smoke.check_gn_backward)."""
    vae = pipeline.randomize_(pipeline.create_vae(
        dtype=torch.float32, device=cuda), seed=1).to(torch.bfloat16)
    out = chip_smoke.check_gn_backward(torch, gn, vae)
    assert out["max_rel_err"] <= GRAD_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_edit_and_dps_chains_on_card_match_cpu(cuda):
    """A 6-step edit chain with SCG k=4 and a 6-step DPS-rule chain on
    quality_tiny, card against CPU in fp32 without TF32, with the same
    noise (chip_smoke.edit_dps_card_vs_cpu: the same selections, the
    encoded gt, final latents and DPS gradient norms within 1e-3 of their
    largest magnitude, launches as the shapes predict)."""
    chip_smoke.edit_dps_card_vs_cpu(torch, PORT)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 128, 16, 72), (64, 256, 16, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_long_form_shapes(cuda, shape, dtype):
    """The stitched rollout's 64 windows: the half windows' 128 tokens and
    the full windows' 256, on views of one qkv tensor, one launch each."""
    b, n, h, d = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    name = fa.KERNEL_NAME[dtype]
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.kernel_launches == {**before, name: before[name] + 1}
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.gpu
def test_stitched_eps_on_card_matches_cpu(cuda):
    """quality_tiny's XS DiT stitched over a circle of three images (full
    and half windows), card against CPU in fp32, within 1e-5 of the
    largest value."""
    assert chip_smoke.stitched_eps_card_vs_cpu(torch, PORT) <= 1e-5


@pytest.mark.gpu
def test_stitched_windowed_chain_on_card_matches_cpu(cuda):
    """A 6-step stitched chain with SCG per 16-column window: the same
    picks in every window, latents within 1e-5 relative."""
    launches = chip_smoke.longform_card_vs_cpu(torch, PORT)
    assert launches["flash_attention_fp32"] > 0


@pytest.mark.gpu
def test_edm_worker_gradient_on_card_matches_cpu(cuda):
    """The circle-loss worker (its gradient through the XS DiT) within
    1e-5 relative, card against CPU, and a 4-step Heun chain with it within
    1e-4 and within 3 times the chain's own move under the worker's
    difference, on four draws (chip_smoke.edm_card_vs_cpu)."""
    worker_err, chain_err = chip_smoke.edm_card_vs_cpu(torch, PORT)
    assert worker_err <= 1e-5 and chain_err <= 1e-4
