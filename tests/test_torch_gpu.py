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
backward kernels, against autograd through the plain forward and against
the plain backward): max abs difference over the largest gradient, 1e-5
in fp32 (summation order and the 3xTF32 split, a few fp32 ulps of each
product) and 1e-2 in bf16 (the final rounding of each
gradient, 2^-8, plus P and dS rounded to bf16 where they enter a product;
tests/test_torch_backward.py emulates those roundings within 4.7e-3). The
fp32 kernels' LSE against flash_attention_reference_lse: 1e-5 absolute and
relative. The classifier gradient, card against CPU in fp32: 1e-4 of its
largest magnitude (the forward's summation order through two blocks).
GroupNorm+swish on the scoring decoder's real activations, whose outputs
exceed 8, in bf16: 2e-2 + 2^-8 |y| elementwise (half an ulp of |y|). The
serving chain, card against CPU in fp32: the same selections, final
latents within 1e-3. GroupNorm+swish gradients (the backward kernel,
against both plain versions): 1e-2 of the largest gradient in bf16, as
attention's, and 1e-4 in fp32 (sums over spans of up to 65536 elements). The edit and DPS
chains, card against CPU in fp32: 1e-3 of the largest magnitude. The
long-form checks (the stitched eps, a stitched chain with SCG per window,
the EDM circle-loss worker and a Heun chain with it), card against CPU in
fp32: 1e-5 of the largest magnitude, the same picks in every window;
the Heun chain's final latents 1e-4 on each of four draws (a 4-step chain
carries a 5e-7 relative change of the denoiser's output to 1.1e-5-3.4e-5
of them), and at most 3 times what moving the DiT's output by the
worker's measured difference does to them on either device. The pixel
paths and int8: kernel 1 at the UNet's and DiT-B/8's shapes to the same
limits; kernel 2 on a UNet forward at eps 1e-5 as on the scoring decoder;
QuantLinear card against CPU on fp32 inputs equal (w8a8: exact int8 sums,
the same float operations) and within 1e-5 (w8a16: fp32 summation order)
of its largest output; the
int8 kernels against their plain versions: the quantization (on every
route, on rows of halves, zeros and ties) and w8a8 equal bit for bit (the
same float operations), the one-call w8a8 linear equal to the two kernels
called apart, w8a16 in bf16 within one ulp (or, where a sum cancels, what
the order of K fp32 additions can move it) and in fp32 within 1e-5 of the
largest output; the
quantized XS_8 within JAX's envelope of the fp trunk (0.05 / 0.04) and
within 1e-3 / 1e-5 of the CPU's (an int8 step where an fp32 ulp crosses a
rounding boundary); a small UNet and 2-D DiT, forward within 1e-5 and a
4-step chain within 1e-3 of their largest magnitudes. compute_rule on
the card against the CPU on the same MIDI files: the float rules within
1e-5, chord tags equal except at an exact float64 tie (ROADMAP 3.1). A
train step, card against CPU in fp32: gradients within 1e-4 of the
largest, losses and EMA within 1e-5, parameters within 1e-5 of the
largest where the gradient is settled and within 2 lr elsewhere (Adam's
first update is +-lr whatever |g|; chip_smoke.update_agrees); resume
bit-equal on the card. A decoder-distill step, card against CPU in fp32,
is held the same way; kernel 2's backward with dw/dbias at the ch=64
distill student's shapes as at the UNet's.
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
    bwd = {gn.plan_bwd_slices((c // g) * hw * hw, size)[0]
           for c, hw, g in GN_SHAPES for size in (2, 4)}
    assert bwd == {1, 2, 4, 8, 16}


# the backward's shapes: every forward shape on 2 chunks, and train_vae's
# largest span, a 128 x 128 map at 256 channels, on 4 chunks
GN_GRAD_SHAPES = [(2,) + shape for shape in GN_SHAPES] + [(4, 256, 128, 32)]


def _gn_grad_inputs(cuda, n, c, hw, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((n, c, hw, hw), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
    return x, w, b, dy


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,hw,groups", GN_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel_grad(cuda, n, c, hw, groups, dtype):
    """dx, dw and dbias through the backward kernel (one backward call and
    one reduction launch) against autograd through the plain forward and
    against the plain backward, every cluster size of the backward's plan
    (1-16) and the element-by-element path (H*W = 25)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn((n, c, hw, hw), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    before = (gn.launches, gn.backward_launches, gn.param_grad_launches)
    got = torch.autograd.grad(gn.groupnorm_swish(*leaves, groups), leaves, dy)
    torch.cuda.synchronize()
    assert (gn.launches, gn.backward_launches, gn.param_grad_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert all(g.dtype == dtype for g in got)
    fp32 = [t.detach().float().requires_grad_() for t in (x, w, b)]
    autograd = torch.autograd.grad(gn.groupnorm_swish_reference(*fp32, groups),
                                   fp32, dy.float())
    plain = gn.groupnorm_swish_backward_reference(x, w, b, dy, groups)
    tol = 1e-4 if dtype == torch.float32 else GRAD_TOL[dtype]
    for name, g, a, p in zip(("dx", "dw", "dbias"), got, autograd, plain):
        errs = chip_smoke.rel_err(g, a), chip_smoke.rel_err(g, p)
        assert max(errs) <= tol, (name, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw", [(2, 32), (4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel_grad_x_only(cuda, n, hw, dtype):
    """A gradient with respect to x alone, as DPS takes it: one backward
    call, no reduction launch, no weight or bias gradient; 256 channels at
    a 32 x 32 and a 128 x 128 map."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, 256, hw, hw), generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(256, generator=gen, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(256, generator=gen, device=cuda)).to(dtype)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
    leaf = x.detach().requires_grad_()
    before = (gn.backward_launches, gn.param_grad_launches)
    out = gn.groupnorm_swish(leaf, w, b, 32)
    got = torch.autograd.grad(out, leaf, dy)[0]
    torch.cuda.synchronize()
    assert (gn.backward_launches, gn.param_grad_launches) == (before[0] + 1,
                                                              before[1])
    want = gn.groupnorm_swish_backward_reference(x, w, b, dy, 32)[0]
    tol = 1e-4 if dtype == torch.float32 else GRAD_TOL[dtype]
    assert chip_smoke.rel_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,hw,groups", [(2, 32, 8, 8), (2, 8, 5, 4),
                                           (4, 256, 128, 32), (2, 128, 128, 32)])
@pytest.mark.parametrize("params", [True, False], ids=["dx_dw_db", "dx"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel_grad_repeats_bit_equal(cuda, n, c, hw, groups,
                                                       params, dtype):
    """Two backward calls on the same inputs give bit-equal gradients: the
    kernel sums in a fixed order (no atomics), which a trainer's resume
    relies on; clusters of 1-16 blocks and the element-by-element path."""
    x, w, b, dy = _gn_grad_inputs(cuda, n, c, hw, dtype, seed=8)
    leaves = [x.requires_grad_()] + [t.requires_grad_(params) for t in (w, b)]
    wanted = leaves if params else leaves[:1]
    first, second = (torch.autograd.grad(gn.groupnorm_swish(*leaves, groups),
                                         wanted, dy) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
                                   (2, 256, 16, 72), (4, 256, 16, 72),
                                   (1, 5, 1, 128), (3, 70, 2, 1),
                                   (2, 100, 3, 36), (1, 512, 2, 64),
                                   (1, 513, 2, 64), (2, 448, 3, 128),
                                   (16, 257, 6, 64), (4, 512, 8, 64),
                                   (32, 257, 6, 64), (16, 256, 4, 96),
                                   (16, 64, 4, 128), (16, 256, 12, 64),
                                   (2, 4097, 6, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_grad(cuda, shape, dtype):
    """dq, dk, dv through the backward kernels (q, k, v views of one qkv
    tensor, as the DiT passes them; one forward and one backward call)
    against autograd through the plain forward and against the plain
    backward on the plain forward's output and LSE; the gradient paths'
    shapes (the classifiers, XL_8's rollout and training, DPS and the EDM
    ring), ragged N (257: a fifth tile of one row), D = 1, 36 (element by
    element) and 128, and the bf16 routes' edges: N = 512 (8 blocks of 4
    warps; 4 blocks of 8 warps at (4, 512, 8, 64), where 4-warp blocks
    would outnumber the SMs), 513 (past the cluster kernel) and
    (16, 257, 6, 64) (past the SMs with a near-empty last 8-warp block):
    the two-kernel path, as at DPS's (2, 256, 16, 72); and the classifier
    and pixel trainers' shapes: classifier_train_aug's (32, 257, 6, 64),
    the UNet's (16, 256, 4, 96) and (16, 64, 4, 128) at batch 16, DiT-B/8's
    (16, 256, 12, 64), and N = 4097 (DiT-S/2-cls) at batch 2."""
    b, n, h, d = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((b, n, 3, h, d), generator=gen,
                      device=cuda).to(dtype).requires_grad_()
    cot = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn.name() == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, qkv, cot)[0]
    torch.cuda.synchronize()
    name, bwd = fa.KERNEL_NAME[dtype], fa.BWD_KERNEL_NAME[dtype]
    assert fa.kernel_launches == {**before, name: before[name] + 1,
                                  bwd: before[bwd] + 1}
    want = torch.autograd.grad(fa.flash_attention_reference(q, k, v), qkv,
                               cot)[0]
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    ref_out, lse = fa.flash_attention_reference_lse(qf, kf, vf)
    plain = fa.flash_attention_backward_reference(qf, kf, vf, ref_out, lse,
                                                  cot.float())
    for i in range(3):
        errs = (chip_smoke.rel_err(got[:, :, i], want[:, :, i]),
                chip_smoke.rel_err(got[:, :, i], plain[i]))
        assert max(errs) <= GRAD_TOL[dtype], ("qkv"[i], errs)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 256, 16, 72), (2, 257, 6, 64),
                                   (3, 70, 2, 1), (1, 513, 2, 64),
                                   (16, 257, 6, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_grad_repeats_bit_equal(cuda, shape, dtype):
    """Two backward calls on the same inputs give bit-equal dq, dk, dv: no
    atomics, a fixed order of summation (train_dit's resume relies on it),
    in the cluster kernel (blocks of 8 and of 4 warps) and on the
    two-kernel path."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    leaves = [torch.randn(shape, generator=gen, device=cuda).to(dtype).requires_grad_()
              for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    out = fa.flash_attention(*leaves)
    first, second = (torch.autograd.grad(out, leaves, cot, retain_graph=True)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 257, 6, 64), (4, 256, 16, 72),
                                   (1, 512, 2, 64), (3, 70, 2, 64)])
def test_flash_attention_kernel_grad_widths_bit_equal(cuda, shape):
    """The bf16 cluster kernel with blocks of 4 warps and of 8 (each asked
    for through ``rgm_flash_attention_bwd_route``; 8-warp blocks exist for
    head dims 49-80) gives bit-equal dq, dk, dv: both sum each gradient in
    the same order, so the shape's choice of width moves no bit. The
    two-kernel route stays within GRAD_TOL of them."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    leaves = [torch.randn(shape, generator=gen, device=cuda,
                          dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    out = fa.flash_attention(*leaves)
    lib = fa._load("flash_attention_bwd")
    grads = {}
    try:
        for route in (4, 8, 1):
            assert lib.rgm_flash_attention_bwd_route(route) == 0
            grads[route] = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            torch.cuda.synchronize()
    finally:
        assert lib.rgm_flash_attention_bwd_route(0) == 0
    assert all(torch.equal(a, b) for a, b in zip(grads[4], grads[8]))
    for a, b in zip(grads[4], grads[1]):
        assert chip_smoke.rel_err(a, b) <= GRAD_TOL[torch.bfloat16]


# the fp32 kernels (csrc/flash_attention_fp32.cu, three TF32 products per
# product) at every ragged edge of their tiles (N: one row; a tile less one,
# exact, plus one; the classifiers' 257; the UNet's 1024) and every head dim
# they pad (8 -> 16, 33 and 36 -> 48 (element loads at 33), 64, 72, 96, 128)
FP32_NS = [1, 63, 64, 65, 257, 1024]
FP32_DS = [8, 33, 36, 64, 72, 96, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("n", FP32_NS)
@pytest.mark.parametrize("d", FP32_DS)
def test_flash_attention_fp32_kernel_forward_and_lse(cuda, n, d):
    """The fp32 forward on views of one qkv tensor against the plain
    version (ATTN_TOL), its LSE against flash_attention_reference_lse
    (1e-5 absolute and relative: log-sum-exps of logits below ~10 here,
    the kernel's error a few fp32 ulps of them), and the same bits on
    contiguous copies, with LSE recorded and on a repeat."""
    shape = (2, n, 3, d)
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    qkv = torch.randn((2, n, 3, 3, d), generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.kernel_launches == {**before, "flash_attention_fp32":
                                  before["flash_attention_fp32"] + 1}
    ref, ref_lse = fa.flash_attention_reference_lse(q, k, v)
    assert out.shape == shape
    assert (out - ref).abs().max().item() <= ATTN_TOL[torch.float32]
    lse = torch.empty((2, 3, n), device=cuda)
    assert torch.equal(fa._launch(q, k, v, lse), out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(fa.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous()), out)
    assert torch.equal(fa.flash_attention(q, k, v), out)


@pytest.mark.gpu
@pytest.mark.parametrize("n", FP32_NS)
@pytest.mark.parametrize("d", FP32_DS)
def test_flash_attention_fp32_kernel_grad(cuda, n, d):
    """dq, dk, dv through the fp32 backward kernels (views of one qkv
    tensor) against autograd through the plain forward and against the
    plain backward, within GRAD_TOL over the largest gradient (at N = 1,
    where dq and dk are zero but for rounding, over the largest of the
    three); a second backward call gives the same bits."""
    shape = (2, n, 3, d)
    gen = torch.Generator(device=cuda).manual_seed(2 * n + d)
    qkv = torch.randn((2, n, 3, 3, d), generator=gen, device=cuda).requires_grad_()
    cot = torch.randn(shape, generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, qkv, cot, retain_graph=True)[0]
    again = torch.autograd.grad(out, qkv, cot)[0]
    torch.cuda.synchronize()
    assert fa.kernel_launches == {
        **before, "flash_attention_fp32": before["flash_attention_fp32"] + 1,
        "flash_attention_bwd_fp32": before["flash_attention_bwd_fp32"] + 2}
    assert torch.equal(got, again)
    want = torch.autograd.grad(fa.flash_attention_reference(q, k, v), qkv, cot)[0]
    qf, kf, vf = (t.detach() for t in (q, k, v))
    plain = fa.flash_attention_backward_reference(
        qf, kf, vf, *fa.flash_attention_reference_lse(qf, kf, vf), cot)
    largest = want.abs().max()
    for i in range(3):
        scale = want[:, :, i].abs().max() if n > 1 else largest
        errs = [((got[:, :, i] - w).abs().max() / scale).item()
                for w in (want[:, :, i], plain[i])]
        assert max(errs) <= GRAD_TOL[torch.float32], ("qkv"[i], errs)


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
    assert out["max_abs_err"] <= GRAD_TOL[torch.bfloat16]


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.PIXEL_ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_pixel_shapes(cuda, shape, dtype):
    """The UNet's N=1024 (D=64), N=256 (D=96) and N=64 (D=128), 4 heads,
    and DiT-B/8 under CFG: contiguous and on views of one qkv tensor, one
    launch each."""
    b, n, h, d = shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=cuda).to(dtype)
    contiguous = tuple(x.contiguous() for x in qkv.unbind(2))
    name = fa.KERNEL_NAME[dtype]
    for q, k, v in (qkv.unbind(2), contiguous):
        before = dict(fa.kernel_launches)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert fa.kernel_launches == {**before, name: before[name] + 1}
        ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
        assert (out.float() - ref).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.gpu
def test_groupnorm_swish_kernel_on_unet(cuda):
    """Every fused GroupNorm+swish call of one forward of sample_pixel's
    UNet (B=1, bf16, seeded random weights) at eps 1e-5, on the inputs the
    forward gives it: 28 calls, 28 launches, each within 2e-2 + 2^-8 |y|."""
    unet = chip_smoke.unet_defaults(torch, pipeline, torch.bfloat16)
    x = torch.randn((1, 3, 128, 128), device=cuda)
    t = torch.full((1,), 300.0, device=cuda)
    calls, launches = chip_smoke.capture_norm_inputs(
        torch, gn, unet, lambda: unet(x, t, torch.ones(1, dtype=torch.long,
                                                       device=cuda)))
    assert len(calls) == launches == chip_smoke.UNET_GN_PER_FORWARD
    assert {mod.eps for _, mod in calls} == {1e-5}
    result = chip_smoke.check_norm_calls(torch, gn, calls, "a UNet forward",
                                         launches)
    assert result["launches_per_call"] == 28


@pytest.mark.gpu
def test_quant_linear_on_card_matches_cpu(cuda):
    """QuantLinear, both modes, card against CPU on the same fp32 inputs:
    w8a8 equal, w8a16 within 1e-5 of the largest output, a 16-row call
    included; the gradient with respect to the input within 1e-5 of its
    largest in both modes (the kernels' autograd Functions)."""
    worst = chip_smoke.check_quant_linear(torch)
    assert worst["w8a8"]["out"] == 0 and worst["w8a16"]["out"] <= 1e-5
    assert max(worst[mode]["grad"] for mode in worst) <= chip_smoke.QUANT_GRAD_TOL


# (rows, in, out): one row, a ragged M, N and K tail (K 96 is 1.5 w8a8
# k-tiles), an odd N (element stores), XL_8's fc2 at B=2, B_8's qkv; M and N
# ragged at the TMA boxes' edges with K a multiple of 16 but not of 64 (a
# tail k-tile; one k-tile), and fc2 at 64 rows (a k-split cluster)
QUANT_CASES = [(1, 64, 192), (77, 96, 200), (16, 1152, 77), (512, 4608, 1152),
               (300, 768, 2304), (300, 1168, 200), (33, 48, 130), (64, 4608, 1152)]
# the quantization's routes besides: (rows, K, 0) at K = 16, 1152, 4608 and
# 16400 (past the rows held in registers) and 1, 7, 512 and 8192 rows
QUANTIZE_CASES = QUANT_CASES + [(m, k, 0) for m, k in chip_smoke.QUANTIZE_CASES]
# w8a16 besides: XL_8's four linears at 512 and 8192 tokens, and M and N
# ragged at XL_8's K
W8A16_CASES = QUANT_CASES + [(m, k, n) for m in (512, 8192)
                             for k, n in chip_smoke.XL_LINEARS] + [
    (129, 1152, 3000), (1, 4608, 1160)]


def _quant_inputs(cuda, m, k, n, bias):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    return chip_smoke.quant_inputs(torch, gen, m, k, n, bias=bias)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QUANTIZE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_kernel(cuda, m, k, n, dtype):
    """The per-token quantization on every route (one thread a row at K =
    16, a warp at 1152, four at 4608, a row read twice past 16384), on rows
    whose x / s land on halves, all-zero rows (the 1e-8 floor) and rows
    tied at the amax: x_i8 and s_x equal to the plain version's bit for
    bit (true divisions on both sides)."""
    from rule_guided_music_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    off, (threads, rows, pieces) = chip_smoke.quantize_case(torch, quant, gen, m, k, dtype)
    assert off == 0
    assert (pieces == 0) == (k > 16384) and rows * threads >= 32


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QUANT_CASES + chip_smoke.QUANT_KERNEL_CASES)
@pytest.mark.parametrize("x_dtype,dtype", [(torch.bfloat16, torch.bfloat16),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float32, torch.float32),
                                           (torch.float32, torch.bfloat16)])
def test_w8a8_linear_one_call(cuda, m, k, n, x_dtype, dtype):
    """The whole w8a8 linear from one host call equal bit for bit to the
    quantization and the GEMM called apart, launching one of each."""
    from rule_guided_music_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    with torch.no_grad():
        assert chip_smoke.w8a8_linear_case(torch, quant, gen, m, k, n, x_dtype, dtype) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QUANT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a8_gemm_kernel(cuda, m, k, n, dtype, bias):
    """The s8 x s8 GEMM with its epilogue, equal to the plain version bit
    for bit, and the whole w8a8 path to its plain version."""
    from rule_guided_music_tpu_torch.ops import quant

    x, w8, sc, b = _quant_inputs(cuda, m, k, n, bias)
    q, s_x = quant.quantize_rows_reference(x)
    got = quant.w8a8_gemm(q, s_x[:, 0].contiguous(), w8, sc, b, dtype)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, quant.w8a8_gemm_reference(q, s_x, w8, sc, b, dtype))
    assert torch.equal(quant.quant_dense_apply(x, w8, sc, b, dtype),
                       quant.quant_dense_reference(x, w8, sc, b, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", W8A16_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a16_gemm_kernel(cuda, m, k, n, dtype, bias):
    """The GEMM that reads the int8 weight, against the plain fp32 product
    (no TF32): bf16 at most 0.1% of the outputs (or one) different, none
    by more than one ulp; fp32 (its own route and kernel) within 1e-5 of
    the largest."""
    from rule_guided_music_tpu_torch.ops import quant

    x, w8, sc, b = _quant_inputs(cuda, m, k, n, bias)
    x = x.to(dtype)
    before = dict(quant.kernel_launches)
    with chip_smoke.no_tf32(torch):
        got = quant.wo_dense_apply(x, w8, sc, b)
        want = quant.wo_dense_reference(x, w8, sc, b)
    name = "w8a16_gemm_fp32" if dtype == torch.float32 else "w8a16_gemm"
    assert quant.kernel_launches == {**before, name: before[name] + 1}
    assert got.dtype == dtype and got.shape == (m, n)
    if dtype == torch.bfloat16:
        share, beyond = quant.bf16_disagreement(got, want, x, w8, sc)
        assert beyond == 0
        assert share <= max(chip_smoke.QUANT_BF16_SHARE, 1 / got.numel())
    else:
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= chip_smoke.QUANT_LINEAR_TOL["w8a16"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", chip_smoke.QUANT_ROUTES)
@pytest.mark.parametrize("m,k,n", chip_smoke.QUANT_ROUTE_CASES)
def test_quant_gemm_routes(cuda, route, m, k, n):
    """Each route of the TMA GEMMs (BN tokens a block, blocks of a k-split
    cluster) forced, held to the limits of the kernel tests above: the
    quantization and w8a8 (bf16 and fp32 outputs, the unit-scale route of
    its backward) bit-equal, w8a16 in bf16 at most 0.1% of the outputs
    different and none by more than one ulp, in fp32 within 1e-5."""
    from rule_guided_music_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    with chip_smoke.no_tf32(torch), torch.no_grad(), quant.force_route(*route):
        assert quant.gemm_route(m, n, k, "w8a8")[0] == route[0]
        got = chip_smoke.quant_case(torch, quant, gen, m, k, n, bias=m % 2 == 0)
    assert got["quantize_rows"] == 0 and got["w8a8_gemm"] == 0
    assert got["w8a16_beyond"] == 0 and got["w8a16_share"] <= chip_smoke.QUANT_BF16_SHARE
    assert got["w8a16_fp32"] <= chip_smoke.QUANT_LINEAR_TOL["w8a16"]


@pytest.mark.gpu
def test_quantized_dit_on_card_within_jax_envelope(cuda):
    """quality_tiny's quantized XS_8 on the card: eps within JAX's
    envelope of the fp trunk (w8a8 0.05, w8a16 0.04) and within 1e-3 /
    1e-5 of the CPU's quantized model, and so its gradient with respect to
    x_t, the one DPS takes (``--quant`` with a DPS config)."""
    out = chip_smoke.quant_envelope_on_card(torch, PORT)
    assert out["w8a8"]["envelope"] < 0.05 and out["w8a16"]["envelope"] < 0.04
    for mode, tol in chip_smoke.QUANT_AGREE_TOL.items():
        assert out[mode]["grad_card_vs_cpu"] <= tol


@pytest.mark.gpu
def test_pixel_models_on_card_match_cpu(cuda):
    """A small UNet (with SCG) and a small 2-D DiT (with CFG), card
    against CPU in fp32: forward within 1e-5 of its largest value, a
    4-step chain with the same picks and within 1e-3."""
    out = chip_smoke.pixel_card_vs_cpu(torch, PORT)
    assert all(v["forward"] <= 1e-5 and v["chain"] <= 1e-3 for v in out.values())


@pytest.mark.gpu
def test_compute_rule_on_card_matches_cpu(cuda, tmp_path):
    """compute_rule's one batched call on the card against --device cpu on
    six seeded excerpts written as MIDI: chip_smoke.rules_agree."""
    from rule_guided_music_tpu_torch.constants import EXCERPT_COLS
    from rule_guided_music_tpu_torch.data.pianoroll import (
        finalize_decoded_sample, save_piano_roll_midi)
    from rule_guided_music_tpu_torch.eval_results import compute_rule

    midi_dir = tmp_path / "midi"
    save_piano_roll_midi(finalize_decoded_sample(make_rolls(6, seed=8)),
                         str(midi_dir), 100)
    card, cpu = (compute_rule.main(["--midi_dir", str(midi_dir), "--out",
                                    str(tmp_path / f"{d}.csv"), "--device", d])
                 for d in ("cuda", "cpu"))
    rolls = compute_rule.load_batch(compute_rule.midi_files(str(midi_dir)),
                                    EXCERPT_COLS, "cpu")
    worst, _ = chip_smoke.rules_agree(torch, card, cpu, rolls)
    assert worst <= chip_smoke.EVAL_RULE_AGREE_TOL


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One fp32 train step of a class-conditional DiTRotary_XS_8 (fp32
    attention kernels forward and backward), card against CPU without
    TF32: loss, per-example losses, gradient norm, EMA and the updated
    parameters within 1e-5 (chip_smoke.adam_step_agrees)."""
    assert chip_smoke.train_step_card_vs_cpu(torch, PORT) <= chip_smoke.TRAIN_AGREE_TOL


@pytest.mark.gpu
def test_vae_train_step_on_card_matches_cpu(cuda):
    """One fp32 VAE step at the fixture's geometry (kernel 2 forward and
    backward with dw/dbias on every norm), card against CPU."""
    assert chip_smoke.vae_step_card_vs_cpu(torch, PORT) <= chip_smoke.TRAIN_AGREE_TOL


@pytest.mark.gpu
def test_train_launches_per_step(cuda, tmp_path):
    """Launches per bf16 train step on the card: XS_8's 2 blocks take one
    forward (with LSE) and one backward call of kernel 1 each; the fixture
    VAE's encoder, without a gradient, one forward of kernel 2 per norm;
    the fp32 kernels none. Then resume: bit-equal on the card."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.training import train_loop as ttl
    from rule_guided_music_tpu_torch.utils import logger

    logger.configure(dir=str(tmp_path / "log"), format_strs=[])
    vae = pipeline.create_vae(FIXTURE, arch=dict(ch=32, ch_mult=(1, 1, 2, 2),
                                                 num_res_blocks=1), encoder=True)

    def rolls():
        while True:
            yield make_rolls(2, length=1536, seed=4), {"y": [0, 2]}

    loop = ttl.TrainLoop(model=chip_smoke.train_model(torch, "cuda"),
                         tables=make_schedule("linear", 1000).tables("cuda"),
                         data=rolls(), config=ttl.TrainConfig(log_interval=10),
                         vae_encode=vae.encode_moments, compute_dtype=torch.bfloat16)
    chip_smoke.reset_counts(fa, gn)
    loop.run_loop(max_steps=3)
    torch.cuda.synchronize()
    chip_smoke.check_launches(chip_smoke.read_counts(fa, gn), {
        "flash_attention": 2 * 3, "flash_attention_fp32": 0,
        "flash_attention_bwd": 2 * 3,
        "groupnorm_swish": chip_smoke.norm_calls(vae.encoder) * 3})
    assert loop.state.updates == 3
    chip_smoke.train_resume_on_card(torch, PORT, str(tmp_path))


@pytest.mark.gpu
def test_groupnorm_swish_kernel_grad_at_unet_training_shapes(cuda):
    """Kernel 2's backward with dw/dbias on every fused norm call of one
    forward of train_unet_pixel's UNet at batch 16 under autocast (bf16,
    eps 1e-5): 28 calls, each against autograd through the plain forward
    and the plain backward within GRAD_TOL, and bit-equal when repeated."""
    unet = chip_smoke.pixel_unet_train_model(torch)
    gen = torch.Generator(device=cuda).manual_seed(8)
    b = chip_smoke.PIXEL_UNET_BATCH
    x = torch.rand((b, 3, 128, 128), generator=gen, device=cuda) * 2 - 1
    t = torch.full((b,), 400.0, device=cuda)
    y = torch.arange(b, device=cuda) % 3
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, launches = chip_smoke.capture_norm_inputs(torch, gn, unet,
                                                         lambda: unet(x, t, y))
    assert len(calls) == launches == chip_smoke.UNET_GN_PER_FORWARD
    assert {mod.eps for _, mod in calls} == {1e-5}
    row = chip_smoke.check_gn_backward_calls(torch, gn, calls, "a UNet forward at 16")
    assert row["max_abs_err"] <= GRAD_TOL[torch.bfloat16] and row["bit_equal"]


@pytest.mark.gpu
def test_adafactor_step_on_card_matches_cpu(cuda):
    """One fp32 Adafactor train step of a 2-block rotary DiT 256 wide (its
    linears factored), card against CPU without TF32: the loss and the
    updated parameters within 1e-5, the second moments within 2e-4
    (chip_smoke.adafactor_card_vs_cpu raises past it)."""
    assert chip_smoke.adafactor_card_vs_cpu(torch, PORT) <= chip_smoke.TRAIN_AGREE_TOL


@pytest.mark.gpu
def test_encoder_unet_on_card_matches_cpu(cuda):
    """EncoderUNetModel forward and backward in fp32 (both kernels, kernel 2
    with dw/dbias), card against CPU without TF32: logits within 1e-4 and
    gradients within 1e-4 of the largest (chip_smoke.encoder_unet_card_vs_cpu)."""
    assert chip_smoke.encoder_unet_card_vs_cpu(torch, PORT) <= max(
        TOL[torch.float32], chip_smoke.TRAIN_GRAD_TOL)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The default process group of one rank (NCCL), as chip_smoke.py
    starts it; destroyed before its store's directory can go."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chip_smoke.init_world(torch, str(tmp_path_factory.mktemp("world")))
    yield dist
    dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_of_one_and_its_mesh(world):
    from torch.distributed.tensor import DTensor

    from rule_guided_music_tpu_torch.models.dit import DiT_models
    from rule_guided_music_tpu_torch.parallel import mesh as pm

    assert world.get_world_size() == 1 and world.get_backend() == "nccl"
    mesh = pm.make_mesh(1, 1, 1, device="cuda")
    with torch.device("cuda"):
        model = DiT_models["DiTRotary_XS_8"](num_classes=3)
    pm.shard_params(model, mesh)
    assert all(isinstance(p, DTensor) and p.device.type == "cuda"
               for p in model.parameters())
    seen = []
    model.blocks[0].attn.register_forward_pre_hook(
        lambda module, args: seen.append(module.qkv.weight))
    x = torch.randn(2, 4, 128, 16, device="cuda")
    model(x, torch.tensor([3, 500], device="cuda"), torch.tensor([0, 1], device="cuda"))
    # the block computes on its leaves, plain tensors on the shards' storage
    assert len(seen) == 1 and not isinstance(seen[0], DTensor)
    assert seen[0] is pm.leaf(model.blocks[0].attn.qkv.weight)
    assert isinstance(model.blocks[0].attn.qkv.weight, DTensor)


@pytest.mark.gpu
def test_mesh_train_step_on_card_matches_plain(world):
    """One fp32 XS_8 step through a (1, 1, 1) mesh (DTensor parameters, the
    kernels on local views) equals the plain step: the loss, the norms and
    the parameters within 1e-6; kernel 1 forward and backward launched
    once a block."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.parallel import mesh as pm
    from rule_guided_music_tpu_torch.training import train_loop as ttl

    tables = make_schedule("linear", 1000).tables(torch.device("cuda"))
    out = {}
    for label, mesh in (("plain", None), ("mesh", pm.make_mesh(1, 1, 1, device="cuda"))):
        model = chip_smoke.train_model(torch, torch.device("cuda"))
        if mesh is not None:
            pm.shard_params(model, mesh)
        cfg = ttl.TrainConfig()
        state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                               optimizer=ttl.make_optimizer(cfg, list(model.parameters())))
        step = ttl.make_train_step(model, tables, cfg, None, mesh)
        inputs = chip_smoke._train_inputs(torch, 5)
        chip_smoke.reset_counts(fa, gn)
        metrics = step(state, *[a.cuda() if torch.is_tensor(a) else a for a in inputs])
        launches = chip_smoke.read_counts(fa, gn)
        assert launches["flash_attention_fp32"] == launches["flash_attention_bwd_fp32"] \
            == len(model.blocks)
        out[label] = (metrics, {k: pm.full_tensor(v.detach()).cpu()
                                for k, v in model.named_parameters()})
    for key in ("loss", "grad_norm", "param_norm"):
        torch.testing.assert_close(out["mesh"][0][key], out["plain"][0][key],
                                   rtol=1e-6, atol=1e-6)
    for k, v in out["plain"][1].items():
        torch.testing.assert_close(out["mesh"][1][k], v, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["gpipe", "circular"])
def test_pipelined_forward_on_card(world, schedule):
    """pipelined_dit_rotary_apply over a 1-rank stage mesh against the
    model's forward, bf16 XS_8 at batch 8: within ATTN_TOL, kernel 1
    launched once a block a microbatch."""
    from torch.distributed.device_mesh import DeviceMesh

    from rule_guided_music_tpu_torch.parallel.pipeline import pipelined_dit_rotary_apply

    dit = pipeline.randomize_(pipeline.create_denoiser(
        "DiTRotary_XS_8", dtype=torch.bfloat16, device="cuda"), 3).eval()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((8, 4, 128, 16), generator=gen, device="cuda")
    t = torch.linspace(0, 900, 8, device="cuda")
    y = torch.arange(8, device="cuda") % 3
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("stage",))
    with torch.no_grad():
        ref = dit(x, t, y)
        chip_smoke.reset_counts(fa, gn)
        got = pipelined_dit_rotary_apply(dit, x, t, y, mesh=mesh, n_micro=4,
                                         schedule=schedule)
    micro = 4 if schedule == "gpipe" else 1
    assert fa.kernel_launches["flash_attention"] == len(dit.blocks) * micro
    assert chip_smoke.rel_err(got, ref) <= chip_smoke.ATTN_TOL["bfloat16"]


@pytest.mark.gpu
def test_groupnorm_swish_kernel_grad_at_scoring_decoder_distill_shapes(cuda):
    """Kernel 2's backward with dw/dbias on every fused norm call of the
    ch=64 ScoringDecoder student (distill_scoring_decoder's) decoding its
    batch of 32 chunks under autocast (bf16, fp32 masters): 29 calls, each
    against autograd through the plain forward and the plain backward
    within GRAD_TOL, and bit-equal when repeated."""
    from rule_guided_music_tpu_torch.models.vae import ScoringDecoder
    from rule_guided_music_tpu_torch.training.distill import flax_init_

    student = flax_init_(ScoringDecoder(ch=64), 3).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    z = torch.randn((chip_smoke.DISTILL_DECODER_CHUNKS, 4, 16, 16), generator=gen,
                    device=cuda)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, launches = chip_smoke.capture_norm_inputs(torch, gn, student,
                                                         lambda: student.decode(z))
    assert len(calls) == launches == chip_smoke.norm_calls(student.decoder) == 29
    row = chip_smoke.check_gn_backward_calls(torch, gn, calls,
                                             "the ch=64 distill student at 32")
    assert row["max_abs_err"] <= GRAD_TOL[torch.bfloat16] and row["bit_equal"]


@pytest.mark.gpu
def test_decoder_distill_step_on_card_matches_cpu(cuda):
    """One fp32 step of distill_scoring_decoder's update, card against CPU
    without TF32: the loss within 1e-5, gradients within 1e-4 of the
    largest, parameters as a train step's (chip_smoke.update_agrees)."""
    assert chip_smoke.distill_step_card_vs_cpu(torch, PORT) <= chip_smoke.TRAIN_AGREE_TOL
