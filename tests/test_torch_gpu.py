"""The port's hand-written kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device (decided
inside the ``cuda`` fixture, never at import). The card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: max abs error against the plain version run in float32 on the
same values; fp32 allows summation-order differences, bf16 the final
rounding of outputs below 8 to bf16 (half an ulp <= 2^-7).
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 16, 72), (2, 257, 6, 64),
                                   (1, 5, 1, 128), (3, 70, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
def test_flash_attention_kernel_strided_qkv(cuda):
    """q, k, v as views of one (B, N, 3, H, D) tensor, as the DiT passes them."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((2, 256, 3, 16, 72), generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw,groups", [(512, 16, 32), (256, 64, 32),
                                         (128, 128, 32), (8, 5, 4)])
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
