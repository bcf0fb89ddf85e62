"""work/'s operation counts against torch's FlopCounterMode run over the
plain reference, at narrow widths, and its parameter counts against the
reference modules."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import models as M
from work import dit, dit_classifier, kl_vae

DIT = dict(hidden_size=64, depth=2, num_heads=2, patch_size=8, in_channels=4,
           input_size=[128, 16], num_classes=3)
VAE = dict(ch=32, ch_mult=[1, 2, 2, 4], num_res_blocks=1, z_channels=4)


def flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("batch", [1, 3])
def test_dit_forward(batch):
    m = M.build("dit", DIT, "cpu").requires_grad_(False)
    x, t = torch.randn(batch, 4, 128, 16), torch.rand(batch) * 999
    y = torch.zeros(batch, dtype=torch.long)
    assert flops(lambda: m(x, t, y)) == dit.forward(DIT, batch)["flops"]
    assert sum(p.numel() for p in m.parameters()) == dit.params(DIT)


def test_dit_train_step_is_three_forwards():
    assert dit.train_step(DIT, 4)["flops"] == 3 * dit.forward(DIT, 4, 4)["flops"]


def test_attention_call():
    m = M.build("dit", DIT, "cpu").requires_grad_(False)
    attn = m.blocks[0].attn
    x = torch.randn(2, 256, 64)
    rot = M.rotary_table(256, 16, "cpu")
    assert flops(lambda: attn(x, rot)) == dit.attention(2, 256, 64)["flops"]


@pytest.mark.parametrize("chord,classes", [(False, 12), (True, 8)])
def test_classifier_forward_and_input_grad(chord, classes):
    arch = dict(DIT, num_classes=classes, chord=chord)
    m = M.build("classifier", arch, "cpu").requires_grad_(False)
    x, t = torch.randn(3, 4, 128, 16), torch.rand(3) * 999
    assert flops(lambda: m(x, t)) == dit_classifier.forward(arch, 3)["flops"]
    xx = x.clone().requires_grad_()
    out = m(xx, t)
    out = out[1] if chord else out
    assert flops(lambda: torch.autograd.grad(out.sum(), xx)) == \
        dit_classifier.input_grad(arch, 3)["flops"]
    assert sum(p.numel() for p in m.parameters()) == dit_classifier._params(arch)


def test_vae_decoder_and_encoder():
    v = M.build("vae", dict(VAE, encoder=True), "cpu").requires_grad_(False)
    assert flops(lambda: v.decoder(torch.randn(2, 4, 16, 16))) == kl_vae.decoder(VAE, 2)["flops"]
    assert flops(lambda: v.encoder(torch.randn(2, 3, 128, 128))) == kl_vae.encoder(VAE, 2)["flops"]
    dec = sum(p.numel() for p in [*v.decoder.parameters(), *v.post_quant_conv.parameters()])
    enc = sum(p.numel() for p in [*v.encoder.parameters(), *v.quant_conv.parameters()])
    assert (dec, enc) == (kl_vae._params(VAE, False), kl_vae._params(VAE, True))


def test_published_widths():
    """The counts the configurations' predictions rest on."""
    xl8 = dict(DIT, hidden_size=1152, depth=28, num_heads=16)
    f8 = dict(VAE, ch=128, num_res_blocks=2)
    assert dit.params(xl8) == 673_971_104
    assert round(dit.forward(xl8, 1)["flops"] / 1e9, 1) == 237.4
    assert round(kl_vae.decoder(f8, 1)["flops"] / 1e9, 1) == 114.5
    assert round(kl_vae.encoder(f8, 1)["flops"] / 1e9, 1) == 54.0
