"""KL-VAE training: L1 reconstruction + KL, optional patch-GAN and LPIPS.

Port of ``rule_guided_music_tpu/training/vae_train.py`` (reference
taming/modules/losses/contperceptual.py:7-110, the two-optimizer step of
taming/models/klvae_pedal.py:104-148). The released config trains L1 +
1e-2 KL with the discriminator and the perceptual term off. Parameters
and both Adam states are fp32; with ``compute_dtype=torch.bfloat16`` the
VAE runs under ``torch.autocast``, as the JAX script builds
``AutoencoderKL(dtype=bfloat16)``, and the losses, the discriminator and
LPIPS (fp32 modules in JAX) run in fp32 outside it. On the card every
GroupNorm+swish of the encoder and the decoder runs on kernel 2 forward
and backward, with the weight and bias gradients.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.vae import AutoencoderKL


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (taming/modules/discriminator/model.py:17),
    with the JAX module's names (``conv0``, ``conv{i}``, ``norm{i}``,
    ``conv_out``); GroupNorm eps 1e-6 as flax's. NCHW in, (B, 1, h, w)
    logits out."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        cin = ndf
        for i in range(1, n_layers + 1):
            ch = ndf * min(2 ** i, 8)
            stride = 2 if i < n_layers else 1
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 4, stride=stride,
                                                  padding=1, bias=False))
            self.add_module(f"norm{i}", nn.GroupNorm(min(32, ch), ch, eps=1e-6))
            cin = ch
        self.conv_out = nn.Conv2d(cin, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real, logits_fake):
    loss_real = torch.mean(F.relu(1.0 - logits_real))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


@dataclass
class VAETrainConfig:
    lr: float = 4.5e-6 * 128          # base_lr * batch (Lightning convention)
    kl_weight: float = 1e-2
    disc_weight: float = 0.0          # released config: disc off
    disc_start: int = 100_000
    perceptual_weight: float = 0.0    # released config: LPIPS off for rolls
    betas: Tuple[float, float] = (0.5, 0.9)


def make_vae_train_steps(vae: AutoencoderKL, config: VAETrainConfig,
                         disc: Optional[NLayerDiscriminator] = None, lpips=None,
                         compute_dtype: Optional[torch.dtype] = None):
    """(ae_opt, disc_opt, ae_step, disc_step): two Adam optimizers
    (betas (0.5, 0.9), eps 1e-8, as optax.adam) and the steps, which update
    in place.

    ``ae_step(batch, step, noise=None, generator=None) -> aux``: the VAE's
    loss (L1, plus ``perceptual_weight`` x LPIPS, plus ``kl_weight`` x the
    KL over the elements, plus ``disc_weight`` x the generator loss from
    ``disc_start`` on), one Adam update of the VAE. ``noise`` is the
    posterior draw (the latents' shape), else drawn from ``generator``.
    ``disc_step(batch, noise=None, generator=None) -> aux``: the hinge loss
    on real chunks and on a fresh reconstruction, one Adam update of the
    discriminator; None without a discriminator. ``aux`` holds 0-d
    tensors: rec_loss, kl_loss, g_loss, aeloss; discloss."""
    ae_params = [p for p in vae.parameters() if p.requires_grad]
    ae_opt = torch.optim.Adam(ae_params, lr=config.lr, betas=config.betas, eps=1e-8)
    disc_opt = (torch.optim.Adam(disc.parameters(), lr=config.lr,
                                 betas=config.betas, eps=1e-8)
                if disc is not None else None)
    if lpips is not None:
        lpips.requires_grad_(False)      # frozen, as JAX threads its params
    device = next(vae.parameters()).device
    use_disc = disc is not None and config.disc_weight > 0

    def reconstruct(batch, noise, generator):
        with torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                            enabled=compute_dtype is not None):
            return vae.reconstruct(batch, generator=generator, noise=noise)

    def ae_step(batch, step, noise=None, generator=None):
        for p in ae_params:
            p.grad = None
        recon, posterior = reconstruct(batch, noise, generator)
        rec_loss = torch.abs(batch - recon).mean()
        if lpips is not None and config.perceptual_weight > 0:
            rec_loss = rec_loss + config.perceptual_weight * lpips(batch, recon).mean()
        kl_loss = posterior.kl().mean() / math.prod(batch.shape[1:])
        loss = rec_loss + config.kl_weight * kl_loss
        g_loss = torch.zeros((), device=device)
        if use_disc:
            g_loss = -torch.mean(disc(recon))
            active = 1.0 if step >= config.disc_start else 0.0
            loss = loss + config.disc_weight * active * g_loss
        loss.backward()
        ae_opt.step()
        # the discriminator only reads: its gradients from g_loss are dropped
        if disc is not None:
            for p in disc.parameters():
                p.grad = None
        return {"rec_loss": rec_loss.detach(), "kl_loss": kl_loss.detach(),
                "g_loss": g_loss.detach(), "aeloss": loss.detach()}

    def disc_step(batch, noise=None, generator=None):
        for p in disc.parameters():
            p.grad = None
        with torch.no_grad():
            recon, _ = reconstruct(batch, noise, generator)
        loss = hinge_d_loss(disc(batch), disc(recon))
        loss.backward()
        disc_opt.step()
        return {"discloss": loss.detach()}

    return ae_opt, disc_opt, ae_step, disc_step if disc is not None else None
