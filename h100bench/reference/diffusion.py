"""Plain reference of the diffusion arithmetic the benchmark's cells run.

The linear beta schedule of 1000 steps and its respacing (an even
respacing "N" or "ddimN"), the epsilon-prediction posterior with the
"fixed large" variance, the DDPM and DDIM (eta) updates, the Sohl-Dickstein
mean shift of classifier guidance, the training loss (MSE on eps), and the
crossings between latent images and the VAE's 16 x 16 chunks. Tables are
computed in float64 on the host and used in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _spaced(steps: int, respacing: str) -> list:
    if not respacing:
        return list(range(steps))
    if respacing.startswith("ddim"):
        want = int(respacing[4:])
        for stride in range(1, steps):
            if len(range(0, steps, stride)) == want:
                return list(range(0, steps, stride))
        raise ValueError(respacing)
    count = int(respacing)
    stride = (steps - 1) / (count - 1) if count > 1 else 1
    return [round(i * stride) for i in range(count)]


class Schedule:
    """Per-step float32 tables on ``device``; ``model_t`` is the original
    step each (respaced) step conditions the denoiser on."""

    def __init__(self, steps: int = 1000, respacing: str = "", device="cpu"):
        base = np.linspace(1e-4 * 1000 / steps, 0.02 * 1000 / steps, steps)
        acp_all = np.cumprod(1.0 - base)
        keep = _spaced(steps, respacing)
        acp = acp_all[keep]
        acp_prev = np.append(1.0, acp[:-1])
        betas = 1.0 - acp / acp_prev
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.n = len(keep)
        self.acp, self.acp_prev = f(acp), f(acp_prev)
        self.sqrt_acp, self.sqrt_1macp = f(np.sqrt(acp)), f(np.sqrt(1 - acp))
        self.recip, self.recipm1 = f(np.sqrt(1 / acp)), f(np.sqrt(1 / acp - 1))
        self.coef1 = f(betas * np.sqrt(acp_prev) / (1 - acp))
        self.coef2 = f((1 - acp_prev) * np.sqrt(1 - betas) / (1 - acp))
        large = np.append(post_var[1], betas[1:])
        self.large_var, self.large_logvar = f(large), f(np.log(large))
        self.model_t = f(np.asarray(keep, np.float32))


def _b(table, t, ndim):
    v = table[t].float()
    return v.reshape(v.shape + (1,) * (ndim - 1))


def predict_x0(s: Schedule, x, t, eps):
    return _b(s.recip, t, x.ndim) * x - _b(s.recipm1, t, x.ndim) * eps


def ddpm_mean_var(s: Schedule, x, t, eps):
    """(posterior mean, variance, noise scale) of p(x_{t-1} | x_t)."""
    x0 = predict_x0(s, x, t, eps)
    mean = _b(s.coef1, t, x.ndim) * x0 + _b(s.coef2, t, x.ndim) * x
    var = _b(s.large_var, t, x.ndim)
    return mean, var, torch.exp(0.5 * _b(s.large_logvar, t, x.ndim))


def ddim_mean_sigma(s: Schedule, x, t, eps, eta):
    acp, prev = _b(s.acp, t, x.ndim), _b(s.acp_prev, t, x.ndim)
    x0 = predict_x0(s, x, t, eps)
    eps = (_b(s.recip, t, x.ndim) * x - x0) / _b(s.recipm1, t, x.ndim)
    sigma = eta * torch.sqrt((1 - prev) / (1 - acp)) * torch.sqrt(1 - acp / prev)
    mean = x0 * torch.sqrt(prev) + torch.sqrt(torch.clamp(1 - prev - sigma ** 2, min=0)) * eps
    return mean, sigma


def q_sample(s: Schedule, x0, t, noise):
    return _b(s.sqrt_acp, t, x0.ndim) * x0 + _b(s.sqrt_1macp, t, x0.ndim) * noise


def latent_to_chunks(z):
    """(B, C, 8P, P) latent image -> (8B, C, P, P), chunk-major."""
    b, c, t, p = z.shape
    n = t // p
    return z.permute(0, 1, 3, 2).reshape(b, c, p, n, p).permute(3, 0, 1, 2, 4).reshape(n * b, c, p, p)


def chunks_to_pixels(x, n):
    nb, c, h, w = x.shape
    return x.reshape(n, nb // n, c, h, w).permute(1, 2, 3, 0, 4).reshape(nb // n, c, h, n * w)


def decode_latents(vae, z, scale_factor, block=64):
    """Latent images -> (B, 3, 128, 8*128) rolls, the chunks decoded in
    blocks of ``block``."""
    n = z.shape[2] // z.shape[3]
    chunks = latent_to_chunks(z / scale_factor)
    out = torch.cat([vae.decode(chunks[i:i + block]) for i in range(0, len(chunks), block)])
    return chunks_to_pixels(out, n)


def kl_input(vae, rolls, scale_factor, shift_size=4, block=40):
    """Long rolls (B, 3, 128, L) -> overlapping latent excerpts
    (B * windows, 4, 128, 16): the posterior mode of each 128-column chunk,
    windows of 8 chunks every ``shift_size`` chunks, times ``scale_factor``.
    Returns (excerpts, moments of every chunk)."""
    b, c, h, length = rolls.shape
    n = length // h
    chunks = rolls.reshape(b, c, h, n, h).permute(3, 0, 1, 2, 4).reshape(n * b, c, h, h)
    moments = torch.cat([vae.encode_moments(chunks[i:i + block])
                         for i in range(0, len(chunks), block)])
    z = moments[:, :4]
    p = z.shape[-1]
    z = z.reshape(n, b, 4, p, p).permute(1, 2, 3, 0, 4).reshape(b, 4, p, n * p).transpose(2, 3)
    window, step = 8 * 16, 16 * shift_size
    wins = [z[:, :, i * step:i * step + window] for i in range((z.shape[2] - window) // step + 1)]
    out = torch.stack(wins, 1).reshape(-1, 4, window, p)
    return out.contiguous() * scale_factor, moments
