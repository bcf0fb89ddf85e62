"""EDM (Karras et al. 2022) sigma-space sampler: Heun steps with churn.

Port of ``rule_guided_music_tpu/diffusion/edm.py`` (reference
diff_collage/generic_sampler.py:46-113). The denoiser is
sigma-parameterized, ``eps_fn(x, sigma_batch) -> eps`` with
x0 = x - sigma * eps. The JAX package runs the steps as one ``lax.scan``
with a ``lax.cond`` on the last step; here it is a Python loop and the
condition a branch on the host's value of the next sigma.

Randomness enters through ``noise_fn(kind, step, shape)``: ``kind`` is
"init" for x at sigma_max and "churn" for step ``step``'s churn noise. The
default draws from a ``torch.Generator``; the parity tests pass one that
replays the JAX key splits (``rng, init_rng`` first, then ``rng,
churn_rng`` per step), so both frameworks see the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .sampling import NoiseFn, torch_noise_fn
from .schedule import Tables


def karras_sigmas(num_steps: int, sigma_min: float = 1e-3,
                  sigma_max: float = 80.0, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigma schedule, descending, with a final 0."""
    ramp = np.linspace(0, 1, num_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.append(sigmas, 0.0)


def heun_sample_loop(
    eps_fn: Callable,
    shape: Tuple[int, ...],
    num_steps: int = 40,
    sigma_min: float = 1e-3,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    s_churn: float = 0.0,
    s_tmin: float = 0.05,
    s_tmax: float = 50.0,
    s_noise: float = 1.003,
    noise: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device="cuda",
) -> torch.Tensor:
    """Karras Heun sampler with churn (generic_sampler.py:46-113); returns
    the final x, the x0 estimate at sigma 0. ``noise`` replaces the initial
    draw; without ``noise_fn`` the draws come from ``generator`` on
    ``device``."""
    if noise_fn is None:
        noise_fn = torch_noise_fn(generator, device)
    if noise is None:
        noise = noise_fn("init", -1, tuple(shape))
    device = noise.device
    sigmas = torch.as_tensor(karras_sigmas(num_steps, sigma_min, sigma_max, rho),
                             dtype=torch.float32, device=device)
    host_sigmas = sigmas.cpu()
    x = noise * sigma_max
    gamma_max = min(s_churn / num_steps, np.sqrt(2.0) - 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(num_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        # churn: raise sigma and add the matching noise (the bounds compared
        # in float32, as jnp compares them)
        in_range = (np.float32(s_tmin) <= host_sigmas[i].numpy()
                    <= np.float32(s_tmax))
        gamma = torch.full((), gamma_max if in_range else 0.0,
                           dtype=torch.float32, device=device)
        sigma_hat = sigma * (1 + gamma)
        extra = torch.sqrt(torch.maximum(sigma_hat ** 2 - sigma ** 2, zero))
        x_hat = x
        if float(extra) > 0:
            # with no churn x_hat is x exactly, so the draw is skipped
            x_hat = x + extra * s_noise * noise_fn("churn", i, tuple(x.shape))
        d = eps_fn(x_hat, sigma_hat.expand(shape[0]))        # dx/dsigma = eps
        x = x_hat + (sigma_next - sigma_hat) * d
        # the Heun correction on every step but the last (sigma_next == 0)
        if float(host_sigmas[i + 1]) > 0:
            d2 = eps_fn(x, sigma_next.expand(shape[0]))
            x = x_hat + (sigma_next - sigma_hat) * 0.5 * (d + d2)
    return x


def vp_eps_fn_from_model(tables: Tables, model_fn: Callable, y=None) -> Callable:
    """A VP (DDPM epsilon) denoiser ``model_fn(x_t, model_t, y)`` as a
    sigma-space ``eps_fn(x, sigma_b)``: sigma(t) = sqrt(1 - acp) / sqrt(acp)
    and x_t = x * sqrt(acp), at the trained timestep whose sigma is nearest
    (the first of equals). The sigma table is float32, as the JAX package's
    is, so the nearest timestep ties the same way."""
    acp_np = tables.alphas_cumprod.cpu().numpy()
    sigmas_table = torch.as_tensor(np.sqrt(1.0 - acp_np) / np.sqrt(acp_np),
                                   device=tables.alphas_cumprod.device)

    def eps_fn(x: torch.Tensor, sigma_b: torch.Tensor) -> torch.Tensor:
        t = torch.argmin((sigmas_table[None, :] - sigma_b[:, None]).abs(), dim=-1)
        acp = tables.alphas_cumprod[t].reshape((-1,) + (1,) * (x.ndim - 1))
        return model_fn(x * torch.sqrt(acp), tables.model_t[t], y)

    return eps_fn
