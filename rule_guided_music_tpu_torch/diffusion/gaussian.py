"""Functional Gaussian-diffusion math over precomputed tables.

Port of ``rule_guided_music_tpu/diffusion/gaussian.py``: stateless
functions over a :class:`~.schedule.Tables` of tensors. The sampling half
(:48-190) has the edit branch of ``p_mean_variance`` (replacement-based
excerpt editing); the training half (:41-67, :194-373) has ``q_sample``,
the likelihood terms, ``training_losses`` for every mean, variance and
loss type, and the VLB in bits per dimension (``calc_bpd_loop``).
"""

from __future__ import annotations

import enum
import math
from typing import Callable, NamedTuple, Optional

import torch

from .schedule import Tables


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-step constants for a batch of t, broadcast to ndim dims."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_mean_variance(tables: Tables, x_start, t):
    mean = _extract(tables.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = _extract(1.0 - tables.alphas_cumprod, t, x_start.ndim)
    log_variance = _extract(tables.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


def q_sample(tables: Tables, x_start, t, noise):
    """Sample x_t ~ q(x_t | x_0)."""
    return (
        _extract(tables.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
        + _extract(tables.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
    )


def q_posterior_mean_variance(tables: Tables, x_start, x_t, t):
    """Moments of q(x_{t-1} | x_t, x_0)."""
    mean = (
        _extract(tables.posterior_mean_coef1, t, x_t.ndim) * x_start
        + _extract(tables.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    variance = _extract(tables.posterior_variance, t, x_t.ndim)
    log_variance = _extract(tables.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def predict_xstart_from_eps(tables: Tables, x_t, t, eps):
    return (
        _extract(tables.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - _extract(tables.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def predict_eps_from_xstart(tables: Tables, x_t, t, pred_xstart):
    return (
        _extract(tables.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - pred_xstart
    ) / _extract(tables.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def predict_xstart_from_xprev(tables: Tables, x_t, t, xprev):
    coef1 = _extract(tables.posterior_mean_coef1, t, x_t.ndim)
    coef2 = _extract(tables.posterior_mean_coef2, t, x_t.ndim)
    return xprev / coef1 - (coef2 / coef1) * x_t


class PMeanVar(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    eps: torch.Tensor


def p_mean_variance(
    tables: Tables,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: ModelMeanType = ModelMeanType.EPSILON,
    var_type: ModelVarType = ModelVarType.FIXED_LARGE,
    clip_denoised: bool = False,
    edit_mask: Optional[torch.Tensor] = None,
    edit_gt: Optional[torch.Tensor] = None,
) -> PMeanVar:
    """p(x_{t-1} | x_t) moments + x0 prediction from a raw model output
    (2C channels when the variance is learned). With ``edit_mask`` and
    ``edit_gt`` the x0 prediction takes gt where the mask is 1, before the
    clip, and eps is derived from the result (reference
    gaussian_diffusion.py:293-298)."""

    def process_xstart(x0):
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        model_output, model_var_values = torch.chunk(model_output, 2, dim=1)
        if var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = _extract(tables.posterior_log_variance_clipped, t, x.ndim)
            max_log = _extract(tables.log_betas, t, x.ndim)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        ones = torch.ones_like(x)
        model_variance = _extract(tables.fixed_large_variance, t, x.ndim) * ones
        model_log_variance = _extract(tables.fixed_large_log_variance, t, x.ndim) * ones
    elif var_type == ModelVarType.FIXED_SMALL:
        ones = torch.ones_like(x)
        model_variance = _extract(tables.posterior_variance, t, x.ndim) * ones
        model_log_variance = _extract(
            tables.posterior_log_variance_clipped, t, x.ndim) * ones
    else:
        raise NotImplementedError(var_type)

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(tables, x, t, model_output))
        model_mean = model_output
        eps = predict_eps_from_xstart(tables, x, t, pred_xstart)
    elif mean_type in (ModelMeanType.START_X, ModelMeanType.EPSILON):
        if mean_type == ModelMeanType.START_X:
            pred_xstart = model_output
        else:
            pred_xstart = predict_xstart_from_eps(tables, x, t, model_output)
        if edit_mask is not None:
            pred_xstart = edit_mask * edit_gt + (1.0 - edit_mask) * pred_xstart
        pred_xstart = process_xstart(pred_xstart)
        eps = predict_eps_from_xstart(tables, x, t, pred_xstart)
        model_mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, t)
    else:
        raise NotImplementedError(mean_type)

    return PMeanVar(model_mean, model_variance, model_log_variance,
                    pred_xstart, eps)


# likelihood helpers (reference: guided_diffusion/losses.py)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians, in nats; the log
    variances may be tensors or Python numbers."""
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float32)
    ref = next(v for v in (mean1, logvar1, mean2, logvar2)
               if isinstance(v, torch.Tensor))
    logvar1 = as_t(logvar1).to(ref.device)
    logvar2 = as_t(logvar2).to(ref.device)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to uint8-scaled [-1, 1]
    bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def vb_terms_bpd(tables: Tables, model_output, x_start, x_t, t, *,
                 mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                 clip_denoised: bool = False):
    """One VLB term in bits per dimension, KL at t > 0 and the decoder NLL
    at t == 0; returns (term, pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(tables, x_start, x_t, t)
    out = p_mean_variance(tables, model_output, x_t, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean,
                             out.log_variance)) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_xstart


def training_losses(tables: Tables, model_fn: Callable, x_start, t, noise, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                    loss_type: LossType = LossType.MSE,
                    model_kwargs: Optional[dict] = None):
    """Per-example training losses, a dict of (N,) tensors ("loss", and
    "mse" / "vb" where the loss type has them). ``model_fn(x_t, model_t,
    **model_kwargs)`` is the denoiser, conditioned on ``tables.model_t[t]``
    (reference gaussian_diffusion.py:1180-1253). A learned variance is
    trained by the VLB with the mean prediction detached."""
    model_kwargs = model_kwargs or {}
    x_t = q_sample(tables, x_start, t, noise)
    model_t = tables.model_t[t]
    terms = {}
    model_output = model_fn(x_t, model_t, **model_kwargs)
    if loss_type in (LossType.KL, LossType.RESCALED_KL):
        loss, _ = vb_terms_bpd(tables, model_output, x_start, x_t, t,
                               mean_type=mean_type, var_type=var_type)
        if loss_type == LossType.RESCALED_KL:
            loss = loss * tables.num_timesteps
        terms["loss"] = loss
        return terms
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        eps_out, var_values = torch.chunk(model_output, 2, dim=1)
        frozen = torch.cat([eps_out.detach(), var_values], dim=1)
        vb, _ = vb_terms_bpd(tables, frozen, x_start, x_t, t,
                             mean_type=mean_type, var_type=var_type)
        if loss_type == LossType.RESCALED_MSE:
            vb = vb * tables.num_timesteps / 1000.0
        terms["vb"] = vb
        model_output = eps_out
    if mean_type == ModelMeanType.PREVIOUS_X:
        target = q_posterior_mean_variance(tables, x_start, x_t, t)[0]
    elif mean_type == ModelMeanType.START_X:
        target = x_start
    else:
        target = noise
    terms["mse"] = mean_flat((target - model_output) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    return terms


def prior_bpd(tables: Tables, x_start):
    """The prior KL term of the VLB in bits per dimension
    (gaussian_diffusion.py:1255-1271)."""
    t = torch.full((x_start.shape[0],), tables.num_timesteps - 1,
                   dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(tables, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / math.log(2.0)


def calc_bpd_loop(tables: Tables, model_fn: Callable, x_start, noise_fn: Callable,
                  *, mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                  clip_denoised: bool = True, model_kwargs: Optional[dict] = None):
    """The whole VLB in bits per dimension, over t = T-1 down to 0
    (gaussian_diffusion.py:1273-1328). ``noise_fn(t)`` gives the noise of
    step t, x_start's shape (the JAX package draws it from a key split per
    step). Returns total_bpd and prior_bpd (N,), and the per-step vb,
    xstart_mse and mse (T, N) in that order of t."""
    model_kwargs = model_kwargs or {}
    b = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for t_scalar in range(tables.num_timesteps - 1, -1, -1):
        t = torch.full((b,), t_scalar, dtype=torch.long, device=x_start.device)
        noise = noise_fn(t_scalar)
        x_t = q_sample(tables, x_start, t, noise)
        model_output = model_fn(x_t, tables.model_t[t], **model_kwargs)
        term, pred_xstart = vb_terms_bpd(
            tables, model_output, x_start, x_t, t, mean_type=mean_type,
            var_type=var_type, clip_denoised=clip_denoised)
        vb.append(term)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        eps = predict_eps_from_xstart(tables, x_t, t, pred_xstart)
        mse.append(mean_flat((eps - noise) ** 2))
    vb, xstart_mse, mse = (torch.stack(a) for a in (vb, xstart_mse, mse))
    prior = prior_bpd(tables, x_start)
    return {"total_bpd": vb.sum(dim=0) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}
