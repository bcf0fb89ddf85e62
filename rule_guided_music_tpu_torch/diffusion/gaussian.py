"""Functional Gaussian-diffusion math over precomputed tables (sampling half).

Port of ``rule_guided_music_tpu/diffusion/gaussian.py:48-190``: stateless
functions over a :class:`~.schedule.Tables` of tensors, with the edit
branch of ``p_mean_variance`` (replacement-based excerpt editing). Training
losses and the likelihood terms wait for the training slice.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

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


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-step constants for a batch of t, broadcast to ndim dims."""
    out = table[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


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
