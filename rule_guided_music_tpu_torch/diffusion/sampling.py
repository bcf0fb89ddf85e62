"""The reverse chain with SCG (stochastic control guidance) selection.

Port of ``rule_guided_music_tpu/diffusion/sampling.py`` (``sample_loop``,
DDPM and DDIM branches; ``_tile``; ``_scg_select`` with ``decode_chunks``
grouping, the ``t == t_end`` boundary and the record outputs). The JAX
package runs the chain as one ``lax.scan`` with ``lax.cond`` branches;
PyTorch runs eagerly, so here it is a Python loop over the steps and the
branches are plain ``if``s.

Randomness enters through one ``noise_fn(kind, step, shape)`` argument:
``kind`` is "init" for x_T, "step" for a plain step's noise and "scg" for a
step of an SCG-configured chain (the k candidates on a guided step, one
draw on an unguided one); ``step`` counts executed steps from 0. The
default, :func:`torch_noise_fn`, draws from a ``torch.Generator``; the
parity tests pass one that replays the JAX key split order
(sampling.py:569, :591-592), so both frameworks see the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..config import SamplerConfig
from ..rules.registry import FUNC_DICT, LOSS_DICT
from . import gaussian as gd
from .schedule import Tables

NoiseFn = Callable[[str, int, Tuple[int, ...]], torch.Tensor]


def torch_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Standard-normal float32 draws from ``generator`` on ``device``."""

    def noise(kind: str, step: int, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=device)

    return noise


def guide_schedule_mask(t: int, t_start: int, t_end: int, interval: int) -> bool:
    """Guidance-schedule predicate (guidance.py:183-185; reference
    gaussian_diffusion.py:1398-1400), on the chain's own step index."""
    return (t < t_start) and (t >= t_end) and ((t + 1) % interval == 0)


def _split_eps(model_output: torch.Tensor, var_type: gd.ModelVarType) -> torch.Tensor:
    if var_type in (gd.ModelVarType.LEARNED, gd.ModelVarType.LEARNED_RANGE):
        return torch.chunk(model_output, 2, dim=1)[0]
    return model_output


def _tile(a: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat the batch k times, candidate-major (012012...), as the
    reference pairs expand/repeat (gaussian_diffusion.py:509-517)."""
    return torch.cat([a] * k, dim=0)


def _scg_select(
    config: SamplerConfig,
    tables: Tables,
    model_fn: Callable,
    decode_fn: Optional[Callable],
    rules: Mapping[str, torch.Tensor],
    noise: torch.Tensor,
    mean: torch.Tensor,
    g_coeff: torch.Tensor,
    t: torch.Tensor,
    y: Optional[torch.Tensor],
):
    """One SCG search step: k candidates, one-step rollout, decode, rule
    scores, weighted argmax per example (gaussian_diffusion.py:491-592).
    Returns (selected (B, ...), record dict)."""
    scg = config.scg
    k = scg.num_samples
    b = mean.shape[0]
    candidates = mean[None] + g_coeff[None] * noise          # (k, B, C, T, P)
    flat = candidates.reshape((k * b,) + tuple(mean.shape[1:]))
    t_k = _tile(t, k)
    y_k = _tile(y, k) if y is not None else None

    def rollout_and_decode(sl: slice):
        x_g, t_g = flat[sl], t_k[sl]
        model_out = model_fn(x_g, tables.model_t[t_g],
                             y_k[sl] if y_k is not None else None)
        eps = _split_eps(model_out, config.var_type)
        x0 = gd.predict_xstart_from_eps(tables, x_g, t_g, eps)
        return decode_fn(x0) if decode_fn is not None else x0

    # Rollout + decode in decode_chunks groups caps the decode working set.
    n_chunks = max(int(scg.decode_chunks), 1)
    if n_chunks > 1 and (k * b) % n_chunks == 0:
        g = k * b // n_chunks
        pred_xstart = torch.cat([rollout_and_decode(slice(i * g, (i + 1) * g))
                                 for i in range(n_chunks)], dim=0)
    else:
        pred_xstart = rollout_and_decode(slice(None))

    record: Dict[str, torch.Tensor] = {}
    total_log_prob = 0.0
    for rule_name, target in rules.items():
        gen_rule = FUNC_DICT[rule_name](pred_xstart)
        log_prob = -LOSS_DICT[rule_name](gen_rule, _tile(target, k))
        if config.record:
            record[f"loss/{rule_name}"] = (
                -log_prob.reshape(k, b).max(dim=0).values.mean())
        total_log_prob = total_log_prob + log_prob * scg.weight(rule_name)
    total_log_prob = total_log_prob.reshape(k, b)
    max_ind = torch.argmax(total_log_prob, dim=0)            # (B,)
    selected = candidates[max_ind, torch.arange(b, device=mean.device)]
    if config.record:
        best = torch.gather(total_log_prob, 0, max_ind[None])[0]
        record["log_prob"] = best.mean()
        record["loss_std"] = total_log_prob.std(unbiased=False)
        record["loss_range"] = (best.mean() - total_log_prob.min()).abs()
        record["candidate_log_prob"] = total_log_prob
    return selected, record


def _empty_record(config: SamplerConfig, rules, b: int, device):
    if not config.record:
        return {}
    zero = torch.zeros((), device=device)
    rec = {"log_prob": zero, "loss_std": zero, "loss_range": zero}
    if config.scg is not None:
        for rule_name in rules:
            rec[f"loss/{rule_name}"] = zero
        rec["candidate_log_prob"] = torch.zeros(
            (config.scg.num_samples, b), device=device)
    return rec


def sample_loop(
    model_fn: Callable,
    shape: Tuple[int, ...],
    tables: Tables,
    config: SamplerConfig,
    *,
    noise_fn: NoiseFn,
    y: Optional[torch.Tensor] = None,
    rules: Optional[Mapping[str, torch.Tensor]] = None,
    decode_fn: Optional[Callable] = None,
):
    """Run the reverse chain; returns (sample, records).

    ``model_fn(x, model_t, y)`` is the denoiser closure. ``records`` maps
    each record name to its per-step values stacked along dim 0 (empty
    unless ``config.record``), as the JAX scan stacks them.
    """
    if config.sampler not in ("ddpm", "ddim"):
        raise ValueError(f"sampler {config.sampler!r} is not in the torch port "
                         "(ddpm and ddim are)")
    rules = dict(rules or {})
    b = shape[0]
    g = config.guidance
    x = noise_fn("init", -1, tuple(shape))
    device = x.device
    start_t = tables.num_timesteps - 1
    steps = []
    for t_scalar in range(start_t, config.t_end - 1, -1):
        pos = start_t - t_scalar
        t = torch.full((b,), t_scalar, dtype=torch.long, device=device)
        model_out = model_fn(x, tables.model_t[t], y)
        pmv = gd.p_mean_variance(
            tables, model_out, x, t, mean_type=config.mean_type,
            var_type=config.var_type, clip_denoised=config.clip_denoised)

        if g is not None and g.schedule:
            use_guidance = guide_schedule_mask(t_scalar, g.t_start, g.t_end,
                                               g.interval)
        else:
            use_guidance = g is not None

        if config.sampler == "ddpm":
            g_coeff = torch.exp(0.5 * pmv.log_variance)
            base_mean = pmv.mean
        else:
            acp = gd._extract(tables.alphas_cumprod, t, x.ndim)
            acp_prev = gd._extract(tables.alphas_cumprod_prev, t, x.ndim)
            sigma = (config.eta * torch.sqrt((1 - acp_prev) / (1 - acp))
                     * torch.sqrt(1 - acp / acp_prev))
            base_mean = (pmv.pred_xstart * torch.sqrt(acp_prev)
                         + torch.sqrt(torch.clamp(1 - acp_prev - sigma ** 2,
                                                  min=0.0)) * pmv.eps)
            g_coeff = sigma

        if config.scg is not None:
            # At t == t_end the reference returns the bare mean (p_sample
            # :732-733): the SCG search is off there and the noise zeroed.
            if use_guidance and t_scalar > config.t_end:
                noise = noise_fn("scg", pos,
                                 (config.scg.num_samples,) + tuple(x.shape))
                x, record = _scg_select(config, tables, model_fn, decode_fn,
                                        rules, noise, base_mean, g_coeff, t, y)
            else:
                nz = float(t_scalar > config.t_end)
                x = base_mean + nz * g_coeff * noise_fn("scg", pos, tuple(x.shape))
                record = _empty_record(config, rules, b, device)
        else:
            if config.sampler == "ddpm":
                nonzero = float(t_scalar > config.t_end)
            else:
                nonzero = float(t_scalar != config.t_end)
            x = base_mean + nonzero * g_coeff * noise_fn("step", pos, tuple(x.shape))
            record = _empty_record(config, rules, b, device)
        steps.append(record)

    records = {}
    if config.record and steps:
        records = {name: torch.stack([r[name] for r in steps])
                   for name in steps[0]}
    return x, records
