"""The reverse chain with SCG (stochastic control guidance) selection.

Port of ``rule_guided_music_tpu/diffusion/sampling.py`` (``sample_loop``,
its DDPM, DDIM and DPM-Solver++ 2M/SDE branches and trajectory reuse;
``_tile``; ``_scg_select`` with ``decode_chunks``
grouping, the cheaper rollout denoiser, the rule-feature head, prefilter
re-ranking, the ``t == t_end`` boundary and the record outputs; classifier
guidance through ``_classifier_mean_shift`` and the eps-space shift). The JAX
package runs the chain as one ``lax.scan`` with ``lax.cond`` branches;
PyTorch runs eagerly, so here it is a Python loop over the steps and the
branches are plain ``if``s.

Randomness enters through one ``noise_fn(kind, step, shape)`` argument:
``kind`` is "init" for x_T, "step" for a plain step's noise and "scg" for a
step of an SCG-configured chain (the k candidates on a guided step, one
draw on an unguided one); ``step`` counts executed steps from 0. The
DPM-Solver++ ODE step draws nothing. The
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
from .guidance import guide_schedule_mask
from .schedule import Tables

NoiseFn = Callable[[str, int, Tuple[int, ...]], torch.Tensor]


def torch_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Standard-normal float32 draws from ``generator`` on ``device``."""

    def noise(kind: str, step: int, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=device)

    return noise


def _split_eps(model_output: torch.Tensor, var_type: gd.ModelVarType) -> torch.Tensor:
    if var_type in (gd.ModelVarType.LEARNED, gd.ModelVarType.LEARNED_RANGE):
        return torch.chunk(model_output, 2, dim=1)[0]
    return model_output


def _tile(a: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat the batch k times, candidate-major (012012...), as the
    reference pairs expand/repeat (gaussian_diffusion.py:509-517)."""
    return torch.cat([a] * k, dim=0)


def _rollout_x0(config: SamplerConfig, tables: Tables, rollout_fn: Callable,
                x_g: torch.Tensor, t_g: torch.Tensor, y_g) -> torch.Tensor:
    """One-step rollout of candidates to x̂0."""
    model_out = rollout_fn(x_g, tables.model_t[t_g], y_g)
    eps = _split_eps(model_out, config.var_type)
    return gd.predict_xstart_from_eps(tables, x_g, t_g, eps)


def _grouped(fn: Callable, n: int, groups: int):
    """``fn(slice)`` over ``groups`` equal slices of ``n`` items, results
    concatenated along dim 0 (dict values per key); one call over all
    items when ``groups`` does not divide ``n``."""
    if groups <= 1 or n % groups != 0:
        return fn(slice(None))
    g = n // groups
    parts = [fn(slice(i * g, (i + 1) * g)) for i in range(groups)]
    if isinstance(parts[0], dict):
        return {key: torch.cat([p[key] for p in parts], dim=0)
                for key in parts[0]}
    return torch.cat(parts, dim=0)


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
    scoring_model_fn: Optional[Callable] = None,
    scoring_feature_fn: Optional[Callable] = None,
):
    """One SCG search step: k candidates, one-step rollout, decode, rule
    scores, weighted argmax per example (gaussian_diffusion.py:491-592).
    Returns (selected (B, ...), record dict).

    ``scoring_model_fn`` is a cheaper denoiser for the rollout, and
    ``scoring_feature_fn`` the rule-feature head, which maps x̂0 to
    ``{rule: feature}`` with no decode. Both only rank the candidates: the
    selected candidate comes from the trajectory model's mean and sigma.
    With ``scg.prefilter`` > 0, a head and a decoder, the head ranks all k
    and the decoder re-ranks the top ones (:func:`_scg_select_prefilter`).
    """
    scg = config.scg
    k = scg.num_samples
    b = mean.shape[0]
    rollout_fn = scoring_model_fn if scoring_model_fn is not None else model_fn
    candidates = mean[None] + g_coeff[None] * noise          # (k, B, C, T, P)
    flat = candidates.reshape((k * b,) + tuple(mean.shape[1:]))
    t_k = _tile(t, k)
    y_k = _tile(y, k) if y is not None else None
    n_chunks = max(int(scg.decode_chunks), 1)

    def rollout(sl: slice) -> torch.Tensor:
        return _rollout_x0(config, tables, rollout_fn, flat[sl], t_k[sl],
                           y_k[sl] if y_k is not None else None)

    m = int(scg.prefilter or 0)
    if m > 0 and scoring_feature_fn is not None and decode_fn is not None:
        return _scg_select_prefilter(config, rollout, decode_fn,
                                     scoring_feature_fn, rules, candidates,
                                     n_chunks, k, b, min(m, k))

    def rollout_and_decode(sl: slice):
        x0 = rollout(sl)
        if scoring_feature_fn is not None:
            return scoring_feature_fn(x0)            # {rule: (g, D)}, no decode
        return decode_fn(x0) if decode_fn is not None else x0

    # Rollout + decode in decode_chunks groups caps the decode working set.
    pred_xstart = _grouped(rollout_and_decode, k * b, n_chunks)

    record: Dict[str, torch.Tensor] = {}
    total_log_prob = 0.0
    for rule_name, target in rules.items():
        if scoring_feature_fn is not None:
            gen_rule = pred_xstart[rule_name]
        else:
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
        record["selected"] = max_ind
    return selected, record


def top_m_indices(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Indices (m, B) of the m largest of ``scores`` (k, B) per column,
    largest first and, among equal scores, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties; a stable descending sort does)."""
    order = torch.sort(scores, dim=0, descending=True, stable=True).indices
    return order[:m]


def _scg_select_prefilter(config: SamplerConfig, rollout: Callable,
                          decode_fn: Callable, scoring_feature_fn: Callable,
                          rules: Mapping[str, torch.Tensor],
                          candidates: torch.Tensor, n_chunks: int, k: int,
                          b: int, m: int):
    """Prefilter re-ranking (sampling.py:312-409 of the JAX package): the
    rule-feature head scores all k rollouts with no decode, the top m per
    example are decoded (in ``decode_chunks`` groups) and re-ranked by
    ``FUNC_DICT``/``LOSS_DICT``, and the decode-ranked best is selected.
    ``loss_std``, ``loss_range`` and ``candidate_log_prob`` come from the
    head's scores, as there."""
    scg = config.scg
    x0_all = _grouped(rollout, k * b, n_chunks)
    feats = scoring_feature_fn(x0_all)
    head_lp = 0.0
    for rule_name, target in rules.items():
        head_lp = head_lp + (-LOSS_DICT[rule_name](feats[rule_name],
                                                   _tile(target, k))
                             * scg.weight(rule_name))
    head_lp = head_lp.reshape(k, b)

    top = top_m_indices(head_lp, m)                          # (m, B)
    x0_kb = x0_all.reshape((k, b) + tuple(x0_all.shape[1:]))
    cols = torch.arange(b, device=top.device)
    x0_top = x0_kb[top, cols].reshape((m * b,) + tuple(x0_all.shape[1:]))
    decoded = _grouped(lambda sl: decode_fn(x0_top[sl]), m * b, n_chunks)

    record: Dict[str, torch.Tensor] = {}
    full_lp = 0.0
    for rule_name, target in rules.items():
        lp = -LOSS_DICT[rule_name](FUNC_DICT[rule_name](decoded),
                                   _tile(target, m))
        if config.record:
            record[f"loss/{rule_name}"] = -lp.reshape(m, b).max(dim=0).values.mean()
        full_lp = full_lp + lp * scg.weight(rule_name)
    full_lp = full_lp.reshape(m, b)

    sel = torch.argmax(full_lp, dim=0)                       # (B,)
    max_ind = top[sel, cols]                                 # (B,)
    selected = candidates[max_ind, cols]
    if config.record:
        best = full_lp[sel, cols]
        record["log_prob"] = best.mean()
        record["loss_std"] = head_lp.std(unbiased=False)
        record["loss_range"] = (best.mean() - head_lp.min()).abs()
        record["candidate_log_prob"] = head_lp
        record["selected"] = max_ind
    return selected, record


def _classifier_mean_shift(tables: Tables, cond_fn: Callable, rules, x, t,
                           pmv: gd.PMeanVar):
    """Sohl-Dickstein mean shift: mean + variance * grad log p(y | x_t),
    with the cond_fn fed the model's timestep values; returns (shifted
    mean, gradient)."""
    gradient = cond_fn(x, tables.model_t[t], rules)
    return pmv.mean + pmv.variance * gradient, gradient


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
        rec["selected"] = torch.full((b,), -1, dtype=torch.long, device=device)
    return rec


def check_config(config: SamplerConfig) -> None:
    """The JAX package's refusals (sampling.py:539-558): an unknown
    sampler; SCG on the deterministic DPM-Solver++ ODE (all k candidates
    would coincide); ``dpmpp_sde`` without dpmpp; a dpmpp order other than
    1 or 2."""
    if config.sampler not in ("ddpm", "ddim", "dpmpp"):
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if (config.sampler == "dpmpp" and config.scg is not None
            and not config.dpmpp_sde):
        raise ValueError(
            "SCG requires a stochastic sampler (ddpm, ddim with eta > 0, or "
            "dpmpp with dpmpp_sde=True): the deterministic DPM-Solver++ ODE "
            "makes all k SCG candidates coincide")
    if config.dpmpp_sde and config.sampler != "dpmpp":
        raise ValueError("dpmpp_sde=True only applies to sampler='dpmpp' "
                         f"(got sampler={config.sampler!r})")
    if config.sampler == "dpmpp" and config.dpmpp_order not in (1, 2):
        raise ValueError(f"dpmpp_order must be 1 or 2, got {config.dpmpp_order}")


def _dpmpp_step(config: SamplerConfig, x, pred_xstart, acp, acp_prev, prev,
                use2: bool):
    """DPM-Solver++ (data prediction) in lambda = log(alpha/sigma): returns
    (mean, noise coefficient, lambda_t). Order 1 uses D = x̂0; the 2M
    scheme extrapolates D from the previous step's (x̂0, lambda) ``prev``
    where ``use2``. sigma_{t-1} is clamped away from 0, so the final step
    reduces to alpha_0 D. The SDE variant contracts x_t by e^-h and adds
    noise of scale sigma_{t-1} sqrt(-expm1(-2h)) (sampling.py:682-729)."""
    alpha_t = torch.sqrt(acp)
    sigma_t = torch.sqrt(1.0 - acp)
    alpha_p = torch.sqrt(acp_prev)
    sigma_p = torch.sqrt(torch.clamp(1.0 - acp_prev, min=1e-24))
    lam_t = torch.log(alpha_t) - torch.log(sigma_t)
    lam_p = torch.log(alpha_p) - torch.log(sigma_p)
    h = lam_p - lam_t
    d_bar = pred_xstart
    if use2:
        prev_x0, prev_lam = prev
        corr = 1.0 / (2.0 * ((lam_t - prev_lam) / h))
        d_bar = (1.0 + corr) * pred_xstart - corr * prev_x0
    if config.dpmpp_sde:
        one_m_e2h = -torch.expm1(-2.0 * h)
        mean = (sigma_p / sigma_t) * torch.exp(-h) * x + alpha_p * one_m_e2h * d_bar
        return mean, sigma_p * torch.sqrt(one_m_e2h), lam_t
    mean = (sigma_p / sigma_t) * x - alpha_p * torch.expm1(-h) * d_bar
    return mean, torch.zeros_like(sigma_p), lam_t


def sample_loop(
    model_fn: Callable,
    shape: Tuple[int, ...],
    tables: Tables,
    config: SamplerConfig,
    *,
    noise_fn: NoiseFn,
    y: Optional[torch.Tensor] = None,
    rules: Optional[Mapping[str, torch.Tensor]] = None,
    cond_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    scoring_model_fn: Optional[Callable] = None,
    scoring_feature_fn: Optional[Callable] = None,
):
    """Run the reverse chain; returns (sample, records).

    ``model_fn(x, model_t, y)`` is the denoiser closure; ``cond_fn`` the
    grad-type cond_fn of classifier guidance (``guidance.make_grad_cond_fn``)
    or None. In DDPM the guided mean applies on every step when SCG is on
    (the schedule gates only the SCG search) and where the schedule holds
    otherwise; DDIM and DPM-Solver++ shift eps where the schedule holds.
    ``scoring_model_fn`` and ``scoring_feature_fn`` only rank SCG
    candidates (:func:`_scg_select`). ``records`` maps each record name to
    its per-step values stacked along dim 0 (empty unless
    ``config.record``), as the JAX scan stacks them; with a cond_fn it adds
    ``guidance_grad_norm``, the L2 norm of each step's classifier gradient
    over the batch (0 where no guidance ran); SCG chains add ``selected``,
    each example's chosen candidate (-1 where no search ran).

    The JAX package's ``t_begin``/``t_stop`` segments are not ported: they
    keep each ``lax.scan`` dispatch short, and an eager loop launches every
    step on its own.
    """
    check_config(config)
    rules = dict(rules or {})
    b = shape[0]
    g = config.guidance
    guided = cond_fn is not None and g is not None
    if guided and g.method == "dps":
        raise NotImplementedError("DPS guidance is not in the torch port yet "
                                  "(ROADMAP.md, queue 1, item 8)")
    reuse_n = int(config.reuse_interval or 0)
    dpmpp_multistep = config.sampler == "dpmpp" and config.dpmpp_order >= 2
    x = noise_fn("init", -1, tuple(shape))
    start_t = tables.num_timesteps - 1
    device = x.device
    cached_out = None
    prev = None                                  # the 2M scheme's (x̂0, lambda)
    steps = []
    for t_scalar in range(start_t, config.t_end - 1, -1):
        pos = start_t - t_scalar
        t = torch.full((b,), t_scalar, dtype=torch.long, device=device)
        if reuse_n > 1:
            # refresh on every reuse_n-th executed step (the first always)
            # and at t >= reuse_t_max; the cache is fp32, as in the JAX
            # package, which casts refreshed outputs too
            refresh = pos % reuse_n == 0 or (
                config.reuse_t_max >= 0 and t_scalar >= config.reuse_t_max)
            if refresh:
                cached_out = model_fn(x, tables.model_t[t], y).float()
            model_out = cached_out
        else:
            model_out = model_fn(x, tables.model_t[t], y)
        pmv = gd.p_mean_variance(
            tables, model_out, x, t, mean_type=config.mean_type,
            var_type=config.var_type, clip_denoised=config.clip_denoised)

        if g is not None and g.schedule:
            use_guidance = guide_schedule_mask(t_scalar, g.t_start, g.t_end,
                                               g.interval)
        else:
            use_guidance = g is not None

        grad = None
        if config.sampler == "ddpm":
            g_coeff = torch.exp(0.5 * pmv.log_variance)
            base_mean = pmv.mean
            if guided and (config.scg is not None or use_guidance):
                base_mean, grad = _classifier_mean_shift(tables, cond_fn, rules,
                                                         x, t, pmv)
        else:
            acp = gd._extract(tables.alphas_cumprod, t, x.ndim)
            acp_prev = gd._extract(tables.alphas_cumprod_prev, t, x.ndim)
            pred_xstart, eps = pmv.pred_xstart, pmv.eps
            if guided and use_guidance:
                # condition_score: the guidance enters in eps space
                grad = cond_fn(x, tables.model_t[t], rules)
                eps = eps - torch.sqrt(1 - acp) * grad
                pred_xstart = gd.predict_xstart_from_eps(tables, x, t, eps)
            if config.sampler == "ddim":
                sigma = (config.eta * torch.sqrt((1 - acp_prev) / (1 - acp))
                         * torch.sqrt(1 - acp / acp_prev))
                base_mean = (pred_xstart * torch.sqrt(acp_prev)
                             + torch.sqrt(torch.clamp(1 - acp_prev - sigma ** 2,
                                                      min=0.0)) * eps)
                g_coeff = sigma
            else:
                # order 1 on the first step (no history) and on the final
                # one, where the 2M coefficient would scale the last jump
                # by a factor the sigma clamp sets (diffusers'
                # lower_order_final)
                use2 = dpmpp_multistep and pos > 0 and t_scalar != config.t_end
                base_mean, g_coeff, lam_t = _dpmpp_step(
                    config, x, pred_xstart, acp, acp_prev, prev, use2)
                if dpmpp_multistep:
                    prev = (pred_xstart, lam_t)

        if config.scg is not None:
            # At t == t_end the reference returns the bare mean (p_sample
            # :732-733): the SCG search is off there and the noise zeroed.
            if use_guidance and t_scalar > config.t_end:
                noise = noise_fn("scg", pos,
                                 (config.scg.num_samples,) + tuple(x.shape))
                x, record = _scg_select(config, tables, model_fn, decode_fn,
                                        rules, noise, base_mean, g_coeff, t, y,
                                        scoring_model_fn, scoring_feature_fn)
            else:
                nz = float(t_scalar > config.t_end)
                x = base_mean + nz * g_coeff * noise_fn("scg", pos, tuple(x.shape))
                record = _empty_record(config, rules, b, device)
        elif config.sampler == "dpmpp" and not config.dpmpp_sde:
            x = base_mean                        # the ODE step draws no noise
            record = _empty_record(config, rules, b, device)
        else:
            if config.sampler == "ddpm":
                nonzero = float(t_scalar > config.t_end)
            else:
                # ddim / sde-dpmpp: the bare mean at the boundary step
                nonzero = float(t_scalar != config.t_end)
            x = base_mean + nonzero * g_coeff * noise_fn("step", pos, tuple(x.shape))
            record = _empty_record(config, rules, b, device)
        if config.record and guided:
            record["guidance_grad_norm"] = (
                grad.float().norm() if grad is not None
                else torch.zeros((), device=device))
        steps.append(record)

    records = {}
    if config.record and steps:
        records = {name: torch.stack([r[name] for r in steps])
                   for name in steps[0]}
    return x, records
