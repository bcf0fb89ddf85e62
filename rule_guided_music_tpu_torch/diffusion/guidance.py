"""Guidance condition functions: classifier gradients, DPS values, rules.

Port of ``rule_guided_music_tpu/diffusion/guidance.py``. The JAX package
takes ``jax.grad`` of pure log-prob functions; here the grad-type cond_fn
re-enters grad mode on a detached copy of x_t and calls
``torch.autograd.grad``. Two kinds of cond_fn, as there:

  * grad-type (classifier guidance, the Sohl-Dickstein mean shift):
      cond_fn(x_t, t_model, rules) -> gradient, the shape of x_t
  * value-type (DPS): cond_fn(x0_or_decoded, t_model, rules) -> log-probs
      (B,); the sampler differentiates through the denoiser itself.

``rules`` maps rule_name -> (B, D) target. A classifier is any callable
``(x, t) -> logits`` (or ``(key_logits, chord_logits)``), for example a
``DiTRotaryClassifier``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..rules.registry import FUNC_DICT


def _mse_logprob(logits, target):
    return -((logits - target) ** 2).sum(dim=-1)


def _xent_logprob(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None].long())[..., 0]


# Per-rule log-prob programs (value functions); gradients come from autograd


def nn_zt_mse_logprob(classifier, x, t, rule):
    """log p from an MSE regressor head, per example."""
    return _mse_logprob(classifier(x, t), rule)


def nn_zt_xentropy_logprob(classifier, x, t, rule):
    """Cross-entropy head; the reference zeroes t here."""
    logits = classifier(x, torch.zeros_like(t))
    return _xent_logprob(logits, rule.reshape(-1))


def _chord_logprob(key_logits, chord_logits, rule, both):
    if both:
        key_lp = _xent_logprob(key_logits, rule[:, 0])
        return key_lp + _xent_logprob(chord_logits, rule[:, 1:]).mean(dim=-1)
    return _xent_logprob(chord_logits, rule).mean(dim=-1)


def nn_zt_chord_logprob(classifier, x, t, rule, both: bool = False):
    """Dual key + chord classifier; the chord term alone unless ``both``."""
    return _chord_logprob(*classifier(x, t), rule, both)


def _t0(x):
    return torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


def nn_z0_mse_logprob(classifier, x, t, rule):
    """DPS classifier at t = 0."""
    return _mse_logprob(classifier(x, _t0(x)), rule)


def nn_z0_chord_logprob(classifier, x, t, rule, both: bool = False):
    return _chord_logprob(*classifier(x, _t0(x)), rule, both)


def rule_x0_mse_logprob(rule_name, x, t, rule):
    """The rule program itself on decoded x0, as an MSE log-prob."""
    return _mse_logprob(FUNC_DICT[rule_name](x), rule)


# The cond_fn names of the YAML schema; CondFnSpec.logprob dispatches on
# exactly this set.
COND_FN_NAMES = (
    "grad_nn_zt_mse", "grad_nn_zt_xentropy", "grad_nn_zt_chord",
    "nn_z0_mse_dummy", "nn_z0_chord_dummy", "nn_z0_mse",
    "rule_x0_mse_dummy", "rule_x0_mse",
)


@dataclass(frozen=True)
class CondFnSpec:
    """One term of a composite cond_fn (one row of the YAML cond_fn block)."""

    fn: str                       # reference function name
    rule_name: str
    scale: float = 1.0
    classifier: Optional[Callable] = None   # (x, t) -> logits (or a pair)

    def logprob(self, x, t, rules) -> torch.Tensor:
        rule = rules[self.rule_name]
        if self.fn == "grad_nn_zt_mse":
            return nn_zt_mse_logprob(self.classifier, x, t, rule) * self.scale
        if self.fn == "grad_nn_zt_xentropy":
            # as the reference: t zeroed and no scale
            return nn_zt_xentropy_logprob(self.classifier, x, t, rule)
        if self.fn == "grad_nn_zt_chord":
            return nn_zt_chord_logprob(self.classifier, x, t, rule) * self.scale
        if self.fn in ("nn_z0_mse_dummy", "nn_z0_mse"):
            return nn_z0_mse_logprob(self.classifier, x, t, rule) * self.scale
        if self.fn == "nn_z0_chord_dummy":
            return nn_z0_chord_logprob(self.classifier, x, t, rule) * self.scale
        if self.fn in ("rule_x0_mse_dummy", "rule_x0_mse"):
            return rule_x0_mse_logprob(self.rule_name, x, t, rule) * self.scale
        raise NotImplementedError(self.fn)


def make_grad_cond_fn(specs: Sequence[CondFnSpec]) -> Callable:
    """Composite classifier-guidance cond_fn: the gradient with respect to
    x of the summed log-probs of every spec.

    The sampler runs under ``torch.no_grad()``; the cond_fn turns grad mode
    on for a detached copy of x, so the kernels' wrappers take their
    autograd branch here and nowhere else on the chain.
    """

    def cond_fn(x, t, rules):
        with torch.enable_grad():
            x_in = x.detach().requires_grad_()
            total = sum(spec.logprob(x_in, t, rules) for spec in specs).sum()
            return torch.autograd.grad(total, x_in)[0]

    return cond_fn


def make_value_cond_fn(specs: Sequence[CondFnSpec]) -> Callable:
    """Composite DPS cond_fn: per-example summed log-probs (B,)."""

    def cond_fn(x, t, rules):
        return sum(spec.logprob(x, t, rules) for spec in specs)

    return cond_fn


def make_model_fn(model_apply: Callable, num_classes: int,
                  class_cond: bool = True, cfg: bool = False,
                  w: float = 0.0) -> Callable:
    """Class-conditional denoiser closure with optional CFG
    ``(1+w) eps_c - w eps_null``, the two halves in one batched call.

    ``model_apply(x, t, y)`` is the raw network. The null class id is
    ``num_classes`` (the extra CFG-dropout row).
    """

    def model_fn(x, t, y=None):
        y_null = torch.full((x.shape[0],), num_classes, dtype=torch.long,
                            device=x.device)
        if not class_cond or y is None:
            return model_apply(x, t, y_null)
        if cfg:
            eps2 = model_apply(torch.cat([x, x]), torch.cat([t, t]),
                               torch.cat([y.long(), y_null]))
            eps_c, eps_u = eps2.chunk(2, dim=0)
            return (1 + w) * eps_c - w * eps_u
        return model_apply(x, t, y)

    return model_fn


def guide_schedule_mask(t: int, t_start: int, t_end: int, interval: int) -> bool:
    """Guidance-schedule predicate (reference gaussian_diffusion.py:1398-1400),
    on the chain's own step index."""
    return (t < t_start) and (t >= t_end) and ((t + 1) % interval == 0)
