"""Sampler configs and the YAML guidance-config loader.

Restates ``SamplerConfig``, ``GuidanceConfig`` and ``SCGConfig`` of
``rule_guided_music_tpu/diffusion/sampling.py:38-139`` and the loader of
``rule_guided_music_tpu/config.py``, limited to what this port runs: the
DDPM, DDIM and DPM-Solver++ (2M, SDE) chains with SCG, prefilter re-ranking,
classifier guidance and trajectory reuse. A YAML that asks for a sampler
feature the port does not have yet (DPS, edit, windowed SCG, DiffCollage)
is refused with an error instead of being run differently.

``yaml`` is imported inside :func:`load_config` only, so nothing on the
generation path needs PyYAML.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

from .diffusion.gaussian import ModelMeanType, ModelVarType


@dataclass(frozen=True)
class GuidanceConfig:
    """YAML ``guidance:`` block minus the cond_fn spec: the guidance method
    and the schedule that gates the SCG search (the port has no DPS yet)."""

    method: str = "no_guidance"     # classifier_guidance | no_guidance
    schedule: bool = False
    t_start: int = 750
    t_end: int = 0
    interval: int = 1


@dataclass(frozen=True)
class SCGConfig:
    """YAML ``scg:`` block: branching factor + per-rule selection weights."""

    num_samples: int = 16
    weights: Tuple[Tuple[str, float], ...] = ()
    decode_chunks: int = 1          # rollout+decode in this many groups
    # the rule-feature head ranks all k candidates, and only the top
    # ``prefilter`` are decoded and re-ranked by the rule programs; 0 = off
    prefilter: int = 0

    def weight(self, rule_name: str) -> float:
        return dict(self.weights).get(rule_name, 1.0)


@dataclass(frozen=True)
class SamplerConfig:
    sampler: str = "ddpm"           # ddpm | ddim | dpmpp
    eta: float = 1.0                # DDIM eta (reference uses eta=1)
    dpmpp_order: int = 2            # DPM-Solver++: 1 | 2 (the 2M scheme)
    dpmpp_sde: bool = False         # SDE-DPM-Solver++ (fresh noise each step)
    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.FIXED_LARGE
    clip_denoised: bool = False
    t_end: int = 0                  # early stop (sampling.t_end)
    guidance: Optional[GuidanceConfig] = None
    scg: Optional[SCGConfig] = None
    # recompute the trajectory model's output every ``reuse_interval``
    # executed steps and reuse it in between (0/1 = off); steps with
    # t >= reuse_t_max always refresh (-1: no such window)
    reuse_interval: int = 0
    reuse_t_max: int = -1
    record: bool = False


def dict_to_obj(d):
    if isinstance(d, list):
        return [dict_to_obj(x) if isinstance(x, dict) else x for x in d]
    if not isinstance(d, dict):
        return d
    return SimpleNamespace(**{k: dict_to_obj(v) for k, v in d.items()})


def load_config(filename: str) -> SimpleNamespace:
    """Read a reference guidance YAML into a recursive namespace."""
    import yaml

    with open(filename, "r") as f:
        return dict_to_obj(yaml.safe_load(f))


def _ns_get(ns, key, default=None):
    return getattr(ns, key, default) if ns is not None else default


def sampler_config_from_yaml(
    config: SimpleNamespace,
    *,
    learn_sigma: bool = False,
    record: bool = False,
    rule_names=(),
) -> SamplerConfig:
    """Translate a reference guidance YAML tree into a SamplerConfig
    (``rule_guided_music_tpu/config.py::sampler_config_from_yaml``)."""
    guidance_ns = _ns_get(config, "guidance")
    sampling_ns = _ns_get(config, "sampling")
    scg_on = bool(_ns_get(guidance_ns, "scg", False))

    unsupported = []
    if _ns_get(config, "edit") is not None:
        unsupported.append("edit")
    if bool(_ns_get(sampling_ns, "diff_collage", False)):
        unsupported.append("sampling.diff_collage")
    if str(_ns_get(sampling_ns, "sampler", "") or "") not in (
            "", "ddpm", "ddim", "dpmpp"):
        unsupported.append(f"sampling.sampler={sampling_ns.sampler}")
    method = _ns_get(guidance_ns, "method", "no_guidance")
    if method == "dps":
        unsupported.append("guidance.method=dps (DPS guidance: ROADMAP.md, "
                           "queue 1, item 8)")
    elif method not in ("no_guidance", "classifier_guidance"):
        unsupported.append(f"guidance.method={method}")
    scg_ns = _ns_get(config, "scg")
    if scg_on and int(_ns_get(_ns_get(guidance_ns, "dc"), "base", 0) or 0):
        unsupported.append("guidance.dc.base")
    if unsupported:
        raise NotImplementedError(
            "not in the torch port yet (see ROADMAP.md): " + ", ".join(unsupported))

    guidance = None
    if guidance_ns is not None:
        guidance = GuidanceConfig(
            method=method,
            schedule=bool(_ns_get(guidance_ns, "schedule", False)),
            t_start=int(_ns_get(guidance_ns, "t_start", 750)),
            t_end=int(_ns_get(guidance_ns, "t_end", 0)),
            interval=int(_ns_get(guidance_ns, "interval", 1)),
        )

    scg = None
    if scg_on:
        weights = tuple(
            (name, float(getattr(scg_ns, name)))
            for name in rule_names
            if hasattr(scg_ns, name)
        )
        scg = SCGConfig(
            num_samples=int(_ns_get(scg_ns, "num_samples", 16)),
            weights=weights,
            prefilter=int(_ns_get(scg_ns, "prefilter", 0) or 0),
        )

    use_ddim = bool(_ns_get(sampling_ns, "use_ddim", False))
    sampler = str(_ns_get(sampling_ns, "sampler", "") or
                  ("ddim" if use_ddim else "ddpm"))
    # empty YAML values parse to None: fall back as for an absent key
    dpmpp_order = _ns_get(sampling_ns, "dpmpp_order", 2)
    reuse_t_max = _ns_get(sampling_ns, "reuse_t_max", -1)
    return SamplerConfig(
        sampler=sampler,
        eta=1.0,
        dpmpp_order=int(2 if dpmpp_order is None else dpmpp_order),
        dpmpp_sde=bool(_ns_get(sampling_ns, "dpmpp_sde", False)),
        reuse_interval=int(_ns_get(sampling_ns, "reuse_interval", 0) or 0),
        reuse_t_max=int(-1 if reuse_t_max is None else reuse_t_max),
        var_type=(ModelVarType.LEARNED_RANGE if learn_sigma
                  else ModelVarType.FIXED_LARGE),
        clip_denoised=False,
        t_end=int(_ns_get(sampling_ns, "t_end", 0)),
        guidance=guidance,
        scg=scg,
        record=record,
    )
