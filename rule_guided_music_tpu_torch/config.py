"""Sampler configs and the YAML guidance-config loader.

Restates ``SamplerConfig``, ``GuidanceConfig`` and ``SCGConfig`` of
``rule_guided_music_tpu/diffusion/sampling.py:38-139`` and the loader of
``rule_guided_music_tpu/config.py``, limited to what this port runs: the
DDPM and DDIM chains with SCG. A YAML that asks for a sampler feature the
port does not have yet (DPM-Solver++, edit, reuse, prefilter, windowed SCG)
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
    """YAML ``guidance:`` block: the schedule that gates the SCG search
    (the port has no classifier guidance or DPS yet)."""

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

    def weight(self, rule_name: str) -> float:
        return dict(self.weights).get(rule_name, 1.0)


@dataclass(frozen=True)
class SamplerConfig:
    sampler: str = "ddpm"           # ddpm | ddim
    eta: float = 1.0                # DDIM eta (reference uses eta=1)
    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.FIXED_LARGE
    clip_denoised: bool = False
    t_end: int = 0                  # early stop (sampling.t_end)
    guidance: Optional[GuidanceConfig] = None
    scg: Optional[SCGConfig] = None
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
    if str(_ns_get(sampling_ns, "sampler", "") or "") not in ("", "ddpm", "ddim"):
        unsupported.append(f"sampling.sampler={sampling_ns.sampler}")
    if int(_ns_get(sampling_ns, "reuse_interval", 0) or 0) > 1:
        unsupported.append("sampling.reuse_interval")
    if _ns_get(guidance_ns, "method", "no_guidance") != "no_guidance":
        unsupported.append(f"guidance.method={guidance_ns.method}")
    scg_ns = _ns_get(config, "scg")
    if scg_on and int(_ns_get(scg_ns, "prefilter", 0) or 0) > 0:
        unsupported.append("scg.prefilter")
    if scg_on and int(_ns_get(_ns_get(guidance_ns, "dc"), "base", 0) or 0):
        unsupported.append("guidance.dc.base")
    if unsupported:
        raise NotImplementedError(
            "not in the torch port yet (see ROADMAP.md): " + ", ".join(unsupported))

    guidance = None
    if guidance_ns is not None:
        guidance = GuidanceConfig(
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
        )

    use_ddim = bool(_ns_get(sampling_ns, "use_ddim", False))
    sampler = str(_ns_get(sampling_ns, "sampler", "") or
                  ("ddim" if use_ddim else "ddpm"))
    return SamplerConfig(
        sampler=sampler,
        eta=1.0,
        var_type=(ModelVarType.LEARNED_RANGE if learn_sigma
                  else ModelVarType.FIXED_LARGE),
        clip_denoised=False,
        t_end=int(_ns_get(sampling_ns, "t_end", 0)),
        guidance=guidance,
        scg=scg,
        record=record,
    )
