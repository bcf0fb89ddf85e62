"""Sampler configs and the YAML guidance-config loader.

Restates ``SamplerConfig``, ``GuidanceConfig`` and ``SCGConfig`` of
``rule_guided_music_tpu/diffusion/sampling.py:38-139`` and the loader of
``rule_guided_music_tpu/config.py``: the DDPM, DDIM and DPM-Solver++ (2M,
SDE) chains with SCG (windowed on DiffCollage latents where ``dc_base`` is
set), prefilter re-ranking, classifier and DPS guidance, excerpt editing
(``EditConfig``), trajectory reuse and the record outputs;
:func:`collage_from_config` reads the DiffCollage geometry of the YAML's
``dc:`` block, as ``scripts/sample_rule.py`` does. A YAML that asks for a
sampler or guidance method the port does not have is refused with an error
instead of being run differently.

``yaml`` is imported inside :func:`load_config` only, and only for a file
that is not JSON, so nothing on the generation path needs PyYAML: where it
is missing (the card's image has none), a config written as JSON, the same
tree in YAML's JSON subset, runs the CLIs.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

from .diffusion.collage import circle_length, linear_length
from .diffusion.gaussian import ModelMeanType, ModelVarType


def diffusion_defaults() -> Dict[str, Any]:
    """The diffusion flags every training CLI takes (JAX config.py,
    reference script_util.py:13-26)."""
    return dict(learn_sigma=False, diffusion_steps=1000, noise_schedule="linear",
                timestep_respacing="", use_kl=False, predict_xstart=False,
                rescale_timesteps=False, rescale_learned_sigmas=False)


def add_dict_to_argparser(parser: argparse.ArgumentParser,
                          default_dict: Dict[str, Any]) -> argparse.ArgumentParser:
    """One ``--key`` flag per entry, typed by its default (JAX config.py):
    booleans through ``str2bool``, ``image_size`` as a list of ints."""
    from .sample_rule import str2bool

    for k, v in default_dict.items():
        v_type = str if v is None else str2bool if isinstance(v, bool) else type(v)
        if k == "image_size":
            parser.add_argument(f"--{k}", nargs="+", default=v, type=int)
        else:
            parser.add_argument(f"--{k}", default=v, type=v_type)
    return parser


@dataclass(frozen=True)
class GuidanceConfig:
    """YAML ``guidance:`` block minus the cond_fn spec: the guidance method,
    the schedule that gates the SCG search, and DPS's settings."""

    method: str = "no_guidance"     # classifier_guidance | dps | no_guidance
    schedule: bool = False
    t_start: int = 750
    t_end: int = 0
    interval: int = 1
    step_size: float = 1.0          # DPS step size
    nn: bool = False                # DPS: cond_fn sees latents (True) or decoded rolls


@dataclass(frozen=True)
class EditConfig:
    """YAML ``edit:`` block: replacement-based excerpt editing. The chain
    starts at step ``noise_level - 1`` of the (respaced) chain, and only
    the latent-time slice [l_start, l_end) is regenerated."""

    noise_level: int = 500
    l_start: int = 0
    l_end: int = 128


@dataclass(frozen=True)
class SCGConfig:
    """YAML ``scg:`` block: branching factor + per-rule selection weights."""

    num_samples: int = 16
    weights: Tuple[Tuple[str, float], ...] = ()
    # windowed selection: the argmax is taken per window of dc_base latent
    # columns of a (DiffCollage) latent; 0 = off
    dc_base: int = 0
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
    edit: Optional[EditConfig] = None
    # recompute the trajectory model's output every ``reuse_interval``
    # executed steps and reuse it in between (0/1 = off); steps with
    # t >= reuse_t_max always refresh (-1: no such window)
    reuse_interval: int = 0
    reuse_t_max: int = -1
    record: bool = False
    # also record each step's state x_{t-1} (steps x B x C x T x P)
    record_states: bool = False


def dict_to_obj(d):
    if isinstance(d, list):
        return [dict_to_obj(x) if isinstance(x, dict) else x for x in d]
    if not isinstance(d, dict):
        return d
    return SimpleNamespace(**{k: dict_to_obj(v) for k, v in d.items()})


def load_config(filename: str) -> SimpleNamespace:
    """Read a reference guidance YAML (or the same tree as JSON, which
    needs no PyYAML) into a recursive namespace."""
    with open(filename, "r") as f:
        text = f.read()
    try:
        tree = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        tree = yaml.safe_load(text)
    return dict_to_obj(tree)


def _ns_get(ns, key, default=None):
    return getattr(ns, key, default) if ns is not None else default


def sampler_config_from_yaml(
    config: SimpleNamespace,
    *,
    learn_sigma: bool = False,
    record: bool = False,
    record_states: bool = False,
    rule_names=(),
) -> SamplerConfig:
    """Translate a reference guidance YAML tree into a SamplerConfig
    (``rule_guided_music_tpu/config.py::sampler_config_from_yaml``). The
    windowed SCG base is ``guidance.dc.base``, or the top-level
    ``dc.base`` on a DiffCollage chain; ``record_states`` holds only with
    ``record``."""
    guidance_ns = _ns_get(config, "guidance")
    sampling_ns = _ns_get(config, "sampling")
    scg_on = bool(_ns_get(guidance_ns, "scg", False))

    unsupported = []
    if str(_ns_get(sampling_ns, "sampler", "") or "") not in (
            "", "ddpm", "ddim", "dpmpp"):
        unsupported.append(f"sampling.sampler={sampling_ns.sampler}")
    method = _ns_get(guidance_ns, "method", "no_guidance")
    if method not in ("no_guidance", "classifier_guidance", "dps"):
        unsupported.append(f"guidance.method={method}")
    scg_ns = _ns_get(config, "scg")
    if unsupported:
        # JAX documents these sets (its sampling.GuidanceConfig and
        # sample_loop); it refuses other samplers only when the chain
        # starts, and runs another method as classifier guidance
        raise NotImplementedError(
            "outside what the JAX package documents (sampling.sampler: ddpm, ddim, "
            "dpmpp; guidance.method: no_guidance, classifier_guidance, dps): "
            + ", ".join(unsupported))

    guidance = None
    if guidance_ns is not None:
        guidance = GuidanceConfig(
            method=method,
            schedule=bool(_ns_get(guidance_ns, "schedule", False)),
            t_start=int(_ns_get(guidance_ns, "t_start", 750)),
            t_end=int(_ns_get(guidance_ns, "t_end", 0)),
            interval=int(_ns_get(guidance_ns, "interval", 1)),
            step_size=float(_ns_get(guidance_ns, "step_size", 1.0)),
            nn=bool(_ns_get(guidance_ns, "nn", False)),
        )

    scg = None
    if scg_on:
        weights = tuple(
            (name, float(getattr(scg_ns, name)))
            for name in rule_names
            if hasattr(scg_ns, name)
        )
        dc_base = int(_ns_get(_ns_get(guidance_ns, "dc"), "base", 0) or 0)
        dc_ns = _ns_get(config, "dc")
        if not dc_base and dc_ns is not None and \
                bool(_ns_get(sampling_ns, "diff_collage", False)):
            dc_base = int(_ns_get(dc_ns, "base", 0) or 0)
        scg = SCGConfig(
            num_samples=int(_ns_get(scg_ns, "num_samples", 16)),
            weights=weights,
            dc_base=dc_base,
            prefilter=int(_ns_get(scg_ns, "prefilter", 0) or 0),
        )

    edit = None
    edit_ns = _ns_get(config, "edit")
    if edit_ns is not None:
        # ``edit.source`` (dataset or a MIDI path) is the CLI's to read
        edit = EditConfig(
            noise_level=int(_ns_get(edit_ns, "noise_level", 500)),
            l_start=int(_ns_get(edit_ns, "l_start", 0)),
            l_end=int(_ns_get(edit_ns, "l_end", 128)),
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
        edit=edit,
        record=record,
        record_states=record and record_states,
    )


def collage_geometry(circle: bool, num_img: int, overlap: int, batch_size: int,
                     in_channels: int = 4, image_size=(128, 16)):
    """(collage, gen_shape) of a DiffCollage chain: ``dict(num_img,
    overlap, circle)`` and the long latent's shape (its columns from
    ``circle_length`` or ``linear_length``)."""
    t_long = (circle_length(num_img, overlap) if circle
              else linear_length(num_img, overlap))
    return (dict(num_img=num_img, overlap=overlap, circle=circle),
            (batch_size, in_channels, t_long, image_size[1]))


def collage_from_config(config: SimpleNamespace, batch_size: int,
                        in_channels: int = 4, image_size=(128, 16)):
    """(collage, gen_shape) of a YAML tree (scripts/sample_rule.py:110-127):
    on a DiffCollage chain (``sampling.diff_collage``) the ``dc:`` block's
    :func:`collage_geometry`, else None and the excerpt's shape."""
    if not bool(_ns_get(_ns_get(config, "sampling"), "diff_collage", False)):
        return None, (batch_size, in_channels, *image_size)
    dc = config.dc
    return collage_geometry(dc.type == "circle", dc.num_img, dc.overlap_size,
                            batch_size, in_channels, image_size)
