"""High-level assembly: models, sampler and targets for guided generation.

Port of the SCG and classifier-guidance path of
``rule_guided_music_tpu/pipeline.py``: ``DenoiserBundle``/``VAEBundle``
become :func:`create_denoiser` / :func:`create_vae` (modules in bf16 on one
device, random weights with a warning when no path is given, as
``pipeline.py:100-105`` does), ``build_classifier_bundles`` returns the
classifiers as modules, and ``make_sample_fn`` becomes :func:`generate`,
which runs the chain eagerly.
Every entry point takes ``device="cuda"`` by default and raises when there
is no card; the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from . import convert
from .config import SamplerConfig
from .constants import DEFAULT_SCALE_FACTOR, NUM_CLASSES
from .diffusion.guidance import CondFnSpec, make_grad_cond_fn, make_model_fn
from .diffusion.latent import make_decode_fn
from .diffusion.sampling import NoiseFn, sample_loop, torch_noise_fn
from .diffusion.schedule import Tables
from .models.dit import DiT_models, DiTRotary, DiTRotaryClassifier
from .models.vae import AutoencoderKL
from .rules.registry import FUNC_DICT
from .utils.fixtures import load_fixture_npz


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises for CUDA when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run the plain versions on the CPU")
    return device


def _warn(msg: str) -> None:
    print(f"WARNING: {msg}", file=sys.stderr)


def load_weights(module: torch.nn.Module, path: str, kind: str) -> None:
    """Load ``path`` into ``module`` (``kind``: "dit", "vae" or "cls"): an
    ``.npz`` of the JAX package's flat parameters (a checkpoint, or a test
    fixture holding ``dit/`` and ``vae/`` parts), converted by
    ``convert.py``; or a torch state_dict file with the reference's names
    (``.pt``/``.pth``/``.ckpt``)."""
    if path.endswith(".npz"):
        flat = dict(np.load(path))
        if any(k.startswith(f"{kind}/") for k in flat):   # a test fixture
            flat = load_fixture_npz(path)[kind]
        to_state_dict = {"dit": convert.dit_state_dict,
                         "vae": convert.vae_state_dict,
                         "cls": convert.classifier_state_dict}[kind]
        sd = to_state_dict(flat)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        # the reference's checkpoints also hold what the port does not
        # build (encoder, loss, rotary buffers); every port key must be there
        names = set(module.state_dict())
        sd = {k: v for k, v in obj.get("state_dict", obj).items() if k in names}
    module.load_state_dict(sd, strict=True)


def create_denoiser(name: str = "DiTRotary_XL_8", *, input_size=(128, 16),
                    in_channels: int = 4, num_classes: int = NUM_CLASSES,
                    learn_sigma: bool = False, model_path: str = "",
                    dtype=torch.bfloat16, device="cuda") -> DiTRotary:
    device = resolve_device(device)
    with torch.device(device):
        model = DiT_models[name](input_size=tuple(input_size),
                                 in_channels=in_channels,
                                 num_classes=num_classes,
                                 learn_sigma=learn_sigma)
    if model_path:
        load_weights(model, model_path, "dit")
    else:
        _warn("no model_path given: random denoiser weights")
    return model.to(dtype).eval()


def create_vae(vae_path: str = "", *, arch: Optional[Dict] = None,
               dtype=torch.bfloat16, device="cuda") -> AutoencoderKL:
    """The decode half of the KL-VAE; ``arch`` overrides the production f8
    geometry (ch, ch_mult, num_res_blocks), as ``--vae_arch`` does."""
    device = resolve_device(device)
    with torch.device(device):
        vae = AutoencoderKL(**dict(arch or {}))
    if vae_path:
        load_weights(vae, vae_path, "vae")
    else:
        _warn("no vae_path given: random VAE weights")
    return vae.to(dtype).eval()


@torch.no_grad()
def randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights with no zero-initialised layer: every weight
    ~ N(0, 1 / fan_in), biases ~ N(0, 0.02^2), norm scales ~ 1 + N(0,
    0.1^2). Keeps activations O(1) through depth, and makes every adaLN-Zero
    block a real function instead of the identity."""
    param = next(module.parameters())
    gen = torch.Generator(device=param.device).manual_seed(seed)
    for name, p in module.named_parameters():
        noise = torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=torch.float32)
        if p.dim() >= 2:
            fan_in = p[0].numel()
            if name.endswith("embedding_table.weight"):
                fan_in = 1
            p.copy_(noise / fan_in ** 0.5)
        elif "norm" in name and name.endswith("weight"):
            p.copy_(1.0 + 0.1 * noise)
        else:
            p.copy_(0.02 * noise)
    return module


def build_classifier_bundles(classifier_config, *, input_size=(128, 16),
                             in_channels: int = 4, dtype=torch.bfloat16,
                             device="cuda") -> List[DiTRotaryClassifier]:
    """The YAML's classifiers (``names``, ``num_classes``, ``paths``) as
    modules in ``dtype`` on ``device``, in eval mode with no parameter
    wanting a gradient. A path with no file keeps seeded random weights
    (seed 100 + i, as the JAX package's init keys) with a warning."""
    device = resolve_device(device)
    bundles = []
    for i, name in enumerate(classifier_config.names):
        with torch.device(device):
            model = DiT_models[name](input_size=tuple(input_size),
                                     in_channels=in_channels,
                                     num_classes=classifier_config.num_classes[i])
        path = classifier_config.paths[i]
        if path and os.path.exists(path):
            load_weights(model, path, "cls")
            print(f"loaded classifier {name} from {path}")
        else:
            _warn(f"classifier {name}: no weights at '{path}': seeded random "
                  f"weights")
            randomize_(model, seed=100 + i)
        bundles.append(model.to(dtype).eval().requires_grad_(False))
    return bundles


@dataclass
class ClassifierSpecMeta:
    """One cond_fn term: the YAML's function name, rule and scale, and its
    classifier (None for the rule-based functions)."""

    fn: str
    rule_name: str
    scale: float
    model: Any = None


def resolve_given_targets(target_rules: Mapping, batch_size: int,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """YAML-given targets: merge vertical/horizontal nd, rescale
    pitch_hist, broadcast to the batch (sample_rule.py:170-193)."""
    target_rules = dict(target_rules)
    for key in list(target_rules.keys()):
        if "vertical_nd" in key:
            if "_hr_" in key:
                hr_scale = int(key.split("_hr_")[-1])
                hr_key = key.replace("vertical", "horizontal")
                nd_name = f"note_density_hr_{hr_scale}"
            else:
                hr_scale = 5
                hr_key = "horizontal_nd"
                nd_name = "note_density"
            horizontal = [x / hr_scale for x in target_rules[hr_key]]
            target_rules[nd_name] = list(target_rules[key]) + horizontal
            target_rules.pop(key)
            target_rules.pop(hr_key)
            break
    out = {}
    for key, val in target_rules.items():
        dtype = torch.int32 if "chord" in key else torch.float32
        arr = torch.as_tensor(val, dtype=dtype, device=device)
        if key == "pitch_hist":
            arr = arr / (arr.sum() + 1e-12)
        out[key] = arr[None].repeat(batch_size, 1)
    return out


def extract_targets_from_rolls(rule_names: Iterable[str],
                               rolls: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Targets measured on example rolls (sample_rule.py:147-168)."""
    return {name: FUNC_DICT[name](rolls) for name in rule_names}


def generate(denoiser: DiTRotary, vae: Optional[AutoencoderKL], tables: Tables,
             config: SamplerConfig, shape: Sequence[int],
             rules: Mapping[str, torch.Tensor], *,
             y: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise_fn: Optional[NoiseFn] = None,
             classifier_metas: Sequence[ClassifierSpecMeta] = (),
             num_classes: int = NUM_CLASSES, class_cond: bool = True,
             use_decode: bool = True,
             scale_factor: float = DEFAULT_SCALE_FACTOR):
    """Run the guided reverse chain (``make_sample_fn``'s SCG and classifier
    guidance path); returns (latents (B, 4, 128, 16) float32, records).

    Unconditional calls use the null class id ``num_classes``
    (``make_model_fn``). ``classifier_metas`` make the grad-type cond_fn of
    classifier guidance. Noise comes from ``generator`` unless ``noise_fn``
    is given (see ``diffusion.sampling``).

    The chain runs under ``torch.no_grad()``, not ``inference_mode``: the
    cond_fn differentiates the classifiers with respect to x_t, and
    inference tensors cannot enter autograd.
    """
    device = tables.betas.device
    if noise_fn is None:
        noise_fn = torch_noise_fn(generator, device)
    model_fn = make_model_fn(denoiser, num_classes, class_cond)
    cond_fn = None
    if classifier_metas:
        cond_fn = make_grad_cond_fn([
            CondFnSpec(fn=m.fn, rule_name=m.rule_name, scale=m.scale,
                       classifier=m.model) for m in classifier_metas])
    decode_fn = None
    if vae is not None and use_decode:
        decode_fn = make_decode_fn(vae.decode, scale_factor=scale_factor)
    with torch.no_grad():
        return sample_loop(model_fn, tuple(shape), tables, config,
                           noise_fn=noise_fn, y=y, rules=rules,
                           cond_fn=cond_fn, decode_fn=decode_fn)


def decode_rolls(vae: AutoencoderKL, latents: torch.Tensor,
                 scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    """Latent images -> (B, 3, 128, 8*128) normalized piano rolls."""
    with torch.inference_mode():
        return make_decode_fn(vae.decode, scale_factor=scale_factor)(latents)
