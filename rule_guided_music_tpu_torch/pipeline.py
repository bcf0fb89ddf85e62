"""High-level assembly: models, sampler and targets for guided generation.

Port of the SCG, classifier-guidance and serving path of
``rule_guided_music_tpu/pipeline.py``: ``DenoiserBundle``/``VAEBundle``
become :func:`create_denoiser` (with the int8 trunk of ``quant``) /
:func:`create_vae` (modules in bf16 on one device, random weights with a
warning when no path is given, as ``pipeline.py:100-105`` does),
:func:`create_unet` builds the pixel-space UNet,
``build_classifier_bundles`` returns the classifiers as modules, :class:`ScoringBundle` holds the light scoring
models (decoder, rule-feature head, rollout denoiser), and
``make_sample_fn`` becomes :func:`generate`, which runs the memory
preflight and then the chain, eagerly; :func:`encode_rolls` and
:func:`decode_rolls` cross between rolls and latents.
Every entry point takes ``device="cuda"`` by default and raises when there
is no card; the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from . import convert
from .config import SamplerConfig
from .constants import DEFAULT_SCALE_FACTOR, NUM_CLASSES
from .diffusion import memory
from .diffusion.collage import make_cond_ind_eps_fn
from .diffusion.guidance import (CondFnSpec, make_grad_cond_fn, make_model_fn,
                                 make_value_cond_fn)
from .diffusion.latent import make_decode_fn, make_encode_fn
from .diffusion.sampling import NoiseFn, sample_loop, torch_noise_fn
from .diffusion.schedule import Tables
from .models.dit import DiT_models, DiTRotary, DiTRotaryClassifier
from .models.scoring_head import RuleFeatureHead
from .models.unet import UNetModel
from .models.vae import AutoencoderKL, ScoringDecoder
from .ops.quant import normalize_quant_mode, quantize_
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
    """Load ``path`` into ``module`` (``kind``: "dit", "vae", "cls" or
    "unet"): an
    ``.npz`` of the JAX package's flat parameters (a checkpoint, or a test
    fixture holding ``dit/`` and ``vae/`` parts), converted by
    ``convert.py``; or a torch state_dict file with the reference's names
    (``.pt``/``.pth``/``.ckpt``)."""
    if path.endswith(".npz"):
        flat = dict(np.load(path))
        if any(k.startswith(f"{kind}/") for k in flat):   # a test fixture
            flat = load_fixture_npz(path)[kind]
        if kind == "vae":
            sd = convert.vae_state_dict(
                flat, encoder=getattr(module, "encoder", None) is not None)
        else:
            sd = {"dit": convert.dit_state_dict,
                  "cls": convert.classifier_state_dict,
                  "unet": convert.unet_state_dict}[kind](flat)
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
                    dtype=torch.bfloat16, device="cuda", quant="") -> DiTRotary:
    """A registry denoiser (DiTRotary or the 2-D DiT) in ``dtype`` on
    ``device``. ``quant`` ("w8a8" or "w8a16"; '' or False for off, see
    ``normalize_quant_mode``) folds the trunk's fp32 weights to int8
    before the cast to ``dtype``, as the JAX package quantizes its host's
    fp32 tree (pipeline.py:105-111)."""
    device = resolve_device(device)
    with torch.device(device):
        model = DiT_models[name](input_size=tuple(input_size),
                                 in_channels=in_channels,
                                 num_classes=num_classes,
                                 learn_sigma=learn_sigma)
    if model_path:
        load_weights(model, model_path, "dit")
        print(f"loaded denoiser weights from {model_path}")
    else:
        _warn("no model_path given: random denoiser weights")
    mode = normalize_quant_mode(quant)
    if mode:
        quantize_(model, mode)
        print(f"denoiser trunk quantized to int8 ({mode} serving)")
    return model.to(dtype).eval().requires_grad_(False)


def create_unet(model_path: str = "", *, dtype=torch.bfloat16, device="cuda",
                **arch) -> UNetModel:
    """The pixel-space ADM UNet (``arch``: ``UNetModel``'s arguments) in
    ``dtype`` on ``device``; random weights with a warning when no path is
    given."""
    device = resolve_device(device)
    with torch.device(device):
        model = UNetModel(**arch)
    if model_path:
        load_weights(model, model_path, "unet")
        print(f"loaded UNet weights from {model_path}")
    else:
        _warn("no model_path given: random UNet weights")
    return model.to(dtype).eval().requires_grad_(False)


def create_vae(vae_path: str = "", *, arch: Optional[Dict] = None,
               encoder: bool = False, dtype=torch.bfloat16,
               device="cuda") -> AutoencoderKL:
    """The KL-VAE's decode half, and its encoder where ``encoder`` asks for
    it (excerpt editing); ``arch`` overrides the production f8 geometry
    (ch, ch_mult, num_res_blocks), as ``--vae_arch`` does."""
    device = resolve_device(device)
    with torch.device(device):
        vae = AutoencoderKL(**dict(arch or {}), encoder=encoder)
    if vae_path:
        load_weights(vae, vae_path, "vae")
    else:
        _warn("no vae_path given: random VAE weights")
    return vae.to(dtype).eval().requires_grad_(False)


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


def _load_scoring_npz(path: str, part: str = ""):
    """A distill script's npz -> (flat ``'/'``-keyed tree, metadata such as
    ``agreement``), as ``rule_guided_music_tpu/pipeline.py::
    _load_scoring_npz`` reads it. A test fixture that holds several models
    under prefixes (``decoder/``, ``feathead/``, ``rollout/``) gives the
    one under ``part``."""
    data = dict(np.load(path))
    if part and any(k.startswith(f"{part}/") for k in data):
        data = {k[len(part) + 1:]: v for k, v in data.items()
                if k.startswith(f"{part}/")}
    meta = {k: float(v) for k, v in data.items() if "/" not in k}
    flat = {k: np.asarray(v, dtype=np.float32) for k, v in data.items()
            if "/" in k}
    return flat, meta


@dataclass
class ScoringBundle:
    """The light scoring models, which only rank SCG candidates: the
    trajectory and the final decode always use the full models
    (``rule_guided_music_tpu/pipeline.py::ScoringBundle``). Each is None
    where it is not used; ``agreements`` holds each file's distill
    agreement."""

    decoder: Optional[ScoringDecoder] = None
    feature_head: Optional[RuleFeatureHead] = None
    rollout: Optional[DiTRotary] = None
    agreements: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def create(cls, *, decoder_path: str = "", features_path: str = "",
               rollout: str = "", rollout_path: str = "",
               input_size=(128, 16), in_channels: int = 4,
               num_classes: int = NUM_CLASSES, learn_sigma: bool = False,
               dtype=torch.bfloat16, device="cuda") -> "ScoringBundle":
        """Load what the paths name. The decoder's and the head's
        geometry is read from their trees (``convert.scoring_decoder_arch``,
        ``convert.feature_head_arch``), so the ch=64 assets and the test
        fixtures load alike. A rollout named without weights raises, as in
        the JAX package."""
        device = resolve_device(device)
        out = cls()
        if decoder_path:
            flat, meta = _load_scoring_npz(decoder_path, "decoder")
            with torch.device(device):
                out.decoder = ScoringDecoder(**convert.scoring_decoder_arch(flat))
            out.decoder.load_state_dict(convert.vae_state_dict(flat))
            out.decoder.to(dtype).eval().requires_grad_(False)
            out.agreements["scoring_decoder"] = meta.get("agreement", float("nan"))
            print(f"light scoring decoder (ch={out.decoder.ch}) from "
                  f"{decoder_path} (distill agreement="
                  f"{out.agreements['scoring_decoder']:.3f})")
        if features_path:
            flat, meta = _load_scoring_npz(features_path, "feathead")
            with torch.device(device):
                out.feature_head = RuleFeatureHead(**convert.feature_head_arch(flat))
            out.feature_head.load_state_dict(convert.feature_head_state_dict(flat))
            out.feature_head.to(dtype).eval().requires_grad_(False)
            out.agreements["scoring_features"] = meta.get("agreement",
                                                          float("nan"))
            print(f"rule-feature head (ch={out.feature_head.ch}) from "
                  f"{features_path} (distill agreement="
                  f"{out.agreements['scoring_features']:.3f})")
        if rollout:
            if not rollout_path:
                raise ValueError(
                    "scoring rollout model given without weights: pass "
                    "rollout_path (scripts/distill_scoring_rollout.py output)")
            flat, meta = _load_scoring_npz(rollout_path, "rollout")
            with torch.device(device):
                out.rollout = DiT_models[rollout](
                    input_size=tuple(input_size), in_channels=in_channels,
                    num_classes=num_classes, learn_sigma=learn_sigma)
            out.rollout.load_state_dict(convert.dit_state_dict(flat))
            out.rollout.to(dtype).eval().requires_grad_(False)
            out.agreements["scoring_rollout"] = meta.get("agreement",
                                                         float("nan"))
            print(f"light rollout denoiser {rollout} from {rollout_path} "
                  f"(distill agreement={out.agreements['scoring_rollout']:.3f})")
        return out


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


def _dit_params(model) -> int:
    return memory.dit_param_count(model.hidden_size, len(model.blocks),
                                  patch=getattr(model, "patch_size", 8))


def preflight(denoiser: DiTRotary, vae: Optional[AutoencoderKL],
              config: SamplerConfig, shape: Sequence[int], *,
              scoring: Optional[ScoringBundle] = None,
              classifier_metas: Sequence[ClassifierSpecMeta] = (),
              use_decode: bool = True, device=None) -> Optional[Dict[str, float]]:
    """The memory preflight of an SCG chain (``make_sample_fn``,
    pipeline.py:403-454 of the JAX package): the estimated peak bytes by
    term, counting the trajectory model, the decoder, the classifiers and
    the scoring models; raises ``memory.HBMPreflightError`` when the
    estimate exceeds the card's memory. None when the chain has no SCG
    decode to estimate."""
    scg = config.scg
    scoring = scoring or ScoringBundle()
    if scg is None or not use_decode or (vae is None and scoring.decoder is None):
        return None
    param_count = _dit_params(denoiser)
    for meta in classifier_metas:
        if meta.model is not None:
            param_count += _dit_params(meta.model)
    decoder_ch = 128
    if vae is not None:
        decoder_ch = vae.ch
        param_count += memory.vae_param_count(vae.ch)
    if scoring.decoder is not None:
        decoder_ch = scoring.decoder.ch
        # decoder-only module: roughly half an AutoencoderKL
        param_count += memory.vae_param_count(scoring.decoder.ch) // 2
    # with a feature head the candidate decode leaves the step, unless the
    # prefilter decodes the top m, counted (conservatively) as a k decode
    scg_uses_decode = scoring.feature_head is None or scg.prefilter > 0
    rollout_hidden = denoiser.hidden_size
    if scoring.rollout is not None:
        rollout_hidden = scoring.rollout.hidden_size
        param_count += _dit_params(scoring.rollout)
    dtype = denoiser.final_layer.linear.weight.dtype
    return memory.preflight_scg(
        gen_shape=tuple(shape), k=scg.num_samples,
        decode_chunks=scg.decode_chunks, param_count=param_count,
        hidden=rollout_hidden, decoder_ch=decoder_ch,
        compute_bytes=2 if dtype == torch.bfloat16 else 4,
        use_decode=scg_uses_decode, device=device)


def generate(denoiser: DiTRotary, vae: Optional[AutoencoderKL], tables: Tables,
             config: SamplerConfig, shape: Sequence[int],
             rules: Mapping[str, torch.Tensor], *,
             y: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise_fn: Optional[NoiseFn] = None,
             classifier_metas: Sequence[ClassifierSpecMeta] = (),
             scoring: Optional[ScoringBundle] = None,
             num_classes: int = NUM_CLASSES, class_cond: bool = True,
             use_decode: bool = True,
             scale_factor: float = DEFAULT_SCALE_FACTOR,
             edit_gt: Optional[torch.Tensor] = None,
             edit_mask: Optional[torch.Tensor] = None,
             collage: Optional[Mapping[str, Any]] = None,
             cfg: bool = False, w: float = 0.0):
    """Run the guided reverse chain (``make_sample_fn``'s path); returns
    (latents ``shape`` float32, records).

    Unconditional calls use the null class id ``num_classes``
    (``make_model_fn``). ``classifier_metas`` make the grad-type cond_fn of
    classifier guidance, or the value-type cond_fn of DPS where
    ``config.guidance.method`` is "dps" (pipeline.py:539-543 of the JAX
    package). ``edit_gt`` (latents, from :func:`encode_rolls`) and
    ``edit_mask`` (1 where gt is kept) drive an edit chain
    (``config.edit``). ``scoring`` holds the light scoring models, which
    only rank SCG candidates: the feature head gets x0 / scale_factor, the
    light decoder replaces the full one in the candidate decode, and the
    rollout denoiser gets the trajectory model's class conditioning. Noise
    comes from ``generator`` unless ``noise_fn`` is given (see
    ``diffusion.sampling``). The memory preflight runs first.

    ``cfg`` makes the denoiser classifier-free guided with weight ``w``,
    and ``collage`` (``dict(num_img, overlap, circle)``, from
    ``config.collage_from_config``) stitches it over the windows of a long
    latent ``shape`` (DiffCollage), in that order, as the JAX package's
    ``wrap_model`` does (pipeline.py:458-489): each window call then runs
    both CFG halves. The trajectory and rollout denoisers are wrapped
    alike.

    The chain runs under ``torch.no_grad()``, not ``inference_mode``: the
    cond_fns differentiate the classifiers (and DPS the denoiser and the
    decoder) with respect to x_t, and inference tensors cannot enter
    autograd.
    """
    device = tables.betas.device
    scoring = scoring or ScoringBundle()
    preflight(denoiser, vae, config, shape, scoring=scoring,
              classifier_metas=classifier_metas, use_decode=use_decode,
              device=device)
    if noise_fn is None:
        noise_fn = torch_noise_fn(generator, device)

    def wrap_model(model):
        fn = make_model_fn(model, num_classes, class_cond, cfg=cfg, w=w)
        if collage:
            fn = make_cond_ind_eps_fn(fn, collage["num_img"], collage["overlap"],
                                      circle=collage.get("circle", False))
        return fn

    model_fn = wrap_model(denoiser)
    cond_fn = None
    if classifier_metas:
        dps = config.guidance is not None and config.guidance.method == "dps"
        cond_fn = (make_value_cond_fn if dps else make_grad_cond_fn)([
            CondFnSpec(fn=m.fn, rule_name=m.rule_name, scale=m.scale,
                       classifier=m.model) for m in classifier_metas])
    decode_fn = None
    if use_decode:
        scoring_vae = scoring.decoder if scoring.decoder is not None else vae
        if scoring_vae is not None:
            decode_fn = make_decode_fn(scoring_vae.decode,
                                       scale_factor=scale_factor)
    scoring_model_fn = None
    if scoring.rollout is not None:
        scoring_model_fn = wrap_model(scoring.rollout)
    scoring_feature_fn = None
    if scoring.feature_head is not None:
        head = scoring.feature_head
        scoring_feature_fn = lambda z: head.features(z / scale_factor)
    with torch.no_grad():
        return sample_loop(model_fn, tuple(shape), tables, config,
                           noise_fn=noise_fn, y=y, rules=rules,
                           cond_fn=cond_fn, decode_fn=decode_fn,
                           scoring_model_fn=scoring_model_fn,
                           scoring_feature_fn=scoring_feature_fn,
                           edit_gt=edit_gt, edit_mask=edit_mask)


def encode_rolls(vae: AutoencoderKL, rolls: torch.Tensor,
                 scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    """(B, 3, 128, 8*128) normalized piano rolls -> (B, 4, 128, 16) float32
    latents, by the posterior mode; ``vae`` needs its encoder. Runs under
    ``torch.no_grad()``, not ``inference_mode``: the latents enter an edit
    chain, whose DPS step re-enters autograd, and inference tensors
    cannot."""
    with torch.no_grad():
        return make_encode_fn(vae.encode_moments, scale_factor=scale_factor)(rolls)


def decode_rolls(vae: AutoencoderKL, latents: torch.Tensor,
                 scale_factor: float = DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    """Latent images -> (B, 3, 128, 8*128) normalized piano rolls."""
    with torch.inference_mode():
        return make_decode_fn(vae.decode, scale_factor=scale_factor)(latents)
