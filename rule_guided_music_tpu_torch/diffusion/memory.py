"""Memory preflight for the SCG sampling working set.

Port of ``rule_guided_music_tpu/diffusion/memory.py``: an analytic
estimate of one guided step's peak device memory, by term, checked against
the card's memory before the chain starts, so that a configuration too
large for the card fails as a configuration error instead of running out of
memory mid-chain. The terms (dominant in the reference's cost anatomy,
gaussian_diffusion.py:509-533):

  * resident params (fp32 master) + their bf16 compute copies,
  * the k-candidate latent tensors (candidates/flat/selected copies),
  * per-group denoiser forward live set,
  * per-group VAE decoder activations at the widest (full-resolution)
    stage, ``ACT_BUFFERS`` live feature maps of 128*128*ch per chunk,
  * the decoded rolls of all groups.

The formula and its constants (``CALIBRATION``, ``ACT_BUFFERS``) are the
JAX package's, which fitted them to XLA on a TPU; they are kept as they are
here, and ``chip_smoke.py`` prints the estimate beside
``torch.cuda.max_memory_allocated()`` on the card. The limit is the card's
total memory (``torch.cuda.mem_get_info``), None on the CPU;
``RGM_HBM_BYTES`` overrides it and ``RGM_SKIP_HBM_PREFLIGHT=1`` skips the
check.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

# Multiplier on the activation terms for temporaries, layout padding and
# allocator fragmentation (the JAX package's value, fitted there).
CALIBRATION = 2.0

# Live full-resolution feature maps per decoded chunk at the widest decoder
# stage (norm input, conv input pipeline, conv output, residual skip).
ACT_BUFFERS = 6


def dit_param_count(hidden: int, depth: int, patch: int = 8,
                    in_channels: int = 4) -> int:
    """DiTRotary parameter count (dit.py:538-634 trunk): per block
    qkv 3h^2 + proj h^2 + mlp 8h^2 + adaLN 6h^2 = 18h^2."""
    block = 18 * hidden * hidden
    embed = (in_channels * patch * 256 + 256 * hidden      # x_embedder
             + 256 * hidden + hidden * hidden)             # t_embedder
    final = 2 * hidden * hidden + hidden * patch * in_channels
    return depth * block + embed + final


def vae_param_count(ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 2, 4),
                    num_res_blocks: int = 2) -> int:
    """KL-VAE f8 parameter scaling: ~55M at ch=128 (SURVEY §2.2), conv
    params scale with ch^2."""
    return int(55e6 * (ch / 128) ** 2)


def estimate_scg_peak_bytes(
    *,
    gen_shape: Tuple[int, ...],
    k: int,
    decode_chunks: int,
    param_count: int,
    hidden: int,
    decoder_ch: int = 128,
    compute_bytes: int = 2,
    use_decode: bool = True,
) -> Dict[str, float]:
    """Estimated peak HBM bytes for one SCG guided step, by term.

    Returns a dict of term -> bytes plus "total".  ``gen_shape`` is the
    latent generation shape (B, C, latent_time, latent_pitch);
    ``param_count`` the total resident parameter count (denoiser + VAE +
    classifiers [+ scoring decoder]); ``decoder_ch`` the scoring decoder's
    base channel count (128 full / 64 light).
    """
    b, c, latent_t, latent_p = gen_shape
    latent_elems = c * latent_t * latent_p
    kb = k * b
    groups = max(int(decode_chunks), 1)
    if kb % groups != 0:
        groups = 1                       # sampling.py falls back to unchunked
    g = kb // groups
    chunks_per_excerpt = max(latent_t // 16, 1)
    roll_len = latent_t * 8

    terms: Dict[str, float] = {}
    # fp32 master params + bf16 compute copies
    terms["params"] = param_count * (4 + compute_bytes)
    # candidates + flat + selected latent copies (fp32 carries)
    terms["candidates"] = 3 * kb * latent_elems * 4
    # denoiser forward live set per group: qkv/mlp/attn buffers over
    # 256-token sequences (~16 live hidden-width maps)
    tokens = latent_t * latent_p // 8
    terms["denoiser_group"] = CALIBRATION * (
        g * tokens * hidden * 16 * compute_bytes
    )
    if use_decode:
        # widest decoder stage: full-res (128 x roll-chunk 128) feature
        # maps with `decoder_ch` channels, ACT_BUFFERS live per chunk
        per_chunk = ACT_BUFFERS * 128 * 128 * decoder_ch * compute_bytes
        terms["decode_group"] = CALIBRATION * (
            g * chunks_per_excerpt * per_chunk
        )
        # decoded rolls of all groups (2 copies: the concatenated output
        # and the rule programs' input)
        terms["stacked_rolls"] = CALIBRATION * (
            2 * kb * 3 * 128 * roll_len * compute_bytes
        )
    terms["total"] = float(sum(terms.values()))
    return terms


def device_memory_limit_bytes(device=None) -> Optional[int]:
    """The card's memory limit: ``RGM_HBM_BYTES`` when set (the escape
    hatch and test hook), else the total that ``torch.cuda.mem_get_info``
    reports for a CUDA ``device``; None on the CPU, where the preflight is
    skipped."""
    env = os.environ.get("RGM_HBM_BYTES")
    if env:
        return int(float(env))
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return None


class HBMPreflightError(ValueError):
    """SCG config estimated to exceed device memory (raised pre-compile)."""


def preflight_scg(
    *,
    gen_shape: Tuple[int, ...],
    k: int,
    decode_chunks: int,
    param_count: int,
    hidden: int,
    decoder_ch: int = 128,
    compute_bytes: int = 2,
    use_decode: bool = True,
    limit_bytes: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """Raise HBMPreflightError if the estimated SCG working set exceeds the
    device memory limit; returns the term breakdown otherwise.

    Skipped (returns estimate uncheck-ed) when no limit is discoverable or
    RGM_SKIP_HBM_PREFLIGHT=1.
    """
    terms = estimate_scg_peak_bytes(
        gen_shape=gen_shape, k=k, decode_chunks=decode_chunks,
        param_count=param_count, hidden=hidden, decoder_ch=decoder_ch,
        compute_bytes=compute_bytes, use_decode=use_decode,
    )
    if os.environ.get("RGM_SKIP_HBM_PREFLIGHT") == "1":
        return terms
    limit = limit_bytes if limit_bytes is not None \
        else device_memory_limit_bytes(device)
    if limit is None:
        return terms
    if terms["total"] > limit:
        b = gen_shape[0]
        kb = k * b
        breakdown = ", ".join(
            f"{name}={val/1e9:.2f}GB" for name, val in terms.items()
            if name != "total"
        )
        raise HBMPreflightError(
            f"SCG config estimated at {terms['total']/1e9:.2f} GB peak HBM "
            f"(limit {limit/1e9:.2f} GB): k={k} x batch={b} = {kb} "
            f"candidates, decode_chunks={decode_chunks}, "
            f"decoder_ch={decoder_ch}. Breakdown: {breakdown}. "
            f"Reduce batch size, raise scg.decode_chunks (serializes the "
            f"candidate decode), or use the light scoring decoder "
            f"(--scoring_decoder_path). Set "
            f"RGM_SKIP_HBM_PREFLIGHT=1 to override."
        )
    return terms
