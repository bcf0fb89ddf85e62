"""Training-throughput probe: the pieces of the reference training recipe,
timed on the card.

    python -m rule_guided_music_tpu_torch.train_probe [--device cuda]
    TRAIN_PROBE_TINY=1 python -m rule_guided_music_tpu_torch.train_probe --device cpu

Counterpart of ``scripts/train_probe.py`` (reference train_util.py:319-400,
README.md:92-124: 8 GPUs x batch 32, 1.2 M steps), one process:

  1. the on-the-fly VAE encode and shifted-window recombination
     (``get_kl_input``: 20 chunks of 1.28 s -> encode_rep 4 overlapping
     10.24 s latent excerpts), on the production KL-VAE encoder in bf16;
  2. the train step (forward, backward, optimizer, EMA, NaN guard) of the
     XL_8 trunk at 32 latents, bf16 compute over fp32 parameters, for
     adafactor + remat, adamw + remat, adafactor and adamw: ms a step,
     examples/s, TFLOP/s counted as 6 * params * 256 tokens * batch, and
     the peak of ``torch.cuda.max_memory_allocated``;
  3. the derived end-to-end step (encode + the fastest train step),
     examples/s and the days of the reference's 1.2 M-step run at it.

``TRAIN_PROBE_TINY=1`` selects the XS_8 trunk and a small VAE with a
loader batch of 2 (plumbing, CPU-testable). Weights are random, from
seeds. A configuration that fails (out of memory) is reported and the
others go on; ``main`` returns the results and the process exits 1 where
any failed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import pipeline
from .diffusion.schedule import make_schedule
from .models.dit import DiT_models, init_weights_
from .models.vae import AutoencoderKL
from .training.train_loop import (TrainConfig, TrainState, get_kl_input, init_ema,
                                  make_optimizer, make_train_step)

_T0 = time.perf_counter()
CONFIGS = (("adafactor", True), ("adamw", True), ("adafactor", False),
           ("adamw", False))


def log(msg: str) -> None:
    print(f"[train_probe {time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gib(device):
    """The peak of allocated device memory since the last reset, GiB (None
    off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def geometry(tiny: bool) -> dict:
    if tiny:
        return dict(model="DiTRotary_XS_8", vae=dict(ch=16, ch_mult=(1, 1, 2, 2),
                                                     num_res_blocks=1),
                    loader_b=2, seq_len=20, reps=1)
    return dict(model="DiTRotary_XL_8", vae=dict(ch=128, ch_mult=(1, 2, 2, 4),
                                                 num_res_blocks=2),
                loader_b=8, seq_len=20, reps=3)


def probe_encode(geo: dict, device) -> dict:
    """Stage 1: the host-to-device copy of a loader batch and
    ``get_kl_input`` on the bf16 encoder."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    with torch.device(device):
        vae = AutoencoderKL(**geo["vae"], encoder=True)
    pipeline.randomize_(vae, 0)
    vae = vae.to(torch.bfloat16).eval()
    host = torch.randn((geo["loader_b"], 3, 128, 128 * geo["seq_len"]), generator=gen)
    t0 = time.perf_counter()
    batch = host.to(device)
    _sync(device)
    transfer_ms = 1e3 * (time.perf_counter() - t0)
    mb = host.numel() * 4 / 1e6
    log(f"host->device batch transfer ({mb:.0f} MB): {transfer_ms:.1f} ms")
    _reset_peak(device)
    encode = lambda: get_kl_input(vae.encode_moments, batch, scale_factor=1.2465,
                                  shift_size=4)
    latents = encode()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(geo["reps"]):
        latents = encode()
    _sync(device)
    enc_ms = 1e3 * (time.perf_counter() - t0) / geo["reps"]
    log(f"get_kl_input: {enc_ms:.1f} ms -> {tuple(latents.shape)} latents")
    return dict(transfer_ms=transfer_ms, encode_ms=enc_ms,
                latents=list(latents.shape), peak_gib=_peak_gib(device))


def probe_step(geo: dict, opt_name: str, remat: bool, train_b: int, device) -> dict:
    """Stage 2: one train-step configuration; returns its numbers."""
    label = f"{opt_name}{'+remat' if remat else ''}"
    log(f"stage: train step [{label}]")
    _reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(2)
    with torch.device(device):
        model = DiT_models[geo["model"]](num_classes=3, class_dropout_prob=0.1,
                                         remat=remat)
    init_weights_(model, gen).train()
    n_params = sum(p.numel() for p in model.parameters())
    config = TrainConfig(lr=1e-4, optimizer=opt_name, scale_factor=1.2465)
    state = TrainState(model=model, ema_params=init_ema(model),
                       optimizer=make_optimizer(config, list(model.parameters())))
    tables = make_schedule("linear", 1000).tables(device)
    step = make_train_step(model, tables, config, torch.bfloat16)
    lat = torch.randn((train_b, 4, 128, 16), generator=gen, device=device) / 1.2465
    t = torch.arange(train_b, device=device) * (1000 // train_b)
    w = torch.ones(train_b, device=device)
    y = torch.zeros(train_b, dtype=torch.long, device=device)

    def draws():
        return (torch.randn(lat.shape, generator=gen, device=device),
                torch.rand((train_b,), generator=gen, device=device) < 0.1)

    t0 = time.perf_counter()
    metrics = step(state, lat, t, w, y, *draws())
    first_s = time.perf_counter() - t0
    log(f"[{label}] first step: {first_s:.1f}s (loss={float(metrics['loss']):.3f}, "
        f"params={n_params / 1e6:.0f}M)")
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(geo["reps"]):
        metrics = step(state, lat, t, w, y, *draws())
    float(metrics["loss"])
    _sync(device)
    step_s = (time.perf_counter() - t0) / geo["reps"]
    flops = 6 * n_params * 256 * train_b
    out = dict(config=label, ms=1e3 * step_s, examples_per_s=train_b / step_s,
               tflops=flops / step_s / 1e12, peak_gib=_peak_gib(device),
               params=n_params, loss=float(metrics["loss"]))
    peak = "not measured" if out["peak_gib"] is None else f"{out['peak_gib']:.2f} GiB"
    log(f"[{label}] step: {out['ms']:.1f} ms -> {out['examples_per_s']:.1f} "
        f"examples/s ({out['tflops']:.1f} TFLOP/s incl. bwd), peak {peak}")
    del state, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = pipeline.resolve_device(args.device)
    geo = geometry(os.environ.get("TRAIN_PROBE_TINY") == "1")
    # recombination geometry: 20 chunks, windows of 8 at a shift of 4
    encode_rep = (geo["seq_len"] - 8) // 4 + 1
    train_b = geo["loader_b"] * encode_rep
    log(f"model={geo['model']} loader_batch={geo['loader_b']} -> "
        f"train_batch={train_b} (encode_rep={encode_rep})")
    log("stage: get_kl_input (VAE encode + shifted-window recombination)")
    results = dict(device=str(device), model=geo["model"], train_batch=train_b,
                   encode=probe_encode(geo, device), steps=[], failed=[])
    for opt_name, remat in CONFIGS:
        try:
            results["steps"].append(probe_step(geo, opt_name, remat, train_b, device))
        except torch.OutOfMemoryError as e:
            log(f"[{opt_name}{'+remat' if remat else ''}] FAILED: {e!r}")
            results["failed"].append(f"{opt_name}{'+remat' if remat else ''}")
    if results["steps"]:
        best = min(s["ms"] for s in results["steps"])
        total_ms = best + results["encode"]["encode_ms"]
        days = 1.2e6 * total_ms / 1e3 / 86400.0
        results["end_to_end"] = dict(step_ms=total_ms,
                                     examples_per_s=train_b / total_ms * 1e3,
                                     days_1p2m_steps=days)
        log(f"end-to-end step (encode + train): {total_ms:.1f} ms -> "
            f"{train_b / total_ms * 1e3:.1f} examples/s")
        log(f"reference recipe (1.2M steps at this step): ~{days:.1f} days")
    log("done")
    print("TRAIN_PROBE " + json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    raise SystemExit(1 if main()["failed"] else 0)
