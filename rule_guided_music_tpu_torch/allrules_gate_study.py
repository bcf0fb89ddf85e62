"""The light-scoring gate at the production operating point: all three
rules (pitch_hist 40 / note_density 1 / chord_progression 1, the weights
of scg_classifier_all.yml) at k=16.

    python -m rule_guided_music_tpu_torch.allrules_gate_study [--variants a,b] [--merge] [--skip_regret] [--device cuda]

Counterpart of ``scripts/allrules_gate_study.py``, with its flags plus
``--device``. On the committed fixtures (``quality_tiny``: the learned
ch=32 VAE and a tiny DiTRotary_XS_8; ``light_gate_tiny``: the ch=16
scoring decoder, the rollout student and the rule-feature head) it runs
the SCG chain (16 steps, k=16, B=4) of each of the 11 variants
(:data:`ALL_VARIANTS`, each one's parts by :func:`variant_parts`) for
seeds 0-3 and records the final per-rule losses scored through the full
decoder; then the per-rule candidate regret of the light decoder and of
the head against the full decoder's ranking at 5 guided timesteps,
normalised by the full ranker's spread. The targets are the sparsest
reconstruction of ``make_rolls(8, seed=21)``.

The JSON has the JAX study's schema. It goes to :data:`OUT_PATH`, under
the git-ignored ``loggings/``: the JAX study's own record,
``docs/allrules_gate_study.json``, is never written here. The port draws
its noise from ``torch.Generator``s seeded like the JAX keys;
:func:`run_study` takes ``noise_fn_for`` and ``regret_draws`` to replay
other draws (the JAX package's, or one device's on another).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import pipeline
from .config import GuidanceConfig, SamplerConfig, SCGConfig
from .diffusion import gaussian as gd
from .diffusion.latent import make_decode_fn
from .diffusion.sampling import torch_noise_fn
from .diffusion.schedule import make_schedule
from .rules.registry import FUNC_DICT, LOSS_DICT
from .utils.fixtures import load_fixture_npz, make_rolls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
GATE = os.path.join(REPO, "tests", "fixtures", "light_gate_tiny.npz")
#: where the port's study writes (and ``--merge`` reads) its JSON
OUT_PATH = os.path.join(REPO, "loggings", "allrules_gate_study.json")

SHAPE = (4, 4, 128, 16)
K = 16
STEPS = 16
RULES = ("pitch_hist", "note_density", "chord_progression")
WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0),
           ("chord_progression", 1.0))
SEEDS = (0, 1, 2, 3)
REGRET_TIMESTEPS = (2, 5, 8, 11, 14)
TINY_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)

ALL_VARIANTS = ("plain", "full", "light_dec", "feat", "feat_roll",
                "feat_pre4_light", "feat_pre4_full", "feat_pre4_roll_light",
                # bench.py's dpmpp20_sde_feat_pre4 serving row at the same
                # operating point: SDE-DPM-Solver++ chains with no SCG,
                # full-decoder SCG, and the production substitute stack
                "sde_plain", "sde_full", "sde_feat_pre4_roll_light")


def variant_parts(variant: str) -> dict:
    """What a row runs: SDE-DPM-Solver++ (``sde``) or DDPM, SCG on
    (``scg``), the prefilter's m (``prefilter``), the candidate decoder
    (``decoder``: "full", "light" or None), the rule-feature head
    (``features``) and the rollout student (``rollout``)."""
    sde = variant.startswith("sde_")
    name = variant[len("sde_"):] if sde else variant
    light = name.endswith("_light") or name == "light_dec"
    decoder = "full" if name in ("full", "feat_pre4_full") else \
        "light" if light else None
    return dict(sde=sde, scg=name != "plain",
                prefilter=4 if "_pre4" in name else 0, decoder=decoder,
                features=name.startswith("feat"), rollout="_roll" in name)


def sampler_config(variant: str, record: bool = False) -> SamplerConfig:
    """The row's chain, as the JAX study's cfg_plain / cfg_scg build it."""
    parts = variant_parts(variant)
    base = dict(sampler="dpmpp", dpmpp_sde=True) if parts["sde"] else \
        dict(sampler="ddpm")
    if not parts["scg"]:
        return SamplerConfig(**base, record=record)
    return SamplerConfig(
        **base, record=record,
        guidance=GuidanceConfig(method="no_guidance", schedule=True,
                                t_start=STEPS, t_end=0),
        scg=SCGConfig(num_samples=K, weights=WEIGHTS,
                      prefilter=parts["prefilter"]))


def build(device) -> dict:
    """The fixtures' models in float32 on ``device``, the 16-step tables
    and the targets (B rows of the sparsest reconstruction)."""
    dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                   model_path=QUALITY, dtype=torch.float32,
                                   device=device)
    vae = pipeline.create_vae(QUALITY, arch=TINY_VAE, encoder=True,
                              dtype=torch.float32, device=device)
    light = pipeline.ScoringBundle.create(
        decoder_path=GATE, features_path=GATE, rollout="DiTRotary_XS_8",
        rollout_path=GATE, num_classes=0, dtype=torch.float32, device=device)
    scale = float(load_fixture_npz(QUALITY)["scale"])
    train = torch.as_tensor(make_rolls(8, seed=21), device=device)
    rec = pipeline.decode_rolls(vae, pipeline.encode_rolls(vae, train, scale), scale)
    nds = FUNC_DICT["note_density"](rec)
    idx = int(torch.argsort(nds[:, :8].mean(dim=1))[0])
    targets = {}
    for name in RULES:
        row = FUNC_DICT[name](rec)[idx]
        targets[name] = row[None].repeat((SHAPE[0],) + (1,) * row.dim())
    return dict(dit=dit, vae=vae, light=light, scale=scale, targets=targets,
                tables=make_schedule("linear", 1000, str(STEPS)).tables(device))


def run_chain(m: dict, variant: str, noise_fn) -> torch.Tensor:
    """The row's final latents (B, 4, 128, 16) under ``noise_fn``."""
    parts = variant_parts(variant)
    light = m["light"]
    # the full decoder is the VAE's own: the bundle holds the light models
    scoring = pipeline.ScoringBundle(
        decoder=light.decoder if parts["decoder"] == "light" else None,
        feature_head=light.feature_head if parts["features"] else None,
        rollout=light.rollout if parts["rollout"] else None)
    x, _ = pipeline.generate(m["dit"], m["vae"], m["tables"],
                             sampler_config(variant), SHAPE, m["targets"],
                             noise_fn=noise_fn, scoring=scoring, num_classes=0,
                             scale_factor=m["scale"])
    return x


def final_losses(m: dict, x: torch.Tensor) -> Dict[str, float]:
    """Each rule's mean loss of the decoded result, and the weighted sum."""
    rolls = pipeline.decode_rolls(m["vae"], x, m["scale"])
    out = {r: float(LOSS_DICT[r](FUNC_DICT[r](rolls), m["targets"][r]).mean())
           for r in RULES}
    out["weighted"] = sum(out[r] * w for r, w in WEIGHTS)
    return out


@torch.no_grad()
def cand_losses(m: dict, x_t, t, noise) -> Dict[str, Dict[str, np.ndarray]]:
    """(K, B) per-rule losses of the K one-step candidates of ``x_t`` (the
    posterior mean plus its std times ``noise``, each rolled out to x̂0),
    ranked by the full decoder, the light decoder and the head."""
    dit, tables, scale = m["dit"], m["tables"], m["scale"]
    eps = dit(x_t, tables.model_t[t])
    x0 = gd.predict_xstart_from_eps(tables, x_t, t, eps)
    mean, _, logvar = gd.q_posterior_mean_variance(tables, x0, x_t, t)
    cands = mean[None] + torch.exp(0.5 * logvar)[None] * noise
    flat = cands.reshape((K * x_t.shape[0],) + tuple(x_t.shape[1:]))
    t_k = t.repeat(K)
    x0_c = gd.predict_xstart_from_eps(tables, flat, t_k,
                                      dit(flat, tables.model_t[t_k]))
    decode = make_decode_fn(m["vae"].decode, scale_factor=scale)
    light_decode = make_decode_fn(m["light"].decoder.decode, scale_factor=scale)
    head = m["light"].feature_head
    out = {}
    for tag, feats_of in (
            ("full", lambda z: {r: FUNC_DICT[r](decode(z)) for r in RULES}),
            ("light_dec", lambda z: {r: FUNC_DICT[r](light_decode(z)) for r in RULES}),
            ("feat", lambda z: head.features(z / scale))):
        feats = feats_of(x0_c)
        out[tag] = {r: LOSS_DICT[r](feats[r], m["targets"][r].repeat(
            (K,) + (1,) * (m["targets"][r].dim() - 1))).reshape(K, -1).cpu().numpy()
            for r in RULES}
    return out


def norm_regret(outs) -> Dict[str, Dict[str, float]]:
    """Per substitute ("light_dec", "feat") and per key (each rule and
    "weighted"): the mean regret of its pick, measured in the full
    ranker's loss of that key, over the mean spread of that loss, over
    every (timestep, batch row) of ``outs`` (one :func:`cand_losses` dict
    per timestep). The substitute picks by its own weighted loss."""
    keys = RULES + ("weighted",)
    regret = {tag: {k: [] for k in keys} for tag in ("light_dec", "feat")}
    spread = {k: [] for k in keys}
    w = dict(WEIGHTS)
    for out in outs:
        out = {tag: dict(v, weighted=sum(v[r] * w[r] for r in RULES))
               for tag, v in out.items()}
        for b in range(out["full"]["weighted"].shape[1]):
            for key in keys:
                lf = out["full"][key][:, b]
                spread[key].append(lf.max() - lf.min())
                for tag in regret:
                    choice = int(out[tag]["weighted"][:, b].argmin())
                    regret[tag][key].append(lf[choice] - lf.min())
    return {tag: {k: float(np.mean(regret[tag][k]))
                  / (float(np.mean(spread[k])) + 1e-12) for k in keys}
            for tag in regret}


def torch_regret_draws(i: int, shape, device):
    """(x_t noise of ``shape``, (K,) + ``shape`` candidate noise) of regret
    timestep ``i``, from a generator seeded 100 + i (the JAX keys)."""
    gen = torch.Generator(device=device).manual_seed(100 + i)
    return (torch.randn(shape, generator=gen, device=device),
            torch.randn((K,) + tuple(shape), generator=gen, device=device))


def run_study(want, *, merge: bool = False, skip_regret: bool = False,
              device="cuda", seeds=SEEDS,
              noise_fn_for: Optional[Callable] = None,
              regret_draws: Optional[Callable] = None) -> dict:
    """Measure the rows ``want`` for ``seeds`` (others carried over from
    :data:`OUT_PATH` with ``merge``) and, unless ``skip_regret``, the
    regret; write and return the JSON. ``noise_fn_for(seed)`` gives a
    chain's ``noise_fn`` and ``regret_draws(i, shape)`` the regret's
    draws; by default torch generators on ``device`` seeded ``seed`` and
    100 + i."""
    device = pipeline.resolve_device(device)
    m = build(device)
    noise_fn_for = noise_fn_for or (lambda seed: torch_noise_fn(
        torch.Generator(device=device).manual_seed(seed), device))
    regret_draws = regret_draws or (lambda i, shape: torch_regret_draws(i, shape,
                                                                        device))
    results, per_seed, prior = {}, {}, {}
    if merge and os.path.exists(OUT_PATH):
        with open(OUT_PATH) as f:
            prior = json.load(f)
        results.update(prior.get("final_losses", {}))
        per_seed.update(prior.get("per_seed", {}))
    for name in (v for v in ALL_VARIANTS if v in want):
        t0 = time.perf_counter()
        per_seed[name] = {}
        for seed in seeds:
            per_seed[name][str(seed)] = losses = final_losses(
                m, run_chain(m, name, noise_fn_for(seed)))
            print(f"  {name} seed {seed}: weighted={losses['weighted']:.4f}",
                  flush=True)
        per_rule = {r: sum(per_seed[name][str(s)][r] for s in seeds) / len(seeds)
                    for r in RULES}
        per_rule["weighted"] = sum(per_rule[r] * w for r, w in WEIGHTS)
        results[name] = per_rule
        print(f"{name:>10}: " + "  ".join(
            f"{r}={per_rule[r]:.4f}" for r in list(RULES) + ["weighted"])
            + f"   ({time.perf_counter()-t0:.0f}s)", flush=True)

    if skip_regret:
        reg_summary = prior.get("norm_regret", {})
    else:
        gt = pipeline.encode_rolls(m["vae"], torch.as_tensor(
            make_rolls(SHAPE[0], seed=33), device=device), m["scale"])
        outs = []
        for i, t_scalar in enumerate(REGRET_TIMESTEPS):
            t = torch.full((SHAPE[0],), t_scalar, dtype=torch.long, device=device)
            n1, n2 = regret_draws(i, tuple(gt.shape))
            x_t = gd.q_sample(m["tables"], gt, t, n1)
            outs.append(cand_losses(m, x_t, t, n2))
        reg_summary = norm_regret(outs)
        for tag, row in reg_summary.items():
            print(f"regret[{tag}]: " + "  ".join(f"{k}={v:.3f}"
                                                 for k, v in row.items()), flush=True)

    # --merge can carry over rows of another seed set: each row's own seeds
    study = {"final_losses": results, "per_seed": per_seed,
             "norm_regret": reg_summary, "k": K, "weights": dict(WEIGHTS),
             "seeds_this_run": list(seeds),
             "seeds_per_variant": {name: sorted(int(s) for s in per_seed.get(name, {}))
                                   for name in results}}
    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    with open(OUT_PATH, "w") as f:
        json.dump(study, f, indent=2)
    print(f"wrote {OUT_PATH}" + (" (regret carried over)" if skip_regret else ""))
    return study


def main(argv=None, **hooks) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=",".join(ALL_VARIANTS),
                        help="comma list of chain variants to (re)measure; "
                             "others are carried over from the existing "
                             "JSON (--merge)")
    parser.add_argument("--merge", action="store_true",
                        help="merge into OUT_PATH's JSON instead of starting "
                             "fresh")
    parser.add_argument("--skip_regret", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    want = [v for v in args.variants.split(",") if v]
    unknown = set(want) - set(ALL_VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    return run_study(want, merge=args.merge, skip_regret=args.skip_regret,
                     device=args.device, **hooks)


if __name__ == "__main__":
    main()
