"""Time one serving path of ``chip_smoke.py`` alone, or its flagship
path, to compare two checkouts on one card.

    python3 tools/serving_ab.py [--root DIR] [--yaml unguided_reuse2]
                                [--reps 7] [--after-encoder-checks]
    python3 tools/serving_ab.py --train-dit [--fp32 | --mesh] [--root DIR] [--reps 7]

``--yaml classifier_guidance`` times the flagship chain instead (SCG with
the three seeded random S/8 classifiers, 10 steps, as
``chip_smoke.classifier_path`` runs it) and builds no scoring bundle.

Imports ``chip_smoke.py`` and ``rule_guided_music_tpu_torch`` from
``--root`` (default: this checkout), builds both kernels, XL_8 + the
production KL-VAE decoder and the scoring bundle as ``chip_smoke.py`` does
(seeded random weights, bf16, B=2), runs the YAML's 4-step warm-up chain,
then ``--reps`` chains of the YAML, each timed on the host clock between
two ``torch.cuda.synchronize()`` calls, as ``chip_smoke.serving_path``
times its chain. ``--after-encoder-checks`` first runs the checks that
``chip_smoke.py``'s kernel-check phase runs on the production encoder
(kernel 2 on one encode, kernel 2's gradient at the decoder's shapes) and
frees that VAE, as the phase does; the checkout must have them. Prints the
card's name and power limit, then one JSON line with each chain's ms per
step and their median.

``--train-dit`` times ``train_dit.main`` instead, at the JAX script's
defaults as ``chip_smoke.train_dit_path`` runs it (DiTRotary_XL_8, batch 32
latents, bf16, seeded random weights and rolls in a temporary directory of
``--root``, deleted after): one warm-up step, then ``--reps`` steps, each
the loop's own host-clock ``step_ms`` (loading included). ``--fp32`` adds
``--bf16 False``: the trainer in fp32, whose attention takes kernel 1's
fp32 forward and backward. ``--mesh`` builds the loop plain and with
``--dp 1 --fsdp 1 --tp 1`` (a world of one over NCCL), times ``--reps``
steps of each in turn (plain, mesh, plain, ...), the ratio of their
medians, and traces one step more of each with ``torch.profiler``: the
step's wall ms, the ms in which the device was busy and the idle share,
and the host operators that took the most CPU time (self time).

The serving paths and the train step are host-bound, so two processes differ by more than
the code does: run parent and change alternately, each in its own
process, several pairs in one call.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--yaml", default="unguided_reuse2")
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--after-encoder-checks", action="store_true")
    parser.add_argument("--train-dit", action="store_true")
    parser.add_argument("--fp32", action="store_true",
                        help="with --train-dit: --bf16 False")
    parser.add_argument("--mesh", action="store_true",
                        help="with --train-dit: plain and world-1 mesh steps in "
                             "turn, traced")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from rule_guided_music_tpu_torch import pipeline
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.ops import flash_attention as fa
    from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    # kernel 1 is three libraries since its sources were split; one before
    fa.load_all() if hasattr(fa, "load_all") else fa._load()
    gn._load()
    if args.train_dit and args.mesh:
        return train_dit_mesh_steps(cs, root, args.reps, smi)
    if args.train_dit:
        return train_dit_steps(cs, root, args.reps, smi, args.fp32)
    if args.after_encoder_checks:
        vae_enc = cs.build_encoder_vae(torch, pipeline)
        cs.check_encoder(torch, gn, vae_enc)
        cs.check_gn_backward(torch, gn, vae_enc)
        del vae_enc
        torch.cuda.empty_cache()
    m = cs.build_main_models(torch, pipeline)
    extra = {}
    if args.yaml == "classifier_guidance":
        from types import SimpleNamespace

        classifiers = pipeline.build_classifier_bundles(
            SimpleNamespace(**cs.CLASSIFIERS), dtype=torch.bfloat16)
        extra["classifier_metas"] = [
            pipeline.ClassifierSpecMeta(fn=fn, rule_name=rule, scale=scale,
                                        model=model)
            for (fn, rule, scale), model in zip(cs.COND_FNS, classifiers)]
        config, tables = cs.sampler_config(args.yaml), m["tables"]
    else:
        extra["scoring"] = cs.build_scoring(torch, pipeline)
        respacing, config = cs.serving_config(args.yaml, record=True)
        tables = make_schedule("linear", 1000, respacing).tables("cuda")
    warm = make_schedule("linear", 1000, "4").tables("cuda")

    def chain(tables):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return pipeline.generate(m["dit"], m["vae"], tables, config, m["shape"],
                                 m["rules"], y=m["y"], generator=gen, **extra)[0]

    pipeline.decode_rolls(m["vae"], chain(warm))
    ms = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(tables)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / tables.num_timesteps)
    print(json.dumps({"root": root, "yaml": args.yaml,
                      "after_encoder_checks": args.after_encoder_checks,
                      "ms_per_step": ms, "median": statistics.median(ms),
                      "card": smi}))
    return 0


def train_dit_steps(cs, root, reps, smi, fp32=False):
    """``train_dit.main`` for 1 + ``reps`` steps (in fp32 where ``fp32``);
    prints each step's ms."""
    import shutil
    import tempfile

    import torch

    from rule_guided_music_tpu_torch import train_dit

    tmp = tempfile.mkdtemp(prefix=".train_ab_", dir=root)
    try:
        data = cs.write_train_manifest(os.path.join(tmp, "rolls"))
        loop = train_dit.main(["--data_dir", data, "--dir", os.path.join(tmp, "run"),
                               "--max_steps", str(1 + reps), "--log_interval",
                               str(1 + reps)] + (["--bf16", "False"] if fp32 else []))
    finally:
        shutil.rmtree(tmp)
    ms = loop.step_ms[1:]
    print(json.dumps({"root": root, "train_dit_step_ms": loop.step_ms,
                      "median": statistics.median(ms), "fp32": fp32,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "card": smi}))
    return 0


def _traced_step(loop, top):
    """One more step of ``loop`` under ``torch.profiler``: its wall ms, the
    device's busy ms and idle share, and the host operators with the most
    self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rule_guided_music_tpu_torch.utils.logger import _device_busy_ms

    batch = next(loop.data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_step(*batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, events = _device_busy_ms(prof.events())
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_events": events,
            "idle_share": 1.0 - busy / wall,
            "host_self_ms_total": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "host_top": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                         for e in ops[:top]]}


def train_dit_mesh_steps(cs, root, reps, smi, top=12):
    """``train_dit.main`` plain and at ``--dp 1 --fsdp 1 --tp 1`` (two
    steps each, the same seed and data), then ``reps`` steps of each loop
    in turn, plain then mesh, each on the host clock (loading included),
    and one step more of each under ``torch.profiler``; one JSON line."""
    import shutil
    import tempfile

    import torch

    from rule_guided_music_tpu_torch import train_dit

    tmp = tempfile.mkdtemp(prefix=".train_ab_", dir=root)
    try:
        cs.init_world(torch, tmp)
        data = cs.write_train_manifest(os.path.join(tmp, "rolls"))
        loops = {}
        for label in ("plain", "mesh"):
            flags = ["--dp", "1", "--fsdp", "1", "--tp", "1"] if label == "mesh" else []
            torch.manual_seed(0)
            run = os.path.join(tmp, label)
            loops[label] = train_dit.main(["--data_dir", data, "--dir", run,
                                           "--max_steps", "2", "--log_interval", "2",
                                           *flags])
            shutil.rmtree(os.path.join(run, "checkpoints"))
        ms = {label: [] for label in loops}
        for _ in range(reps):
            for label, loop in loops.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.run_step(*next(loop.data))
                torch.cuda.synchronize()
                ms[label].append(1e3 * (time.perf_counter() - t0))
        med = {label: statistics.median(v) for label, v in ms.items()}
        print(json.dumps({"root": root, "step_ms": ms, "median": med,
                          "ratio": med["mesh"] / med["plain"],
                          "traced": {label: _traced_step(loop, top)
                                     for label, loop in loops.items()},
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "card": smi}))
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
