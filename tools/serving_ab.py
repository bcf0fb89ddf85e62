"""Time one serving path of ``chip_smoke.py`` alone, or its flagship
path, to compare two checkouts on one card.

    python3 tools/serving_ab.py [--root DIR] [--yaml unguided_reuse2]
                                [--reps 7] [--after-encoder-checks]

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

The serving paths are host-bound, so two processes differ by more than
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
    fa._load()
    gn._load()
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


if __name__ == "__main__":
    sys.exit(main())
