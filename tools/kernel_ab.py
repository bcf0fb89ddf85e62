"""Time the forward kernels alone at small, host-bound shapes, to compare two
checkouts on one card.

    python3 tools/kernel_ab.py [--root DIR] [--reps 200]

Imports ``chip_smoke.py`` and ``rule_guided_music_tpu_torch`` from
``--root`` (default: this checkout), builds both kernels, then times with
CUDA events, over ``--reps`` calls after a warm-up: kernel 1's bf16
forward at each of ``chip_smoke.PIXEL_ATTN_SHAPES`` (the pixel paths'
shapes, where a call is short enough for the launcher's host work to
show), and kernel 2's bf16 forward at each decoder geometry on 2 chunks.
Prints the card's name and power limit, then one JSON line of ms per call.

Two processes of one code differ by more than a launcher's host work:
run parent and change alternately, each in its own process, several pairs
in one call.
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from rule_guided_music_tpu_torch.ops import flash_attention as fa
    from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    fa._load()
    gn._load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    for shape in cs.PIXEL_ATTN_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        out[f"attention {shape}"] = cs.cuda_time_ms(
            lambda: fa.flash_attention(q, k, v), reps=args.reps, warmup=10)
    for c, hw, _ in cs.GN_GEOMETRIES:
        x, w, b = cs.gn_inputs(torch, gen, 2, c, hw, torch.bfloat16)
        out[f"groupnorm_swish (2,{c},{hw},{hw})"] = cs.cuda_time_ms(
            lambda: gn.groupnorm_swish(x, w, b, 32), reps=args.reps, warmup=10)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
