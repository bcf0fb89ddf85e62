"""Time the kernels alone, to compare two checkouts on one card.

    python3 tools/kernel_ab.py [--root DIR] [--reps 200]
    python3 tools/kernel_ab.py --backward [--root DIR] [--reps 20]
    python3 tools/kernel_ab.py --backward --parent DIR [--pairs 2]
    python3 tools/kernel_ab.py --backward --only attention \
        --tree nw4=DIR --tree pair=DIR [--pairs 2]

Imports ``chip_smoke.py`` and ``rule_guided_music_tpu_torch`` from
``--root`` (default: this checkout) and builds both kernels.

The default mode times the forward kernels at small, host-bound shapes
with CUDA events, over ``--reps`` calls after a warm-up: kernel 1's bf16
forward at each of ``chip_smoke.PIXEL_ATTN_SHAPES`` (the pixel paths'
shapes, where a call is short enough for the launcher's host work to
show), and kernel 2's bf16 forward at each decoder geometry on 2 chunks.

``--backward`` times the backward kernels, bf16, each case as one
``torch.autograd.grad`` over retained graphs:
  - kernel 2 at one train_vae step's 50 call shapes (the production VAE's
    encoder and decoder at 128 chunks; seeded random weights, captured
    under autocast) with dw/dbias and with x alone, and at the 29 call
    shapes of one production decode of 16 chunks (DPS) with x alone;
  - kernel 1 at each ``chip_smoke.GRAD_SHAPES`` entry (the classifiers,
    XL_8 at B=2 for DPS), at ``chip_smoke.EDM_GRAD_SHAPE``, at
    ``chip_smoke.TRAIN_ATTN_SHAPE``, at the classifiers' B=16 and at the
    pixel UNet's (2,1024,4,64) (past the cluster kernel's N).
``--only attention`` or ``--only groupnorm`` times one kernel's cases.
Each case reports the CUDA-event ms per call (host time included: the
wrapper's launches, the autograd engine) and the device ms per call of the
backward kernels alone from ``torch.profiler``'s ``key_averages()``.

Either mode prints the card's name and power limit, then one JSON line
(with ``--backward``, also each library's build seconds: 0 where a build
of that checkout was reused).
Two processes of one code differ by more than a launcher's host work, so
compare parent and change alternately, each in its own process, several
pairs in one call: ``--parent DIR --pairs N`` runs this script for the
parent and this checkout in the order P C C P (N pairs), each in its own
process, prints each line, then one JSON line of each case's times per
tree. ``--tree NAME=DIR`` (repeatable) adds more checkouts, such as
variants of a kernel: the trees run in order, then in reverse, N times.
"""

import argparse
import json
import os
import subprocess
import sys

# the device kernels of each backward, as torch.profiler names them
GN_BWD_KERNELS = ("gn_swish_bwd_kernel", "gn_param_reduce_kernel")
ATTN_BWD_KERNELS = ("flash_bwd",)
TRAIN_VAE_CHUNKS = 128
DPS_DECODE_CHUNKS = 16
# kernel 1's backward besides chip_smoke's gradient shapes: the classifiers
# at B=16, and the pixel UNet's N = 1024, past the cluster kernel's N
MORE_GRAD_SHAPES = [(16, 257, 6, 64), (2, 1024, 4, 64)]


def device_ms(torch, fn, names, reps):
    """Device ms per call of ``fn`` spent in kernels whose name holds one of
    ``names``, from torch.profiler's key_averages() over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / 1e3 / reps


def time_case(torch, cs, fn, names, reps):
    return {"event_ms": cs.cuda_time_ms(fn, reps=reps, warmup=2),
            "device_ms": device_ms(torch, fn, names, reps)}


def gn_backward_cases(torch, cs, gn, reps):
    """Kernel 2's backward at train_vae's 50 shapes (with dw/dbias, x
    alone) and at the DPS decode's 29 (x alone)."""
    from rule_guided_music_tpu_torch import pipeline

    gen = torch.Generator(device="cuda").manual_seed(17)
    vae = pipeline.randomize_(pipeline.create_vae(encoder=True, dtype=torch.float32),
                              seed=5)
    x = torch.rand((TRAIN_VAE_CHUNKS, 3, 128, 128), generator=gen,
                   device="cuda") * 2 - 1
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, _ = cs.capture_norm_inputs(torch, gn, vae, lambda: vae.reconstruct(x))
    del x
    z = torch.randn((DPS_DECODE_CHUNKS, 4, 16, 16), generator=gen, device="cuda")
    dec = pipeline.randomize_(pipeline.create_vae(dtype=torch.float32), seed=1
                              ).to(torch.bfloat16)
    dps_calls, _ = cs.capture_norm_inputs(torch, gn, dec.decoder, lambda: dec.decode(z))
    del vae, dec
    out = {}

    def run(label, calls, params):
        graphs = []
        for x, mod in calls:
            w, b = (t.detach().to(x.dtype).requires_grad_(params)
                    for t in (mod.weight, mod.bias))
            xl = x.detach().requires_grad_()
            ins = [xl, w, b] if params else [xl]
            cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
            graphs.append((gn.groupnorm_swish(xl, w, b, mod.num_groups, 1e-6), ins, cot))
        fn = lambda: [torch.autograd.grad(y, ins, cot, retain_graph=True)
                      for y, ins, cot in graphs]
        out[label] = {"calls": len(graphs),
                      "elements": sum(ins[0].numel() for _, ins, _ in graphs),
                      **time_case(torch, cs, fn, GN_BWD_KERNELS, reps)}
        del graphs
        torch.cuda.empty_cache()

    run(f"groupnorm_swish bwd dw/dbias, train_vae {TRAIN_VAE_CHUNKS} chunks",
        calls, True)
    run(f"groupnorm_swish bwd dx, train_vae {TRAIN_VAE_CHUNKS} chunks", calls, False)
    del calls
    torch.cuda.empty_cache()
    run(f"groupnorm_swish bwd dx, DPS decode {DPS_DECODE_CHUNKS} chunks",
        dps_calls, False)
    return out


def attention_backward_cases(torch, cs, fa, reps):
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for shape in dict.fromkeys(list(cs.GRAD_SHAPES) + [cs.EDM_GRAD_SHAPE,
                                                       cs.TRAIN_ATTN_SHAPE]
                               + MORE_GRAD_SHAPES):
        leaves = [torch.randn(shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
        cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        y = fa.flash_attention(*leaves)
        fn = lambda: torch.autograd.grad(y, leaves, cot, retain_graph=True)
        out[f"flash_attention bwd {shape}"] = time_case(torch, cs, fn,
                                                        ATTN_BWD_KERNELS, reps)
    return out


def forward_cases(torch, cs, fa, gn, reps):
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in cs.PIXEL_ATTN_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        out[f"attention {shape}"] = cs.cuda_time_ms(
            lambda: fa.flash_attention(q, k, v), reps=reps, warmup=10)
    for c, hw, _ in cs.GN_GEOMETRIES:
        x, w, b = cs.gn_inputs(torch, gen, 2, c, hw, torch.bfloat16)
        out[f"groupnorm_swish (2,{c},{hw},{hw})"] = cs.cuda_time_ms(
            lambda: gn.groupnorm_swish(x, w, b, 32), reps=reps, warmup=10)
    return out


def alternate(args):
    """P C C P ...: this script for each tree in its own process."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": args.parent} if args.parent else {}
    trees["change"] = here
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = path
    trees = {name: os.path.abspath(path) for name, path in trees.items()}
    names = list(trees)
    order = [name for i in range(args.pairs)
             for name in (names if i % 2 == 0 else names[::-1])]
    runs = {name: [] for name in names}
    for name in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", trees[name],
               "--reps", str(args.reps)] + (["--backward"] if args.backward else [])
        if args.only:
            cmd += ["--only", args.only]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(f"== {name}: {' '.join(cmd[1:])}\n{proc.stdout}")
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"kernel_ab: the {name} run failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {}
    for name, lines in runs.items():
        for line in lines:
            for case, val in line.items():
                if case == "root":
                    continue
                summary.setdefault(case, {}).setdefault(name, []).append(val)
    print(json.dumps({"order": order, "cases": summary}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=None)
    parser.add_argument("--backward", action="store_true")
    parser.add_argument("--parent", default=None,
                        help="a second checkout: run both alternately")
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: one more checkout to alternate with")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--only", choices=("attention", "groupnorm"), default=None)
    args = parser.parse_args()
    if args.reps is None:
        args.reps = 20 if args.backward else 200
    if args.parent or args.tree:
        return alternate(args)

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
    out = {"root": root}
    if args.backward:
        if args.only != "groupnorm":
            fa._load()
            out["build_s flash_attention"] = fa.build_result.seconds
            out.update(attention_backward_cases(torch, cs, fa, args.reps))
        if args.only != "attention":
            gn._load()
            out["build_s groupnorm_swish"] = gn.build_result.seconds
            out.update(gn_backward_cases(torch, cs, gn, max(3, args.reps // 4)))
    else:
        fa._load()
        gn._load()
        out.update(forward_cases(torch, cs, fa, gn, args.reps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
