"""Time the kernels alone, to compare two checkouts on one card.

    python3 tools/kernel_ab.py [--root DIR] [--reps 200]
    python3 tools/kernel_ab.py --backward [--root DIR] [--reps 20]
    python3 tools/kernel_ab.py --backward --parent DIR [--pairs 2]
    python3 tools/kernel_ab.py --backward --only attention \
        --tree nw4=DIR --tree pair=DIR [--pairs 2]
    python3 tools/kernel_ab.py --fp32 [--parent DIR --pairs 2]
    python3 tools/kernel_ab.py --only quant [--parent DIR --pairs 2]
    python3 tools/kernel_ab.py --only quant --routes

Imports ``chip_smoke.py`` and ``rule_guided_music_tpu_torch`` from
``--root`` (default: this checkout) and builds the kernels it times.

The default mode times the forward kernels at small, host-bound shapes
with CUDA events, over ``--reps`` calls after a warm-up: kernel 1's bf16
forward at each of ``chip_smoke.PIXEL_ATTN_SHAPES`` (the pixel paths'
shapes, where a call is short enough for the launcher's host work to
show), and kernel 2's bf16 forward at each decoder geometry on 2 chunks.

``--backward`` times the backward kernels, bf16, each case as one
``torch.autograd.grad`` over retained graphs:
  - kernel 2 at one train_vae step's 50 call shapes (the production VAE's
    encoder and decoder at 128 chunks; seeded random weights, captured
    under autocast) with dw/dbias and with x alone, at the 29 call
    shapes of one production decode of 16 chunks (DPS) with x alone, and at
    the 29 of ``distill_scoring_decoder``'s ch=64 student at 32 chunks
    with dw/dbias, beside ``F.group_norm`` + ``F.silu`` there;
  - kernel 1 at each ``chip_smoke.GRAD_SHAPES`` entry (the classifiers,
    XL_8 at B=2 for DPS), at ``chip_smoke.EDM_GRAD_SHAPE``, at
    ``chip_smoke.TRAIN_ATTN_SHAPE``, at the classifiers' B=16, at the
    pixel UNet's (2,1024,4,64) (past the cluster kernel's N) and at the
    rollout distill's B_8 student (``chip_smoke.DISTILL_STUDENT_ATTN``).
``--only attention`` or ``--only groupnorm`` times one kernel's cases.

``--fp32`` times kernel 1 in fp32 (the fp32 card-versus-CPU checks,
``sample_rule --dtype float32``, ``train_dit --bf16 False``): the forward
at ``FP32_FWD_SHAPES`` (train_dit's and the DiT's B=2, the classifiers',
a D that is not a multiple of 8) and the backward at ``FP32_BWD_SHAPES``
(the classifiers', DPS's, train_dit's), each beside
``F.scaled_dot_product_attention`` in fp32 on the same inputs with TF32
off for matmuls and cuDNN (PyTorch's memory-efficient kernel, which runs
fp32 on the tensor cores as three TF32 products), and beside two bounds:
three TF32 products at 495 TFLOP/s (``bound_ms``) and one product on the
fp32 pipes at 67 TFLOP/s (``fp32_pipes_bound_ms``), each against the
bytes at 3.35 TB/s. SDPA's device ms sum every kernel its call launches;
their names are in ``sdpa_kernels``.
Each case reports the CUDA-event ms per call (host time included: the
wrapper's launches, the autograd engine) and the device ms per call of the
backward kernels alone from ``torch.profiler``'s ``key_averages()``.

``--only quant`` times the int8 kernels (csrc/quant_gemm.cu) by
``torch.profiler``'s device ms: the per-token quantization, w8a16's fp32
route (at 512 and 8192 tokens) with its bound (three bf16 products), and
the bf16 w8a16 and w8a8 GEMMs, at XL_8's four trunk linears
(``chip_smoke.XL_LINEARS``) at 1, 16, 512 and 8192 tokens, each beside
bf16 ``F.linear`` (fp32 ``F.linear`` without TF32 for the fp32 route) and
(above 16 rows) ``torch._int_mm`` without an epilogue, and summed over the
trunk's 28 blocks at each token count; a tree that has it also gives the
route each GEMM takes. Each case has device ms, CUDA-event ms (host
included) and, at 1 and 16 rows where the device's work is short, the
host ms a call (``host_ms``: the wrapper's checks, its tensor maps and its
launch); there the whole w8a8 linear (``quant_dense_apply``: one host call
where the tree has ``quant.w8a8_linear``, the quantization and the GEMM
called apart where not) is timed too. ``--routes`` times instead each
GEMM at each forced route (``quant.force_route``) of ``QUANT_ROUTES`` at
those shapes (the fp32 route at BN 128 alone), and at K = 4608 the share
of w8a16's bf16 outputs that differ from the plain version's
(``bf16_disagreement``), the data ``pick_route`` was fitted to.

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
ATTN_FWD_KERNELS = ("flash_fwd",)
# kernel 1 in fp32: train_dit's XL_8 at 32 latents, the DiT at B=2 (DPS),
# the classifiers with CLS (ragged N), D not a multiple of 8; backward: the
# classifiers' cond_fn, DPS, train_dit --bf16 False
FP32_FWD_SHAPES = [(32, 256, 16, 72), (2, 256, 16, 72), (2, 257, 6, 64),
                   (2, 100, 3, 36)]
FP32_BWD_SHAPES = [(2, 257, 6, 64), (2, 256, 16, 72), (32, 256, 16, 72)]
TRAIN_VAE_CHUNKS = 128
DPS_DECODE_CHUNKS = 16
# kernel 1's backward besides chip_smoke's gradient shapes: the classifiers
# at B=16, and the pixel UNet's N = 1024, past the cluster kernel's N
MORE_GRAD_SHAPES = [(16, 257, 6, 64), (2, 1024, 4, 64)]


def device_ms(torch, fn, names, reps, seen=None, per_launch=False):
    """Device ms per call of ``fn`` spent in kernels whose name holds one of
    ``names`` (every kernel where ``names`` is None), from torch.profiler's
    key_averages() over ``reps`` calls; the names counted are added to the
    list ``seen`` where given. ``per_launch``: each kernel's mean time a
    launch times its launches a call (the count over ``reps``, rounded), so
    that events the profiler drops do not lower the figure."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if names is None or any(n in ev.key for n in names):
            t = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
            if per_launch and ev.count:
                t = t / ev.count * max(1, round(ev.count / reps)) * reps
            total += t
            if seen is not None and t > 0:
                seen.append(ev.key)
    return total / 1e3 / reps


def host_ms(torch, fn, reps, rounds=5):
    """Host ms a call of ``fn``: the least over ``rounds`` of the host
    clock around ``reps`` back-to-back calls (each enqueues its launches
    and returns), so that a neighbour's burst on the host's shared cores
    does not count; the device is synchronised between rounds."""
    import time

    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * best / reps


def time_case(torch, cs, fn, names, reps, seen=None):
    return {"event_ms": cs.cuda_time_ms(fn, reps=reps, warmup=2),
            "device_ms": device_ms(torch, fn, names, reps, seen)}


def load_attention(fa):
    """Builds kernel 1; {"build_s <source>": seconds} (0 where a build was
    reused). A tree from before the fp32 and backward sources were split
    off has one library."""
    if hasattr(fa, "load_all"):
        return {f"build_s {name}": r.seconds for name, r in fa.load_all().items()}
    fa._load()
    return {"build_s flash_attention": fa.build_result.seconds}


def fp32_bounds(shape, backward):
    """Kernel 1's fp32 bounds at ``shape``: three TF32 products at 495
    TFLOP/s, and one product on the fp32 pipes at 67, each against the
    bytes (inputs read once, outputs written once) at 3.35 TB/s."""
    b, n, h, d = shape
    if backward:   # q, k, v, o, dO in, LSE in, dq, dk, dv out; five products
        nbytes, ops = 8 * b * n * h * d * 4 + 4 * b * h * n, 10 * b * h * n * n * d
    else:          # q, k, v in, o out; two products
        nbytes, ops = 4 * b * n * h * d * 4, 4 * b * h * n * n * d
    mem = nbytes / 3.35e12
    return {"bound_ms": 1e3 * max(mem, 3 * ops / 495e12),
            "fp32_pipes_bound_ms": 1e3 * max(mem, ops / 67e12)}


def fp32_cases(torch, cs, fa, reps):
    """Kernel 1 in fp32, forward and backward, beside SDPA fp32 (TF32 off)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    out, seen = {}, []
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for shape in FP32_FWD_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out[f"fp32 fwd {shape}"] = {
                **time_case(torch, cs, lambda: fa.flash_attention(q, k, v),
                            ATTN_FWD_KERNELS, reps),
                "sdpa": time_case(torch, cs,
                                  lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                  None, reps, seen),
                **fp32_bounds(shape, False)}
        for shape in FP32_BWD_SHAPES:
            leaves = [torch.randn(shape, generator=gen, device="cuda").requires_grad_()
                      for _ in range(3)]
            cot = torch.randn(shape, generator=gen, device="cuda")
            y = fa.flash_attention(*leaves)
            lib_y = F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in leaves)).transpose(1, 2)
            out[f"fp32 bwd {shape}"] = {
                **time_case(torch, cs, lambda: torch.autograd.grad(
                    y, leaves, cot, retain_graph=True), ATTN_BWD_KERNELS, reps),
                "sdpa": time_case(torch, cs, lambda: torch.autograd.grad(
                    lib_y, leaves, cot, retain_graph=True), None, reps, seen),
                **fp32_bounds(shape, True)}
            del y, lib_y, leaves
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out["sdpa_kernels"] = sorted(set(seen))
    return out


def gn_backward_cases(torch, cs, gn, reps):
    """Kernel 2's backward at train_vae's 50 shapes (with dw/dbias, x
    alone), at the DPS decode's 29 (x alone) and, where the tree has the
    distill CLIs, at the ch=64 distill student's 29 (with dw/dbias, beside
    the library)."""
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

    def run(label, calls, params, norm=gn.groupnorm_swish, names=GN_BWD_KERNELS):
        graphs = []
        for x, mod in calls:
            w, b = (t.detach().to(x.dtype).requires_grad_(params)
                    for t in (mod.weight, mod.bias))
            xl = x.detach().requires_grad_()
            ins = [xl, w, b] if params else [xl]
            cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
            graphs.append((norm(xl, w, b, mod.num_groups, 1e-6), ins, cot))
        fn = lambda: [torch.autograd.grad(y, ins, cot, retain_graph=True)
                      for y, ins, cot in graphs]
        out[label] = {"calls": len(graphs),
                      "elements": sum(ins[0].numel() for _, ins, _ in graphs),
                      **time_case(torch, cs, fn, names, reps)}
        del graphs
        torch.cuda.empty_cache()

    run(f"groupnorm_swish bwd dw/dbias, train_vae {TRAIN_VAE_CHUNKS} chunks",
        calls, True)
    run(f"groupnorm_swish bwd dx, train_vae {TRAIN_VAE_CHUNKS} chunks", calls, False)
    del calls
    torch.cuda.empty_cache()
    run(f"groupnorm_swish bwd dx, DPS decode {DPS_DECODE_CHUNKS} chunks",
        dps_calls, False)
    if hasattr(cs, "DISTILL_DECODER_CHUNKS"):
        from rule_guided_music_tpu_torch.models.vae import ScoringDecoder
        from rule_guided_music_tpu_torch.training.distill import flax_init_

        student = flax_init_(ScoringDecoder(ch=64), 3).cuda()
        n = cs.DISTILL_DECODER_CHUNKS
        z = torch.randn((n, 4, 16, 16), generator=gen, device="cuda")
        with torch.autocast("cuda", dtype=torch.bfloat16):
            calls, _ = cs.capture_norm_inputs(torch, gn, student,
                                              lambda: student.decode(z))
        run(f"groupnorm_swish bwd dw/dbias, distill student {n} chunks", calls, True)
        # every kernel of the library's backward counts
        run(f"F.group_norm+F.silu bwd dw/dbias, distill student {n} chunks", calls,
            True, norm=cs.library_gn, names=None)
    return out


def attention_backward_cases(torch, cs, fa, reps):
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for shape in dict.fromkeys(list(cs.GRAD_SHAPES) + [cs.EDM_GRAD_SHAPE,
                                                       cs.TRAIN_ATTN_SHAPE]
                               + MORE_GRAD_SHAPES
                               + [getattr(cs, "DISTILL_STUDENT_ATTN", None)]):
        if shape is None:
            continue
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


# the int8 GEMMs' routes timed by --routes: (BN tokens a block, blocks of
# the k-split cluster)
QUANT_ROUTES = [(bn, s) for bn in (128, 256) for s in (1, 2, 3, 4)]
QUANT_TOKENS = (1, 16, 512, 8192)
QUANT_KERNELS = {"w8a16_gemm": ("w8a16_",), "w8a8_gemm": ("w8a8_",),
                 "quantize_rows": ("quantize_rows",), "w8a16_gemm fp32": ("w8a16_fp32",),
                 "w8a8 linear": ("quantize_rows", "w8a8_")}


def quant_cases(torch, cs, quant, reps, routes=False):
    """The int8 kernels' device ms at XL_8's trunk linears (see the
    module's head); with ``routes``, the GEMMs at every forced route."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(40)
    out = {}
    # fp32 products in full fp32, as the plain version's callers take them
    torch.backends.cuda.matmul.allow_tf32 = False
    for tokens in QUANT_TOKENS:
        trunk = {}

        def measure(label, fn, names):
            """Device ms (``names``' kernels), CUDA-event ms and, where the
            device's work is short, host ms a call; added to the trunk sum."""
            row = {"event_ms": cs.cuda_time_ms(fn, reps=10 * reps, warmup=5),
                   "device_ms": device_ms(torch, fn, names, reps, per_launch=True)}
            if tokens <= 16:
                row["host_ms"] = host_ms(torch, fn, 10 * reps)
            trunk[label] = trunk.get(label, 0.0) + 28 * row["device_ms"]
            return row

        for k, n in cs.XL_LINEARS:
            x, w8, sc, b = cs.quant_inputs(torch, gen, tokens, k, n)
            xb, bb = x.bfloat16(), b.bfloat16()
            q, s_x = quant.quantize_rows(xb)
            wb = torch.randn((n, k), generator=gen, device="cuda", dtype=torch.bfloat16)
            calls = {"w8a16_gemm": lambda: quant.wo_dense_apply(xb, w8, sc, b),
                     "w8a8_gemm": lambda: quant.w8a8_gemm(q, s_x, w8, sc, b),
                     "quantize_rows": lambda: quant.quantize_rows(xb),
                     "w8a16_gemm fp32": lambda: quant.wo_dense_apply(x, w8, sc, b)}
            shape = f"{tokens}x{k}->{n}"
            if routes:
                want = quant.wo_dense_reference(xb, w8, sc, b) if k > 2048 else None
                for bn, split in QUANT_ROUTES:
                    with quant.force_route(bn, split):
                        for name in ("w8a16_gemm", "w8a8_gemm", "w8a16_gemm fp32"):
                            if name.endswith("fp32") and bn != 128:
                                continue
                            out[f"{name} {shape} route {bn},{split}"] = device_ms(
                                torch, calls[name], QUANT_KERNELS[name], reps,
                                per_launch=True)
                        if want is not None:   # the data behind kMaxSerialTiles
                            out[f"w8a16_gemm {shape} route {bn},{split} bf16 share"] = (
                                quant.bf16_disagreement(calls["w8a16_gemm"](), want,
                                                        xb, w8, sc)[0])
                continue
            for name in ("w8a16_gemm", "w8a8_gemm", "quantize_rows"):
                row = measure(name, calls[name], QUANT_KERNELS[name])
                if name != "quantize_rows" and hasattr(quant, "gemm_route"):
                    row["route"] = quant.gemm_route(tokens, n, k, name.split("_")[0])
                if name == "quantize_rows" and hasattr(quant, "quantize_route"):
                    row["route"] = quant.quantize_route(tokens, k)
                out[f"{name} {shape}"] = row
            if tokens <= 16:   # the whole w8a8 linear, where host time sets it
                out[f"w8a8 linear {shape}"] = measure(
                    "w8a8 linear", lambda: quant.quant_dense_apply(xb, w8, sc, b),
                    QUANT_KERNELS["w8a8 linear"])
            out[f"F.linear {shape}"] = measure("F.linear", lambda: F.linear(xb, wb, bb), None)
            if tokens > 16:   # torch._int_mm takes more than 16 rows
                out[f"torch._int_mm {shape}"] = measure(
                    "torch._int_mm", lambda: torch._int_mm(q, w8.t()), None)
            if tokens >= 512:   # w8a16's fp32 route (card-vs-CPU checks, --dtype float32)
                wf = wb.float()
                out[f"w8a16_gemm fp32 {shape}"] = {
                    **measure("w8a16_gemm fp32", calls["w8a16_gemm fp32"],
                              QUANT_KERNELS["w8a16_gemm fp32"]),
                    # three bf16 products; x and y in fp32
                    "bound_ms": cs.bound_and_kind(4 * tokens * k + n * k + 8 * n
                                                  + 4 * tokens * n,
                                                  3 * 2 * tokens * n * k, "bfloat16")[0]}
                out[f"F.linear fp32 {shape}"] = measure(
                    "F.linear fp32", lambda: F.linear(x, wf, b), None)
        for name, ms in trunk.items():
            out[f"{name} trunk {tokens} tokens"] = ms
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
               "--reps", str(args.reps)] + (["--backward"] if args.backward else []) + (
                   ["--fp32"] if args.fp32 else [])
        if args.only:
            cmd += ["--only", args.only]
        if args.routes:
            cmd += ["--routes"]
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
                if case in ("root", "sdpa_kernels"):
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
    parser.add_argument("--fp32", action="store_true",
                        help="kernel 1 in fp32, forward and backward, beside SDPA")
    parser.add_argument("--parent", default=None,
                        help="a second checkout: run both alternately")
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: one more checkout to alternate with")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--only", choices=("attention", "groupnorm", "quant"), default=None)
    parser.add_argument("--routes", action="store_true",
                        help="with --only quant: each int8 GEMM at every forced route")
    args = parser.parse_args()
    if args.reps is None:
        args.reps = 20 if args.backward or args.fp32 else 200
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
    if args.only == "quant":
        from rule_guided_music_tpu_torch.ops import quant

        quant._load()
        out["build_s quant_gemm"] = quant.build_result.seconds
        out.update(quant_cases(torch, cs, quant, max(5, args.reps // 10), args.routes))
    elif args.fp32:
        out.update(load_attention(fa))
        out.update(fp32_cases(torch, cs, fa, args.reps))
    elif args.backward:
        if args.only != "groupnorm":
            out.update(load_attention(fa))
            out.update(attention_backward_cases(torch, cs, fa, args.reps))
        if args.only != "attention":
            gn._load()
            out["build_s groupnorm_swish"] = gn.build_result.seconds
            out.update(gn_backward_cases(torch, cs, gn, max(3, args.reps // 4)))
    else:
        load_attention(fa)
        gn._load()
        out.update(forward_cases(torch, cs, fa, gn, args.reps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
