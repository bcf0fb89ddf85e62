#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds both CUDA sources from this checkout with nvcc (in parallel), checks
each hand-written kernel against its plain PyTorch version at the main
path's shapes (attention in bf16 on the tensor cores and in fp32 on the
SIMT kernel, on contiguous tensors and on strided views of one qkv tensor;
GroupNorm+swish at every decoder geometry, so every cluster size), drives
the port's SCG generation at full width (DiTRotary_XL_8 + the production
KL-VAE decoder, bf16, seeded random weights, k=16, weights 40/1/1 as in
scripts/configs/cond_table/all/scg.yml, on a 10-step respaced DDPM chain,
B=2), asserts that the run launched each kernel as often as its shapes say,
writes and reads back one MIDI file, and checks the port's card path
against its CPU path on the committed tiny fixture (the fp32 run, which
goes through the fp32 attention kernel). It then checks the attention
kernel's gradient (its autograd Function, whose backward replays the plain
version's VJP) against autograd through the plain version, drives the
flagship path of scripts/configs/cond_table/all/scg_classifier_all.yml (the
same SCG chain plus classifier guidance from three DiTRotary-S/8
classifiers, scales 400/10/10, seeded random weights) with its own launch
check, and holds the composite classifier gradient on the card against the
CPU on a tiny classifier configuration.

The serving stack: both kernels are checked and timed at its shapes
(attention at the DiTRotary_B_8 rollout's (32,256,12,64); GroupNorm+swish
on every call of one ch=64 ScoringDecoder decode of 64 chunks, on the
inputs the real asset gives it); each of the three
scripts/configs_serving YAMLs runs at its published depth (ddim100, 20
steps) through generate with the real ch=64 scoring decoder and
rule-feature head of assets/ and a seeded random DiTRotary_B_8 rollout,
and prints ms per step and per guided step, excerpts per minute at B=2,
peak memory beside the memory preflight's estimate, a per-component
breakdown with CUDA events, and launches against the shapes (for
unguided_reuse2, 50 refreshed trajectory calls x 28 blocks); and the
SDE-DPM-Solver++ prefilter chain on the light-scoring fixtures runs on the
card and on the CPU with the same noise.

Each phase prints its wall seconds. The line before the last is a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX and no PyYAML.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

REPO = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# (B, N, H, D): the rollout and trajectory DiT calls, the S/8 classifier
# with CLS (ragged N), and a D that is not a multiple of 8 (element loads)
ATTN_SHAPES = [(32, 256, 16, 72), (2, 256, 16, 72), (2, 257, 6, 64),
               (2, 100, 3, 36)]
# decoder GroupNorm+swish geometries (C, H=W) and their calls per decode
GN_GEOMETRIES = [(512, 16, 9), (512, 32, 1), (256, 32, 5), (256, 64, 6),
                 (256, 128, 1), (128, 128, 7)]
GN_CHUNKS = 32
GN_CHUNKS_MAIN = 256   # k * B * 8 chunks per guided step on the main path
# stated tolerances (max abs error against the plain version run in fp32 on
# the same values): fp32 allows summation-order differences. In bf16,
# GroupNorm+swish allows the final rounding of outputs below 8 (half an ulp
# is <= 2^-7); attention's outputs are convex combinations of V, below 2 at
# these shapes, so it allows half an ulp of the final rounding (<= 2^-8)
# and as much again for P rounded to bf16 before P V
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 1e-4, "bfloat16": 8e-3}

SCG_WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0),
               ("chord_progression", 1.0))

# guidance.cond_fn of scripts/configs/cond_table/all/scg_classifier_all.yml
# (the card has no PyYAML, so the script states it): (fn, rule, scale) and
# the classifiers; no weights are in the repo, so every path warns and
# keeps seeded random weights
COND_FNS = (("grad_nn_zt_mse", "pitch_hist", 400.0),
            ("grad_nn_zt_mse", "note_density", 10.0),
            ("grad_nn_zt_chord", "chord_progression", 10.0))
CLASSIFIERS = dict(
    names=["DiTRotary-S/8-cls", "DiTRotary-S/8-cls", "DiTRotary-S/8-chord-cls"],
    num_classes=[12, 16, 8],
    paths=["loggings/classifier/pitch/model009999",
           "loggings/classifier/nd/model009999",
           "loggings/classifier/chord/model004999"])
# the rollout DiTRotary_B_8 on k*B = 32 candidates (12 heads of 64)
ROLLOUT_ATTN_SHAPE = (32, 256, 12, 64)
# the serving path's candidate decode: m * B * 8 chunks (prefilter 4, B=2)
SCORING_DECODE_CHUNKS = 64
# GroupNorm+swish on the real decoder's activations, whose outputs exceed
# 8: in bf16 the final rounding is half an ulp, at most 2^-8 of |y|, so a
# call is held to TOL["bfloat16"] + 2^-8 |y| elementwise (the synthetic
# checks above keep TOL alone: their outputs stay below 8)
GN_REL_TOL = 2.0 ** -8

# the three scripts/configs_serving YAMLs as the port's loader reads them
# (the card has no PyYAML; tests/test_torch_serving.py holds these against
# the loader): name -> (timestep_respacing, SamplerConfig fields)
_SERVING_GUIDANCE = dict(schedule=True, t_start=750, t_end=0, interval=1)
_SERVING_SCG = dict(num_samples=16, prefilter=4,
                    weights=(("pitch_hist", 40.0), ("note_density", 1.0),
                             ("chord_progression", 1.0)))
SERVING = {
    "scg_fast_pre4": ("ddim100", dict(sampler="ddim", guidance=_SERVING_GUIDANCE,
                                      scg=_SERVING_SCG)),
    "scg_sde20_pre4": ("20", dict(sampler="dpmpp", dpmpp_sde=True,
                                  guidance=_SERVING_GUIDANCE, scg=_SERVING_SCG)),
    "unguided_reuse2": ("ddim100", dict(sampler="ddim", reuse_interval=2,
                                        guidance=dict(schedule=False))),
}
SCORING_ASSETS = dict(decoder_path="assets/scoring_decoder_ch64.npz",
                      features_path="assets/scoring_features_ch64.npz")
# the card-vs-CPU serving chain on the light-scoring fixtures, fp32 without
# TF32: final latents within 1e-3 (the models' summation order, carried by
# the 1/sqrt(alpha) factors of x0 through 6 SDE steps), as the SCG fixture
# check
SERVING_AGREE_TOL = 1e-3

# attention gradients, (B, N, H, D): the classifiers' blocks and the XL DiT's
GRAD_SHAPES = [(2, 257, 6, 64), (32, 256, 16, 72)]
# max abs difference of dq, dk, dv from autograd through the plain version,
# over the largest gradient: the backward replays that plain version on the
# same inputs, so fp32 allows summation order only; bf16 allows the final
# rounding of each gradient to bf16 (2^-8 relative) plus as much again
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the composite classifier gradient, card (fp32 kernel forward, no TF32)
# against CPU, over its largest magnitude: the forward's summation order
# (<= 1.7e-6 on attention outputs), carried through two blocks and a head
COND_GRAD_TOL = 1e-4


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)
            return False

    return _Phase()


def cuda_time_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def replay_noise(torch, seed):
    """A factory of ``noise_fn``s for one device each: every (kind, step)
    draw is made once on the CPU from ``seed`` and replayed on each device,
    so the card and the CPU chains see the same numbers."""
    gen = torch.Generator().manual_seed(seed)
    draws = {}

    def noise_fn_for(device):
        def noise(kind, step, shp):
            if (kind, step) not in draws:
                draws[kind, step] = torch.randn(shp, generator=gen)
            return draws[kind, step].to(device)
        return noise
    return noise_fn_for


@contextlib.contextmanager
def no_tf32(torch):
    """TF32 off for cuDNN and matmuls while a card-vs-CPU check runs."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def count_sass(lib_path, opcode):
    """Instructions of ``opcode`` in a built library's SASS (cuobjdump)."""
    from rule_guided_music_tpu_torch.ops.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def bound_ms(nbytes, ops, dtype_name):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name])


def check_attention(torch, fa, F):
    worst = {"float32": 0.0, "bfloat16": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ATTN_SHAPES:
        b, n, h, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            qkv = torch.randn((b, n, 3, h, d), generator=gen,
                              device="cuda").to(dtype)
            for layout, (qq, kk, vv) in (("contiguous", (q, k, v)),
                                         ("qkv views", qkv.unbind(2))):
                out = fa.flash_attention(qq, kk, vv)
                ref = fa.flash_attention_reference(qq.float(), kk.float(),
                                                   vv.float())
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                ok = err <= ATTN_TOL[dname]
                print(f"attention {shape} {dname} {layout}: max_abs_err "
                      f"{err:.3e} (tol {ATTN_TOL[dname]:.0e}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention {shape} {dname} "
                                         f"{layout}: {err}")
                worst[dname] = max(worst[dname], err)
    b, n, h, d = ATTN_SHAPES[0]
    results = {}
    for dtype, name in ((torch.bfloat16, "flash_attention"),
                        (torch.float32, "flash_attention_fp32")):
        dname = str(dtype).split(".")[-1]
        q, k, v = (torch.randn(ATTN_SHAPES[0], generator=gen, device="cuda",
                               dtype=dtype) for _ in range(3))
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                          dtype=dtype)
        qs, ks, vs = qkv.unbind(2)
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
        strided = cuda_time_ms(lambda: fa.flash_attention(qs, ks, vs))
        plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 4 * b * n * h * d * dtype.itemsize
        ops = 4 * b * h * n * n * d
        bnd = bound_ms(nbytes, ops, dname)
        by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S[dname]
              else "operations")
        print(f"attention {ATTN_SHAPES[0]} {dname} ({name}): kernel {ms:.4f} ms "
              f"contiguous, {strided:.4f} ms on qkv views; plain {plain:.4f} ms, "
              f"F.scaled_dot_product_attention {lib:.4f} ms, bound {bnd:.4f} ms "
              f"({by}), {100 * bnd / ms:.1f}% of the bound")
        results[name] = dict(max_abs_err=worst[dname], ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             strided_ms=strided,
                             shape=f"{ATTN_SHAPES[0]} {dname}, one launch")
    return results


def check_attention_rollout(torch, fa, F):
    """Kernel 1 at the B_8 rollout's shape, bf16: contiguous and on views
    of one qkv tensor, against the plain version; then its time beside the
    plain version, SDPA and the bound."""
    shape = ROLLOUT_ATTN_SHAPE
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    worst = 0.0
    for layout, (qq, kk, vv) in (("contiguous", (q, k, v)),
                                 ("qkv views", qkv.unbind(2))):
        out = fa.flash_attention(qq, kk, vv)
        ref = fa.flash_attention_reference(qq.float(), kk.float(), vv.float())
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        ok = err <= ATTN_TOL["bfloat16"]
        print(f"attention {shape} bfloat16 {layout} (rollout shape): max_abs_err "
              f"{err:.3e} (tol {ATTN_TOL['bfloat16']:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention {shape} {layout}: {err}")
        worst = max(worst, err)
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    nbytes, ops = 4 * b * n * h * d * 2, 4 * b * h * n * n * d
    bnd = bound_ms(nbytes, ops, "bfloat16")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["bfloat16"]
          else "operations")
    print(f"attention {shape} bf16, the rollout's shape: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of the bound")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, shape=f"{shape} bf16, one launch")


def check_scoring_decode(torch, gn, decoder):
    """Kernel 2 on one decode of 64 chunks through the ch=64 ScoringDecoder
    (the real asset, bf16): the inputs of its 29 GroupNorm+swish calls are
    captured, every call is held against the plain version in fp32 on its
    own input, and the 29 calls are timed (kernel, plain, library) with the
    bound of the bytes they must move."""
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].clone(), mod)))
        for m in decoder.modules() if isinstance(m, FusedNormSwish)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    z = torch.randn((SCORING_DECODE_CHUNKS, 4, 16, 16), generator=gen,
                    device="cuda")
    with torch.no_grad():
        decoder.decode(z)
    for hk in hooks:
        hk.remove()
    torch.cuda.synchronize()
    worst, excess, geoms = 0.0, -1.0, {}
    for x, mod in calls:
        c, hw = x.shape[1], x.shape[2]
        geoms[(c, hw)] = geoms.get((c, hw), 0) + 1
        out = gn.groupnorm_swish(x, mod.weight, mod.bias, mod.num_groups, 1e-6)
        ref = gn.groupnorm_swish_reference(x.float(), mod.weight.float(),
                                           mod.bias.float(), mod.num_groups, 1e-6)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - TOL["bfloat16"]
                              - GN_REL_TOL * ref.abs()).max().item())
    ok = excess <= 0
    spans = ", ".join(
        f"({c},{hw},{hw}) x{n}: span {(c // 32) * hw * hw * 2 // 1024} KB, "
        f"cluster of {gn.plan_slices((c // 32) * hw * hw, 2)[0]}"
        for (c, hw), n in geoms.items())
    print(f"groupnorm_swish on the ch=64 ScoringDecoder, {len(calls)} calls on "
          f"{SCORING_DECODE_CHUNKS} chunks: {spans}; max_abs_err {worst:.3e} "
          f"(tol {TOL['bfloat16']:.0e} + 2^-8 |y|; worst margin {-excess:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"groupnorm_swish on the scoring decode: {worst}")

    def run(fn):
        return lambda: [fn(x, mod.weight, mod.bias, mod.num_groups)
                        for x, mod in calls]

    with torch.no_grad():
        ms = cuda_time_ms(run(gn.groupnorm_swish), reps=5, warmup=1)
        plain = cuda_time_ms(run(gn.groupnorm_swish_reference), reps=5, warmup=1)
        lib = cuda_time_ms(run(library_gn), reps=5, warmup=1)
    elems = sum(x.numel() for x, _ in calls)
    nbytes, ops = 2 * elems * 2, 10 * elems
    bnd = bound_ms(nbytes, ops, "float32")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["float32"]
          else "operations")
    print(f"groupnorm_swish, one ScoringDecoder decode of {SCORING_DECODE_CHUNKS} "
          f"chunks ({len(calls)} calls) bf16: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, F.group_norm+F.silu {lib:.4f} ms, bound {bnd:.4f} ms "
          f"({by}), {100 * bnd / ms:.1f}% of the bound")
    for (c, hw), n in geoms.items():
        x, mod = next((x, m) for x, m in calls if x.shape[1:3] == (c, hw))
        one = cuda_time_ms(lambda: gn.groupnorm_swish(x, mod.weight, mod.bias,
                                                      mod.num_groups, 1e-6),
                           reps=10, warmup=2)
        bnd_one = bound_ms(2 * x.numel() * 2, 10 * x.numel(), "float32")
        print(f"  ({SCORING_DECODE_CHUNKS},{c},{hw},{hw}) bf16, {n} per decode: "
              f"{one:.4f} ms per call, bound {bnd_one:.4f} ms, "
              f"{100 * bnd_one / one:.1f}% of the bound")
    del calls
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib,
                shape=f"one ch=64 ScoringDecoder decode of {SCORING_DECODE_CHUNKS} "
                      f"chunks (29 calls), bf16")


def check_attention_grad(torch, fa, F):
    """dq, dk, dv through the kernel's autograd Function against autograd
    through the plain version, on the same card tensors (views of one qkv
    tensor, as the DiT passes them); then the classifier shape's forward
    and forward + backward times."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in GRAD_SHAPES:
        b, n, h, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            qkv = torch.randn((b, n, 3, h, d), generator=gen,
                              device="cuda").to(dtype).requires_grad_()
            cot = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            out = fa.flash_attention(q, k, v)
            if out.grad_fn is None:
                raise AssertionError("flash_attention: no grad_fn where a "
                                     "gradient is wanted")
            got = torch.autograd.grad(out, qkv, cot)[0].float()
            want = torch.autograd.grad(fa.flash_attention_reference(q, k, v),
                                       qkv, cot)[0].float()
            errs = [((got[:, :, i] - want[:, :, i]).abs().max()
                     / want[:, :, i].abs().max()).item() for i in range(3)]
            ok = max(errs) <= GRAD_TOL[dname]
            print(f"attention gradient {shape} {dname} ({out.grad_fn.name()}): "
                  f"max abs error over the largest gradient dq {errs[0]:.2e}, "
                  f"dk {errs[1]:.2e}, dv {errs[2]:.2e} (tol "
                  f"{GRAD_TOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention gradient {shape} {dname}")
    shape = GRAD_SHAPES[0]
    b, n, h, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
    nbytes, ops = 4 * b * n * h * d * 2, 4 * b * h * n * n * d
    bnd = bound_ms(nbytes, ops, "bfloat16")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["bfloat16"]
          else "operations")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention(*leaves), leaves, cot))
    plain_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention_reference(*leaves), leaves, cot))
    print(f"attention {shape} bf16, the classifiers' shape: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}), {100 * bnd / ms:.1f}% of the bound; "
          f"forward + replayed backward {fwd_bwd:.4f} ms (plain forward + "
          f"backward {plain_fwd_bwd:.4f} ms)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, fwd_bwd_ms=fwd_bwd, plain_fwd_bwd_ms=plain_fwd_bwd,
                shape=f"{shape} bf16, one launch")


def gn_inputs(torch, gen, chunks, c, hw, dtype):
    x = (torch.randn((chunks, c, hw, hw), generator=gen, device="cuda")
         * 2.0 + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def check_gn_call(torch, gn, x, w, b):
    """Max abs error of one kernel call against the plain version in fp32."""
    dname = str(x.dtype).split(".")[-1]
    out = gn.groupnorm_swish(x, w, b, 32)
    ref = gn.groupnorm_swish_reference(x.float(), w.float(), b.float(), 32)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    del out, ref
    ok = err <= TOL[dname]
    c, hw = x.shape[1], x.shape[2]
    clusters = gn.plan_slices((c // 32) * hw * hw, x.element_size())[0]
    print(f"groupnorm_swish {tuple(x.shape)} {dname}, cluster of {clusters}: "
          f"max_abs_err {err:.3e} (tol {TOL[dname]:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"groupnorm_swish {tuple(x.shape)} {dname}: {err}")
    return err


def time_decode(torch, fn, inputs, reps):
    """ms for the 29 GroupNorm+swish calls of one decode, CUDA events."""
    def all_calls():
        for c, hw, count in GN_GEOMETRIES:
            x, w, b = inputs[(c, hw)]
            for _ in range(count):
                fn(x, w, b, 32)
    return cuda_time_ms(all_calls, reps=reps, warmup=1)


def decode_bound(chunks):
    elems = sum(chunks * c * hw * hw * count for c, hw, count in GN_GEOMETRIES)
    nbytes, ops = 2 * elems * 2, 10 * elems
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["float32"]
          else "operations")
    return bound_ms(nbytes, ops, "float32"), by


def library_gn(x, w, b, g):
    import torch.nn.functional as F

    return F.silu(F.group_norm(x, g, w, b, 1e-6))


def time_gn_decode(torch, gn, inputs, chunks, reps, note=""):
    """Kernel, plain and library ms for one decode of ``chunks`` chunks."""
    ms = time_decode(torch, gn.groupnorm_swish, inputs, reps=reps)
    plain = time_decode(torch, gn.groupnorm_swish_reference, inputs, reps=reps)
    lib = time_decode(torch, library_gn, inputs, reps=reps)
    bnd, by = decode_bound(chunks)
    print(f"groupnorm_swish, one decode of {chunks} chunks (29 calls{note}) "
          f"bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"F.group_norm+F.silu {lib:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"{100 * bnd / ms:.1f}% of the bound")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)


def check_groupnorm(torch, gn):
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(1)
    # every geometry in both dtypes (clusters of 1, 2, 4 and 8), 32 chunks
    inputs = {}
    for c, hw, _ in GN_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = gn_inputs(torch, gen, GN_CHUNKS, c, hw, dtype)
            worst = max(worst, check_gn_call(torch, gn, x, w, b))
            if dtype == torch.bfloat16:
                inputs[(c, hw)] = (x, w, b)
    # the 32-chunk decode, the size PR 4's kernel was timed at
    time_gn_decode(torch, gn, inputs, GN_CHUNKS, reps=5)
    # the main path's batch: checked at every geometry, then timed; these
    # are the kernel's numbers in the kernels line
    inputs = {}
    for c, hw, _ in GN_GEOMETRIES:
        inputs[(c, hw)] = gn_inputs(torch, gen, GN_CHUNKS_MAIN, c, hw,
                                    torch.bfloat16)
        worst = max(worst, check_gn_call(torch, gn, *inputs[(c, hw)]))
    torch.cuda.empty_cache()
    main = time_gn_decode(torch, gn, inputs, GN_CHUNKS_MAIN, reps=3,
                          note=", the main path's batch")
    for c, hw, count in GN_GEOMETRIES:
        x, w, b = inputs[(c, hw)]
        one = cuda_time_ms(lambda: gn.groupnorm_swish(x, w, b, 32), reps=5,
                           warmup=1)
        bnd_one = bound_ms(2 * x.numel() * 2, 10 * x.numel(), "float32")
        clusters = gn.plan_slices((c // 32) * hw * hw, 2)[0]
        print(f"  ({GN_CHUNKS_MAIN},{c},{hw},{hw}) bf16, cluster of {clusters}, "
              f"{count} per decode: {one:.4f} ms per call, bound "
              f"{bnd_one:.4f} ms, {100 * bnd_one / one:.1f}% of the bound")
    del inputs
    return dict(max_abs_err=worst, **main,
                shape=f"one decode of {GN_CHUNKS_MAIN} chunks (29 calls), bf16")


def expected_launches(dit, vae, tables, config, final_decode, classifiers=()):
    """Launches the shapes predict for one generate call: one trajectory
    DiT call per step and one rollout per guided step; one decode per
    guided step, and the final decode where the caller makes one; and, with
    classifiers, one forward of each on every step that takes the
    classifier gradient (every step when SCG is on, in DDPM)."""
    from rule_guided_music_tpu_torch.diffusion.sampling import guide_schedule_mask
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    steps = tables.num_timesteps
    # the SCG search runs where the schedule says, except at t == t_end
    g = config.guidance
    n_guided = sum(guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
                   and t > config.t_end for t in range(steps))
    n_cond = steps if config.scg is not None else sum(
        guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
        for t in range(steps))
    cls_blocks = sum(len(c.blocks) for c in classifiers)
    norm_calls = sum(isinstance(m, FusedNormSwish) for m in vae.modules())
    return steps, n_guided, {
        "attention": len(dit.blocks) * (steps + n_guided) + cls_blocks * n_cond,
        "groupnorm_swish": norm_calls * (n_guided + final_decode)}


def reset_counts(fa, gn):
    fa.kernel_launches = dict.fromkeys(fa.kernel_launches, 0)
    gn.launches = 0


def read_counts(fa, gn):
    return {**fa.kernel_launches, "groupnorm_swish": gn.launches}


def build_main_models(torch, pipeline):
    """DiTRotary_XL_8 and the production KL-VAE decoder in bf16 with seeded
    random weights, the 10-step chain, targets and labels (B=2)."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    batch = 2
    dit = pipeline.create_denoiser("DiTRotary_XL_8", dtype=torch.float32)
    pipeline.randomize_(dit, seed=0)
    vae = pipeline.create_vae(dtype=torch.float32)
    pipeline.randomize_(vae, seed=1)
    rolls = torch.as_tensor(make_rolls(batch, seed=7), device="cuda")
    return dict(
        dit=dit.to(torch.bfloat16), vae=vae.to(torch.bfloat16),
        tables=make_schedule("linear", 1000, timestep_respacing="10").tables("cuda"),
        rolls=rolls,
        rules=pipeline.extract_targets_from_rolls([n for n, _ in SCG_WEIGHTS],
                                                  rolls),
        y=torch.full((batch,), 1, dtype=torch.long, device="cuda"),
        shape=(batch, 4, 128, 16))


def sampler_config(method="no_guidance"):
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)

    return SamplerConfig(
        sampler="ddpm",
        guidance=GuidanceConfig(method=method, schedule=True, t_start=750,
                                t_end=0, interval=1),
        scg=SCGConfig(num_samples=16, weights=SCG_WEIGHTS),
        record=True)


def run_chain(torch, port, m, config, classifiers=(), metas=()):
    """A warm-up chain, then the measured chain with every count set to 0
    just before it and read just after its final decode; checks the
    launches against the shapes and the outputs for shape and finiteness."""
    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    dit, vae, shape = m["dit"], m["vae"], m["shape"]
    t0 = time.perf_counter()
    pipeline.generate(dit, vae, m["tables"], config, shape, m["rules"], y=m["y"],
                      classifier_metas=metas,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    print(f"warm-up chain (first launches, cuDNN plans): "
          f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()

    reset_counts(fa, gn)
    t0 = time.perf_counter()
    latents, records = pipeline.generate(dit, vae, m["tables"], config, shape,
                                         m["rules"], y=m["y"],
                                         classifier_metas=metas, generator=gen)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    rolls_out = pipeline.decode_rolls(vae, latents)
    torch.cuda.synchronize()
    launches = read_counts(fa, gn)

    steps, n_guided, predicted = expected_launches(
        dit, vae, m["tables"], config, final_decode=True, classifiers=classifiers)
    # bf16 weights: every attention call takes the tensor-core kernel
    expected = {"flash_attention": predicted["attention"],
                "flash_attention_fp32": 0,
                "groupnorm_swish": predicted["groupnorm_swish"]}
    step_ms = 1e3 * chain_s / max(n_guided, 1)
    print(f"steps {steps}, guided {n_guided}, chain {chain_s:.3f} s, "
          f"{step_ms:.1f} ms per guided step (chain wall time / guided steps)")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    check_launches(launches, expected)
    for k, v in records.items():
        if k.startswith("loss/") or k == "guidance_grad_norm":
            label = ("classifier gradient L2 norm" if k == "guidance_grad_norm"
                     else f"{k} (best candidate)")
            print(f"{label} per step: "
                  + " ".join(f"{x:.4g}" for x in v.float().cpu().tolist()))

    batch = shape[0]
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError("latents: wrong shape or not finite")
    if tuple(rolls_out.shape) != (batch, 3, 128, 1024) or not torch.isfinite(rolls_out).all():
        raise AssertionError("decoded rolls: wrong shape or not finite")
    return launches, rolls_out, step_ms


def main_path(torch, port, m):
    pipeline = port["pipeline"]
    from rule_guided_music_tpu_torch.data.midi_io import read_midi
    from rule_guided_music_tpu_torch.data.pianoroll import (
        finalize_decoded_sample, roll_to_midi, save_piano_roll_midi)
    from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT, LOSS_DICT

    dit, vae, rules, y, shape = m["dit"], m["vae"], m["rules"], m["y"], m["shape"]
    batch = shape[0]
    config = sampler_config()
    launches, rolls_out, step_ms = run_chain(torch, port, m, config)
    with tempfile.TemporaryDirectory() as tmp:
        # the generated excerpt, and a target excerpt, which has notes for
        # certain (random weights give rolls the export may read as empty)
        for label, roll in (("generated", rolls_out[:1].cpu().numpy()),
                            ("target", m["rolls"][:1].cpu().numpy())):
            arr = finalize_decoded_sample(roll)
            path = save_piano_roll_midi(arr, os.path.join(tmp, label), 100,
                                        y=[1])[0]
            want = len(roll_to_midi(arr[0].astype("float32")).notes)
            got = len(read_midi(path).notes)
            print(f"MIDI {label} {os.path.basename(path)}: "
                  f"{os.path.getsize(path)} bytes, {got} notes read back "
                  f"(export wrote {want})")
            if label == "target" and got == 0:
                raise AssertionError("MIDI round trip lost the notes")

    # where a guided step's time goes, per component (CUDA events)
    k = config.scg.num_samples
    t_b = torch.full((batch,), 500.0, device="cuda")
    x_b = torch.randn(shape, device="cuda")
    x_kb = torch.randn((k * batch,) + shape[1:], device="cuda")
    t_kb = torch.full((k * batch,), 500.0, device="cuda")
    y_kb = torch.full((k * batch,), 1, dtype=torch.long, device="cuda")
    chunks = torch.randn((k * batch * 8, 4, 16, 16), device="cuda")
    decoded = torch.rand((k * batch, 3, 128, 1024), device="cuda") * 2 - 1
    with torch.inference_mode():
        parts = {
            f"DiT trajectory call (B={batch})": lambda: dit(x_b, t_b, y),
            f"DiT rollout call (k*B={k * batch})": lambda: dit(x_kb, t_kb, y_kb),
            f"VAE decode ({k * batch * 8} chunks)": lambda: vae.decode(chunks),
            f"rules + losses ({k * batch} rolls)": lambda: [
                LOSS_DICT[n](FUNC_DICT[n](decoded), rules[n].repeat(k, 1))
                for n in rules],
        }
        for name, fn in parts.items():
            print(f"breakdown {name}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")
    return launches, step_ms


def classifier_path(torch, port, m, scg_step_ms):
    """The flagship path: the main path's chain with classifier guidance
    from the YAML's three classifiers, on every step (SCG is on)."""
    from types import SimpleNamespace

    from rule_guided_music_tpu_torch.diffusion.guidance import (
        CondFnSpec, make_grad_cond_fn)

    pipeline = port["pipeline"]
    classifiers = pipeline.build_classifier_bundles(
        SimpleNamespace(**CLASSIFIERS), dtype=torch.bfloat16)
    metas = [pipeline.ClassifierSpecMeta(fn=fn, rule_name=rule, scale=scale,
                                         model=model)
             for (fn, rule, scale), model in zip(COND_FNS, classifiers)]
    launches, _, step_ms = run_chain(
        torch, port, m, sampler_config("classifier_guidance"), classifiers,
        metas)
    print(f"ms per guided step: {step_ms:.1f} with classifier guidance, "
          f"{scg_step_ms:.1f} without (the phase before), +{step_ms - scg_step_ms:.1f}")

    # the cond_fn alone: forward and backward of the three classifiers, B=2
    specs = [CondFnSpec(fn=x.fn, rule_name=x.rule_name, scale=x.scale,
                        classifier=x.model) for x in metas]
    cond_fn = make_grad_cond_fn(specs)
    batch = m["shape"][0]
    x_b = torch.randn(m["shape"], device="cuda")
    t_b = torch.full((batch,), 500.0, device="cuda")
    with torch.no_grad():
        both = cuda_time_ms(lambda: cond_fn(x_b, t_b, m["rules"]), reps=5,
                            warmup=1)
        fwd = cuda_time_ms(lambda: [s.logprob(x_b, t_b, m["rules"])
                                    for s in specs], reps=5, warmup=1)
    print(f"breakdown cond_fn (3 classifiers, forward + backward, B={batch}): "
          f"{both:.2f} ms (forward alone {fwd:.2f} ms)")
    return launches


def cond_fn_card_vs_cpu(torch, port):
    """The composite classifier gradient on a tiny configuration (three
    classifiers of hidden 64, depth 2, 2 heads; the YAML's functions, rules
    and scales), fp32 without TF32, on the card against the CPU."""
    import copy

    from rule_guided_music_tpu_torch.diffusion.guidance import (
        CondFnSpec, make_grad_cond_fn)
    from rule_guided_music_tpu_torch.models.dit import DiTRotaryClassifier
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    cpu_models = [pipeline.randomize_(DiTRotaryClassifier(
        num_classes=n, chord="chord" in fn, hidden_size=64, depth=2,
        num_heads=2), seed=100 + i).requires_grad_(False)
        for i, ((fn, _, _), n) in enumerate(zip(COND_FNS,
                                                 CLASSIFIERS["num_classes"]))]
    rolls = torch.as_tensor(make_rolls(2, seed=4))
    rules = pipeline.extract_targets_from_rolls([r for _, r, _ in COND_FNS], rolls)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 4, 128, 16), generator=gen)
    t = torch.tensor([120.0, 743.0])
    grads = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            models = [copy.deepcopy(c).to(device) for c in cpu_models]
            cond_fn = make_grad_cond_fn([
                CondFnSpec(fn=fn, rule_name=rule, scale=scale, classifier=c)
                for (fn, rule, scale), c in zip(COND_FNS, models)])
            reset_counts(fa, gn)
            with torch.no_grad():
                grads[device] = cond_fn(x.to(device), t.to(device),
                                        {k: v.to(device) for k, v in rules.items()})
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
    scale = grads["cpu"].abs().max().item()
    err = (grads["cuda"].cpu() - grads["cpu"]).abs().max().item() / scale
    print(f"classifier cond_fn gradient, card vs CPU (tiny classifiers, fp32): "
          f"max abs error over the largest gradient ({scale:.4g}) {err:.2e} "
          f"(tol {COND_GRAD_TOL:.0e}) {'ok' if err <= COND_GRAD_TOL else 'FAIL'}")
    if not err <= COND_GRAD_TOL:
        raise AssertionError("classifier gradient: card disagrees with the CPU")
    check_launches(launches, {"flash_attention": 0,
                              "flash_attention_fp32": 2 * len(cpu_models),
                              "groupnorm_swish": 0})


def serving_config(name, record=False):
    """(timestep_respacing, SamplerConfig) of one serving YAML."""
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)

    respacing, fields = SERVING[name]
    fields = dict(fields)
    if "guidance" in fields:
        fields["guidance"] = GuidanceConfig(**fields["guidance"])
    if "scg" in fields:
        fields["scg"] = SCGConfig(**fields["scg"])
    return respacing, SamplerConfig(record=record, **fields)


def build_scoring(torch, pipeline):
    """The real ch=64 scoring decoder and rule-feature head from assets/,
    through ScoringBundle.create, and a seeded random DiTRotary_B_8 rollout
    (its distilled weights are not in the repo), all bf16."""
    scoring = pipeline.ScoringBundle.create(
        **{k: os.path.join(REPO, v) for k, v in SCORING_ASSETS.items()},
        dtype=torch.bfloat16, device="cuda")
    print("WARNING: no DiTRotary_B_8 rollout weights in the repo: the rollout "
          "denoiser has seeded random weights (seed 2)")
    rollout = pipeline.create_denoiser("DiTRotary_B_8", model_path="",
                                       dtype=torch.float32, device="cuda")
    pipeline.randomize_(rollout, seed=2)
    scoring.rollout = rollout.to(torch.bfloat16).requires_grad_(False)
    return scoring


def norm_calls(module):
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    return sum(isinstance(x, FusedNormSwish) for x in module.modules())


def serving_counts(config, steps, dit, scoring, vae, final_decode):
    """(trajectory calls, guided steps, predicted launches) of one serving
    chain: a trajectory DiT call on every refresh step (every step without
    reuse), a rollout, a head and one scoring decode on every guided step,
    and the full decoder's final decode where the caller makes one."""
    from rule_guided_music_tpu_torch.diffusion.guidance import guide_schedule_mask

    reuse = int(config.reuse_interval or 0)
    traj = sum(reuse <= 1 or pos % reuse == 0
               or (config.reuse_t_max >= 0 and t >= config.reuse_t_max)
               for pos, t in enumerate(range(steps - 1, config.t_end - 1, -1)))
    guided = 0
    if config.scg is not None:
        g = config.guidance
        guided = sum(guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
                     and t > config.t_end for t in range(steps))
    attention = traj * len(dit.blocks)
    gn_calls = norm_calls(vae) if final_decode else 0
    if guided:
        attention += guided * len(scoring.rollout.blocks)
        gn_calls += guided * norm_calls(scoring.decoder)
    return traj, guided, {"attention": attention, "groupnorm_swish": gn_calls}


def serving_path(torch, port, m, scoring, name):
    """One serving YAML at full width: a short warm-up chain, then the
    YAML's chain with every count set to 0 just before it and read just
    after its final decode; ms per step and per guided step, excerpts per
    minute, peak memory beside the preflight's estimate, launches against
    the shapes, and a per-component breakdown with CUDA events."""
    from rule_guided_music_tpu_torch.diffusion.latent import latent_to_chunks
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT, LOSS_DICT

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    dit, vae, rules, y, shape = m["dit"], m["vae"], m["rules"], m["y"], m["shape"]
    batch = shape[0]
    respacing, config = serving_config(name, record=True)
    tables = make_schedule("linear", 1000, respacing).tables("cuda")
    run = dict(y=y, scoring=scoring)

    t0 = time.perf_counter()
    warm = make_schedule("linear", 1000, "4").tables("cuda")
    pipeline.decode_rolls(vae, pipeline.generate(
        dit, vae, warm, config, shape, rules, **run,
        generator=torch.Generator(device="cuda").manual_seed(1))[0])
    torch.cuda.synchronize()
    print(f"warm-up chain (4 steps): {time.perf_counter() - t0:.3f} s")
    estimate = pipeline.preflight(dit, vae, config, shape, scoring=scoring,
                                  device="cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)

    reset_counts(fa, gn)
    t0 = time.perf_counter()
    latents, records = pipeline.generate(dit, vae, tables, config, shape,
                                         rules, **run, generator=gen)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    rolls_out = pipeline.decode_rolls(vae, latents)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts(fa, gn)

    steps = tables.num_timesteps
    traj, guided, predicted = serving_counts(config, steps, dit, scoring, vae,
                                             final_decode=True)
    print(f"steps {steps} ({respacing}), trajectory DiT calls {traj}, guided "
          f"{guided}; chain {chain_s:.3f} s, {1e3 * chain_s / steps:.2f} ms per "
          f"step" + (f", {1e3 * chain_s / guided:.2f} ms per guided step"
                     if guided else "")
          + f"; with the final decode {total_s:.3f} s, "
          f"{60 * batch / total_s:.2f} excerpts per minute at B={batch}")
    peak = torch.cuda.max_memory_allocated()
    est = (f"{estimate['total'] / 2**30:.2f} GiB (" + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in estimate.items() if k != "total")
        + ")") if estimate else "none (no SCG decode to estimate)"
    print(f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"preflight estimate {est}")
    check_launches(launches, {"flash_attention": predicted["attention"],
                              "flash_attention_fp32": 0,
                              "groupnorm_swish": predicted["groupnorm_swish"]})
    if guided:
        sel = records["selected"]
        searched = int((sel >= 0).sum())
        print(f"selected candidate per example on {searched // batch} steps "
              f"(prefilter top {config.scg.prefilter} of "
              f"{config.scg.num_samples}); loss/* of the best at the last "
              f"guided step: " + ", ".join(
                  f"{k[5:]} {v[-2].item():.4g}" for k, v in records.items()
                  if k.startswith("loss/")))
        if searched != guided * batch:
            raise AssertionError("the SCG search did not run on every guided step")
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError("latents: wrong shape or not finite")
    if (tuple(rolls_out.shape) != (batch, 3, 128, 1024)
            or not torch.isfinite(rolls_out).all()):
        raise AssertionError("decoded rolls: wrong shape or not finite")

    x_b = torch.randn(shape, device="cuda")
    t_b = torch.full((batch,), 500.0, device="cuda")
    parts = {f"trajectory DiT call, XL_8 (B={batch})": lambda: dit(x_b, t_b, y)}
    if guided:
        k, mm = config.scg.num_samples, config.scg.prefilter
        x_kb = torch.randn((k * batch,) + shape[1:], device="cuda")
        t_kb = torch.full((k * batch,), 500.0, device="cuda")
        y_kb = torch.full((k * batch,), 1, dtype=torch.long, device="cuda")
        chunks = latent_to_chunks(x_kb[:mm * batch])
        decoded = torch.rand((mm * batch, 3, 128, 1024), device="cuda") * 2 - 1
        parts.update({
            f"rollout DiT call, B_8 (k*B={k * batch})":
                lambda: scoring.rollout(x_kb, t_kb, y_kb),
            f"feature head (k*B={k * batch})":
                lambda: scoring.feature_head.features(x_kb),
            f"top-m decode, ch=64 ScoringDecoder ({mm * batch * 8} chunks)":
                lambda: scoring.decoder.decode(chunks),
            f"rules + losses ({mm * batch} rolls)": lambda: [
                LOSS_DICT[n](FUNC_DICT[n](decoded), rules[n].repeat(mm, 1))
                for n in rules],
        })
    with torch.inference_mode():
        for label, fn in parts.items():
            print(f"breakdown {label}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")
    return launches


def serving_card_vs_cpu(torch, port):
    """The sde_feat_pre4_roll_light chain on the light-scoring fixtures
    (quality_tiny trajectory DiT, light_gate_tiny decoder, head and
    rollout) for 6 SDE-DPM-Solver++ steps at k=4, B=2, with prefilter 2 so
    that the head's top-m cut runs, on the card and on the CPU with the
    same noise, fp32 without TF32."""
    import numpy as np

    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    quality = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    gate = os.path.join(REPO, "tests", "fixtures", "light_gate_tiny.npz")
    scale = float(np.load(quality)["scale_factor"])
    steps, shape = 6, (2, 4, 128, 16)
    _, config = serving_config("scg_sde20_pre4", record=True)
    config = replace(config, scg=replace(config.scg, num_samples=4, prefilter=2))
    noise_fn_for = replay_noise(torch, 11)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                           model_path=quality,
                                           dtype=torch.float32, device=device)
            scoring = pipeline.ScoringBundle.create(
                decoder_path=gate, features_path=gate, rollout="DiTRotary_XS_8",
                rollout_path=gate, num_classes=0, dtype=torch.float32,
                device=device)
            tables = make_schedule("linear", 1000, str(steps)).tables(device)
            rolls = torch.as_tensor(make_rolls(2, seed=21), device=device)
            rules = pipeline.extract_targets_from_rolls(
                [n for n, _ in SCG_WEIGHTS], rolls)
            reset_counts(fa, gn)
            lat, rec = pipeline.generate(dit, None, tables, config, shape, rules,
                                         noise_fn=noise_fn_for(device),
                                         scoring=scoring, num_classes=0,
                                         scale_factor=scale)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
                predicted = serving_counts(config, steps, dit, scoring, None,
                                           final_decode=False)[2]
            out[device] = (lat.cpu(), rec["selected"].cpu())
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    same = torch.equal(out["cpu"][1], out["cuda"][1])
    print(f"light-scoring fixtures, SDE-DPM-Solver++ {steps} steps, k=4, "
          f"prefilter 2: selected indices equal {same} "
          f"({out["cuda"][1].flatten().tolist()}); final latents max_abs_err "
          f"{err:.3e} (tol {SERVING_AGREE_TOL:.0e})")
    if not same or err > SERVING_AGREE_TOL:
        raise AssertionError("serving chain: card disagrees with the CPU")
    check_launches(launches, {"flash_attention": 0,
                              "flash_attention_fp32": predicted["attention"],
                              "groupnorm_swish": predicted["groupnorm_swish"]})


def check_launches(launches, expected):
    for name in expected:
        print(f"launches {name}: {launches[name]} (expected {expected[name]})")
        if launches[name] != expected[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {expected[name]}")


def small_input_agreement(torch, port):
    """The card path (kernels) against the CPU path (plain versions) on the
    committed tiny fixture, with the same noise, in fp32 without TF32."""
    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    fixture = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    arch = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    config = SamplerConfig(guidance=GuidanceConfig(schedule=True),
                           scg=SCGConfig(num_samples=4, weights=SCG_WEIGHTS),
                           record=True)
    shape = (2, 4, 128, 16)
    noise_fn_for = replay_noise(torch, 3)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                           model_path=fixture,
                                           dtype=torch.float32, device=device)
            vae = pipeline.create_vae(fixture, arch=arch, dtype=torch.float32,
                                      device=device)
            tables = make_schedule("linear", 1000, "6").tables(device)
            rolls = torch.as_tensor(make_rolls(2, seed=21), device=device)
            rules = pipeline.extract_targets_from_rolls(
                [n for n, _ in SCG_WEIGHTS], rolls)
            reset_counts(fa, gn)
            lat, rec = pipeline.generate(dit, vae, tables, config, shape, rules,
                                         noise_fn=noise_fn_for(device),
                                         num_classes=0, scale_factor=1.0)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
                predicted = expected_launches(dit, vae, tables, config,
                                              final_decode=False)[2]
            out[device] = (lat.cpu(), rec["candidate_log_prob"].argmax(1).cpu())
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    same = torch.equal(out["cpu"][1], out["cuda"][1])
    print(f"tiny fixture, 6 steps, k=4: selected indices equal {same}; "
          f"final latents max_abs_err {err:.3e} (tol 1e-3)")
    if not same or err > 1e-3:
        raise AssertionError("card path disagrees with the CPU path")
    # fp32 weights: every attention call takes the fp32 SIMT kernel
    check_launches(launches, {"flash_attention": 0,
                              "flash_attention_fp32": predicted["attention"],
                              "groupnorm_swish": predicted["groupnorm_swish"]})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F
    from rule_guided_music_tpu_torch import pipeline
    from rule_guided_music_tpu_torch.ops import flash_attention as fa
    from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn

    port = {"pipeline": pipeline, "fa": fa, "gn": gn}
    t_all = time.perf_counter()
    with phase("device"):
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{name}, device count {count}")
        print(smi[0] if smi else "nvidia-smi: no output")

    with phase("build"):
        # one nvcc per source, both started together
        with ThreadPoolExecutor(max_workers=2) as pool:
            for job in [pool.submit(fa._load), pool.submit(gn._load)]:
                job.result()
        for label, mod in (("flash_attention", fa), ("groupnorm_swish", gn)):
            print(f"nvcc {label}.cu: {mod.build_result.seconds:.2f} s")
            for line in mod.build_result.log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")
        hmma = count_sass(fa.build_result.path, "HMMA")
        print(f"cuobjdump -sass flash_attention: {hmma} HMMA (tensor-core mma) "
              f"instructions")
        if hmma == 0:
            raise AssertionError("the bf16 attention kernel has no HMMA instruction")

    with phase("kernel checks"):
        attn = check_attention(torch, fa, F)
        attn_cls = check_attention_grad(torch, fa, F)
        attn_roll = check_attention_rollout(torch, fa, F)
        # the ch=64 decoder alone: the serving bundle is built after the
        # SCG and flagship paths, whose peak memory it would otherwise hold
        decoder = pipeline.ScoringBundle.create(
            decoder_path=os.path.join(REPO, SCORING_ASSETS["decoder_path"]),
            dtype=torch.bfloat16, device="cuda").decoder
        gn_scoring = check_scoring_decode(torch, gn, decoder)
        del decoder
        torch.cuda.empty_cache()
        attn_src = dict(route="cuda",
                        source="rule_guided_music_tpu_torch/csrc/flash_attention.cu",
                        replaces="rule_guided_music_tpu/ops/pallas_attention.py:90")
        kernels = [
            dict(name="flash_attention", **attn_src, **attn["flash_attention"],
                 at_classifier_shape=attn_cls, at_rollout_shape=attn_roll),
            dict(name="flash_attention_fp32", **attn_src,
                 **attn["flash_attention_fp32"]),
            dict(name="groupnorm_swish", route="cuda",
                 source="rule_guided_music_tpu_torch/csrc/groupnorm_swish.cu",
                 replaces="rule_guided_music_tpu/ops/pallas_groupnorm.py:117",
                 **check_groupnorm(torch, gn), at_scoring_decode=gn_scoring),
        ]

    models = build_main_models(torch, pipeline)
    with phase("main path: DiTRotary_XL_8 + KL-VAE SCG, 10 steps, k=16, B=2"):
        scg_launches, scg_step_ms = main_path(torch, port, models)

    with phase("main path with classifier guidance: DiTRotary_XL_8 + 3 "
               "DiTRotary-S/8 classifiers + KL-VAE SCG, 10 steps, k=16, B=2"):
        cls_launches = classifier_path(torch, port, models, scg_step_ms)

    scoring = build_scoring(torch, pipeline)
    serving_launches = {}
    for yaml_name in SERVING:
        respacing, _ = serving_config(yaml_name)
        with phase(f"serving: scripts/configs_serving/{yaml_name}.yml, "
                   f"DiTRotary_XL_8 + KL-VAE, ch=64 scoring decoder + feature "
                   f"head, B_8 rollout, {respacing}, B=2"):
            serving_launches[yaml_name] = serving_path(torch, port, models,
                                                       scoring, yaml_name)
    del models, scoring
    torch.cuda.empty_cache()

    with phase("small-input agreement: card vs CPU"):
        fp32_launches = small_input_agreement(torch, port)
        cond_fn_card_vs_cpu(torch, port)
        serving_card_vs_cpu(torch, port)

    # the bf16 kernels' launches are the flagship path's (each path's too);
    # the fp32 attention kernel's are those of the fp32 fixture run, the
    # path that takes it
    for k in kernels:
        if k["name"] == "flash_attention_fp32":
            k["launches"] = fp32_launches[k["name"]]
            k["launched_in"] = "card-vs-CPU fixture run, fp32"
        else:
            k["launches"] = cls_launches[k["name"]]
            k["launched_in"] = "main path with classifier guidance, bf16"
            k["launches_by_path"] = {"scg": scg_launches[k["name"]],
                                     "classifier_guidance": cls_launches[k["name"]],
                                     **{n: v[k["name"]]
                                        for n, v in serving_launches.items()}}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launched_in", "launches_by_path", "at_classifier_shape",
            "at_rollout_shape", "at_scoring_decode"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
