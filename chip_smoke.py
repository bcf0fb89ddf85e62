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

Each phase prints its wall seconds. The line before the last is a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX and no PyYAML.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
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
    cpu_gen = torch.Generator().manual_seed(3)
    draws = {}

    def noise_fn_for(device):
        def noise(kind, step, shp):
            key = (kind, step)
            if key not in draws:
                draws[key] = torch.randn(shp, generator=cpu_gen)
            return draws[key].to(device)
        return noise

    out = {}
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
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
        attn_src = dict(route="cuda",
                        source="rule_guided_music_tpu_torch/csrc/flash_attention.cu",
                        replaces="rule_guided_music_tpu/ops/pallas_attention.py:90")
        kernels = [
            dict(name="flash_attention", **attn_src, **attn["flash_attention"],
                 at_classifier_shape=attn_cls),
            dict(name="flash_attention_fp32", **attn_src,
                 **attn["flash_attention_fp32"]),
            dict(name="groupnorm_swish", route="cuda",
                 source="rule_guided_music_tpu_torch/csrc/groupnorm_swish.cu",
                 replaces="rule_guided_music_tpu/ops/pallas_groupnorm.py:117",
                 **check_groupnorm(torch, gn)),
        ]

    models = build_main_models(torch, pipeline)
    with phase("main path: DiTRotary_XL_8 + KL-VAE SCG, 10 steps, k=16, B=2"):
        scg_launches, scg_step_ms = main_path(torch, port, models)

    with phase("main path with classifier guidance: DiTRotary_XL_8 + 3 "
               "DiTRotary-S/8 classifiers + KL-VAE SCG, 10 steps, k=16, B=2"):
        cls_launches = classifier_path(torch, port, models, scg_step_ms)
    del models
    torch.cuda.empty_cache()

    with phase("small-input agreement: card vs CPU"):
        fp32_launches = small_input_agreement(torch, port)
        cond_fn_card_vs_cpu(torch, port)

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
                                     "classifier_guidance": cls_launches[k["name"]]}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launched_in", "launches_by_path", "at_classifier_shape"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
