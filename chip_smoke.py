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

Test-set targets, excerpt editing and DPS: kernel 2 is checked and timed
on every call of one production-encoder encode of 16 chunks (21 calls),
and both kernels where a gradient is wanted (kernel 2 at the decoder's 29
call shapes on 16 chunks, kernel 1 at the DiT's (2,256,16,72); each
backward replays the plain version's VJP), forward + backward timed
beside the plain versions'. It writes a test set of seeded uint8 rolls
(``<prefix>_test_cls_1.csv``) to a temporary directory and drives, at full
width with launch checks: scripts/configs/edit/nd_scg_given_target.yml
(the source encoded by the production encoder, SCG k=4 on the slice
[32, 64), a DDPM chain respaced to 100 steps entered at step 50; the
pinned latents kept, the slice moved), single/dps_rule/pitch.yml and
all/scg_dps_nn_all.yml on 10-step chains (gradients through XL_8, and
the decoder or three DiTRotary-S/8 classifiers; a breakdown of the
gradient's parts), and the flagship YAML through ``sample_rule.main``
with ``--data_dir`` (as JSON: the card has no PyYAML); then an edit chain
and a DPS-rule chain on quality_tiny on the card and on the CPU.

Long-form generation and the remaining sampling entry points, after every
earlier path: kernel 1 at the stitched rollout's shapes ((64,128,16,72)
for the half windows of 64 latent columns, (64,256,16,72) for the full
ones) in both dtypes and its gradient at the EDM ring's (4,256,16,72),
kernel 2 on every call of one decode of two 20.48 s latents (32 chunks);
then, with launch checks: scripts/configs/cond_demo/demo1.yml at full
width (XL_8 stitched over a DiffCollage circle, SCG k=16 per 16-column
window, three seeded random DiTRotary-S/8 classifiers, 10 steps, states
recorded and written by ``sample_rule.save_record``, a breakdown of the
guided step), an EDM Heun chain with the circle-loss worker around
``vp_eps_fn_from_model(XL_8)`` on a ring of 4 windows, demo2 and demo3
through ``sample_rule.main``, ``diffcollage_sample`` (its default circle
of three images, 20.48 s; linear; circle with CFG), ``cfg_sample`` (DDIM,
DPM-Solver++) and ``classifier_sample``; and, card against CPU on
quality_tiny, the stitched eps, a stitched chain with SCG per window and
the EDM worker with a Heun chain.

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

# attention gradients, (B, N, H, D): the classifiers' blocks, the XL DiT's
# rollout batch, and the XL DiT at B=2, which DPS differentiates
GRAD_SHAPES = [(2, 257, 6, 64), (32, 256, 16, 72), (2, 256, 16, 72)]
# max abs difference of dq, dk, dv from autograd through the plain version,
# over the largest gradient: the backward replays that plain version on the
# same inputs, so fp32 allows summation order only; bf16 allows the final
# rounding of each gradient to bf16 (2^-8 relative) plus as much again
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the composite classifier gradient, card (fp32 kernel forward, no TF32)
# against CPU, over its largest magnitude: the forward's summation order
# (<= 1.7e-6 on attention outputs), carried through two blocks and a head
COND_GRAD_TOL = 1e-4


# the YAMLs of this slice's paths, as yaml.safe_load reads them (the card
# has no PyYAML; tests/test_torch_dps.py holds each tree against its file)
_TARGETS_ALL = {"pitch_hist": None, "vertical_nd": None, "horizontal_nd": None,
                "chord_progression": None}
_CLASSIFIERS = {"num_classes": [12, 16, 8], **{
    k: v for k, v in CLASSIFIERS.items() if k != "num_classes"}}
_SAMPLING = {"use_ddim": False, "diff_collage": False, "t_end": 0}
_SCHEDULE = {"schedule": True, "t_start": 750, "t_end": 0, "interval": 1}
_SCG_ALL = {"num_samples": 16, "pitch_hist": 40.0, "note_density": 1.0,
            "chord_progression": 1.0}
YAML_TREES = {
    "edit/nd_scg_given_target.yml": {
        "target_rules": {"vertical_nd": [3.0, 3.0], "horizontal_nd": [10.0, 10.0]},
        "guidance": {"vae": True, "nn": False, "scg": True,
                     "method": "no_guidance", "cond_fn": None, **_SCHEDULE},
        "scg": {"num_samples": 4}, "sampling": _SAMPLING,
        "edit": {"source": "dataset", "noise_level": 500, "l_start": 32,
                 "l_end": 64}},
    "cond_table/single/dps_rule/pitch.yml": {
        "target_rules": {"pitch_hist": None},
        "guidance": {"vae": True, "nn": False, "scg": False, "method": "dps",
                     "schedule": False, "step_size": 1.0, "cond_fn": {
                         "rule_names": ["pitch_hist"],
                         "fns": ["rule_x0_mse_dummy"],
                         "classifier_scales": [1.0]}},
        "sampling": _SAMPLING},
    "cond_table/all/scg_dps_nn_all.yml": {
        "target_rules": _TARGETS_ALL,
        "guidance": {"vae": True, "nn": True, "scg": True, "method": "dps",
                     "step_size": 1.0, "cond_fn": {
                         "rule_names": ["pitch_hist", "note_density",
                                        "chord_progression"],
                         "fns": ["nn_z0_mse_dummy", "nn_z0_mse_dummy",
                                 "nn_z0_chord_dummy"],
                         "classifier_scales": [40.0, 1.0, 1.0],
                         "classifiers": _CLASSIFIERS}, **_SCHEDULE},
        "scg": _SCG_ALL, "sampling": _SAMPLING},
    "cond_table/all/scg_classifier_all.yml": {
        "target_rules": _TARGETS_ALL,
        "guidance": {"vae": True, "nn": True, "scg": True,
                     "method": "classifier_guidance", "cond_fn": {
                         "rule_names": ["pitch_hist", "note_density",
                                        "chord_progression"],
                         "fns": ["grad_nn_zt_mse", "grad_nn_zt_mse",
                                 "grad_nn_zt_chord"],
                         "classifier_scales": [400, 10.0, 10.0],
                         "classifiers": _CLASSIFIERS}, **_SCHEDULE},
        "scg": _SCG_ALL, "sampling": _SAMPLING},
}
# the long-form demos (scripts/configs/cond_demo): a DiffCollage circle of
# one image (128 latent columns stitched from two 128-column windows over
# the wrapped latent), SCG per dc.base window in demo1 (16) and demo2 (128)
_DEMO_GUIDANCE = {"vae": True, **_SCHEDULE}
_DEMO_SAMPLING = {"use_ddim": False, "diff_collage": True, "t_end": 0}
_DEMO_DC = {"type": "circle", "overlap_size": 64, "num_img": 1}
_PITCH_DEMO = [0.5, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0]
YAML_TREES.update({
    "cond_demo/demo1.yml": {
        "target_rules": {"pitch_hist": _PITCH_DEMO,
                         "vertical_nd": [1.0, 1.0, 2.0, 3.0, 3.0, 2.0, 1.0, 1.0],
                         "horizontal_nd": [5.0, 5.0, 10.0, 15.0, 15.0, 10.0,
                                           5.0, 5.0],
                         "chord_progression": [1, 1, 1, 1, 5, 5, 5, 5]},
        "guidance": {"nn": True, "scg": True, "method": "classifier_guidance",
                     "cond_fn": {
                         "rule_names": ["pitch_hist", "note_density",
                                        "chord_progression"],
                         "fns": ["grad_nn_zt_mse", "grad_nn_zt_mse",
                                 "grad_nn_zt_chord"],
                         "classifier_scales": [400, 10.0, 20.0],
                         "classifiers": _CLASSIFIERS},
                     **_DEMO_GUIDANCE, "dc": {"base": 16}},
        "scg": {"num_samples": 16, "pitch_hist": 40.0, "note_density": 1.0,
                "chord_progression": 2.0},
        "sampling": _DEMO_SAMPLING, "dc": {**_DEMO_DC, "base": 16}},
    "cond_demo/demo2.yml": {
        "target_rules": {"pitch_hist": _PITCH_DEMO, "vertical_nd": [3.0] * 8,
                         "horizontal_nd": [15.0] * 8},
        "guidance": {"nn": False, "scg": True, "method": "no_guidance",
                     "cond_fn": None, **_DEMO_GUIDANCE, "dc": {"base": 128}},
        "scg": {"num_samples": 16, "pitch_hist": 100.0, "note_density": 1.0},
        "sampling": _DEMO_SAMPLING, "dc": _DEMO_DC},
    "cond_demo/demo3.yml": {
        "target_rules": {"pitch_hist": [0.4, 0.0, 0.0, 0.4, 0.0, 0.0, 0.0, 0.2,
                                        0.0, 0.0, 0.0, 0.0],
                         "vertical_nd": [1.0, 1.0, 2.0, 3.0, 3.0, 2.0, 1.0, 1.0],
                         "horizontal_nd": [15.0, 10.0, 10.0, 5.0, 5.0, 10.0,
                                           10.0, 15.0]},
        "guidance": {"nn": True, "scg": True, "method": "classifier_guidance",
                     "cond_fn": {
                         "rule_names": ["pitch_hist", "note_density"],
                         "fns": ["grad_nn_zt_mse", "grad_nn_zt_mse"],
                         "classifier_scales": [400, 10.0],
                         "classifiers": {
                             k: v[:2] for k, v in _CLASSIFIERS.items()}},
                     **_DEMO_GUIDANCE},
        "scg": {"num_samples": 16, "pitch_hist": 40.0, "note_density": 1.0},
        "sampling": _DEMO_SAMPLING, "dc": _DEMO_DC},
})
# kernel 1 at the long-form shapes: demo1's stitched rollout (k*B*n = 64
# windows) at the full windows' 256 tokens and the half windows' 128
LONG_ATTN_SHAPES = [(64, 128, 16, 72), (64, 256, 16, 72)]
# the EDM circle-loss worker differentiates XL_8 on a ring of 4 windows
EDM_GRAD_SHAPE = (4, 256, 16, 72)
# diffcollage_sample's final decode: two 20.48 s latents of 16 chunks each
LONG_DECODE_CHUNKS = 32
# the cuts: the demos on a 10-step respaced DDPM chain (the YAMLs run
# DDPM-1000); diffcollage_sample and cfg_sample on 25-step chains (both
# default to 1000 steps); classifier_sample on 10; 6 EDM Heun steps
DEMO_RESPACING, SAMPLE_RESPACING, CLASSIFIER_RESPACING = "10", "25", "10"
EDM_STEPS = 6
# card vs CPU on quality_tiny, fp32 without TF32: the stitched eps, the
# windowed chain's and the EDM chain's final latents, and the EDM worker's
# output, within this much of their largest magnitude (the models'
# summation order, which the edit and DPS chain checks saw at 1.0-6.1e-6)
LONGFORM_AGREE_TOL = 1e-5
# the EDM Heun chain's final latents, card against CPU, on four draws: a
# 4-step chain carries a 5e-7 relative change of the denoiser's output
# (what the card's summation order gives the worker's output) to
# 1.1e-5-3.4e-5 of its final latents, so the chain is held to 1e-4 and
# the worker's output alone to 1e-5; the witness in the same run: the
# chain's worst card-vs-CPU difference is at most EDM_WITNESS_RATIO times
# the worst that moving the DiT's output by the worker's measured
# difference gives
EDM_CHAIN_AGREE_TOL = 1e-4
EDM_SEEDS = (21, 23, 25, 27)
EDM_WITNESS_RATIO = 3.0
# the edit path's cut: a DDPM chain respaced to 100 steps (the YAML runs
# DDPM-1000) entered at step 50 (the YAML's noise_level 500 of 1000)
EDIT_RESPACING, EDIT_NOISE_LEVEL = "100", 50
# the DPS paths: a 10-step respaced chain (the YAMLs run DDPM-1000)
DPS_RESPACING = "10"
ENCODE_CHUNKS = 16   # B * 8 chunks: one encode, or one decode, at B=2
# the card-vs-CPU chains on quality_tiny, fp32 without TF32: final latents
# within this much of the largest latent (the models' summation order,
# carried through the chain as in the fixture checks above)
EDIT_DPS_AGREE_TOL = 1e-3


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
    """Kernel 1 at the B_8 rollout's shape, bf16."""
    return check_attention_at(torch, fa, F, ROLLOUT_ATTN_SHAPE, "rollout shape",
                              (torch.bfloat16,), seed=8)


def check_attention_at(torch, fa, F, shape, label, dtypes, seed):
    """Kernel 1 at ``shape`` in each of ``dtypes``: contiguous and on views
    of one qkv tensor, against the plain version; then its bf16 time beside
    the plain version, SDPA and the bound."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for dtype in dtypes:
        dname = str(dtype).split(".")[-1]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype)
        for layout, (qq, kk, vv) in (("contiguous", (q, k, v)),
                                     ("qkv views", qkv.unbind(2))):
            out = fa.flash_attention(qq, kk, vv)
            ref = fa.flash_attention_reference(qq.float(), kk.float(), vv.float())
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ok = err <= ATTN_TOL[dname]
            print(f"attention {shape} {dname} {layout} ({label}): max_abs_err "
                  f"{err:.3e} (tol {ATTN_TOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {shape} {dname} {layout}: "
                                     f"{err}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
        del q, k, v, qkv, out, ref
    # timed in bf16 whatever order ``dtypes`` came in
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    nbytes, ops = 4 * b * n * h * d * 2, 4 * b * h * n * n * d
    bnd = bound_ms(nbytes, ops, "bfloat16")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["bfloat16"]
          else "operations")
    print(f"attention {shape} bf16, the {label}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of the bound")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, shape=f"{shape} bf16, one launch")


def capture_norm_inputs(torch, gn, module, run):
    """The input and module of every FusedNormSwish call in ``module``
    while ``run()`` runs (no gradient), and the kernel's launches in that
    run as its wrapper counts them."""
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].detach().clone(), mod)))
        for m in module.modules() if isinstance(m, FusedNormSwish)]
    gn.launches = 0
    with torch.no_grad():
        run()
    for hk in hooks:
        hk.remove()
    torch.cuda.synchronize()
    return calls, gn.launches


def check_norm_calls(torch, gn, calls, label, launches):
    """Kernel 2 on every captured call of one decode or encode (``launches``
    of the kernel in that run): each call
    held against the plain version in fp32 on its own input (bf16, at the
    real activations' tolerance), then the calls timed (kernel, plain,
    library) beside the bound of the bytes they must move."""
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
    n = calls[0][0].shape[0]
    spans = ", ".join(
        f"({c},{hw},{hw}) x{k}: span {(c // 32) * hw * hw * 2 // 1024} KB, "
        f"cluster of {gn.plan_slices((c // 32) * hw * hw, 2)[0]}"
        for (c, hw), k in geoms.items())
    print(f"groupnorm_swish on {label}, {len(calls)} calls on {n} chunks: "
          f"{spans}; max_abs_err {worst:.3e} (tol {TOL['bfloat16']:.0e} + "
          f"2^-8 |y|; worst margin {-excess:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"groupnorm_swish on {label}: {worst}")

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
    print(f"groupnorm_swish, {label} of {n} chunks ({len(calls)} calls) bf16: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, F.group_norm+F.silu "
          f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of "
          f"the bound")
    for (c, hw), k in geoms.items():
        x, mod = next((x, m) for x, m in calls if x.shape[1:3] == (c, hw))
        one = cuda_time_ms(lambda: gn.groupnorm_swish(x, mod.weight, mod.bias,
                                                      mod.num_groups, 1e-6),
                           reps=10, warmup=2)
        bnd_one = bound_ms(2 * x.numel() * 2, 10 * x.numel(), "float32")
        print(f"  ({n},{c},{hw},{hw}) bf16, {k} per call of the module: "
              f"{one:.4f} ms per call, bound {bnd_one:.4f} ms, "
              f"{100 * bnd_one / one:.1f}% of the bound")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, launches_per_call=launches,
                shape=f"{label} of {n} chunks ({len(calls)} calls), bf16")


def check_scoring_decode(torch, gn, decoder):
    """Kernel 2 on one decode of 64 chunks through the ch=64 ScoringDecoder
    (the real asset, bf16), on the inputs it gives its 29 calls."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    z = torch.randn((SCORING_DECODE_CHUNKS, 4, 16, 16), generator=gen,
                    device="cuda")
    calls, launches = capture_norm_inputs(torch, gn, decoder,
                                          lambda: decoder.decode(z))
    return check_norm_calls(torch, gn, calls, "one ch=64 ScoringDecoder decode",
                            launches)


def check_encoder(torch, gn, vae):
    """Kernel 2 on one encode of B*8 = 16 chunks through the production
    encoder (ch 128, ch_mult (1,2,2,4), seeded random weights, bf16) of
    rolls shaped as the test set's: its 21 calls, checked and timed."""
    from rule_guided_music_tpu_torch.diffusion.latent import pixels_to_chunks
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    rolls = torch.as_tensor(make_rolls(ENCODE_CHUNKS // 8, seed=12), device="cuda")
    chunks = pixels_to_chunks(rolls)
    calls, launches = capture_norm_inputs(torch, gn, vae.encoder,
                                          lambda: vae.encode_moments(chunks))
    if len(calls) != 21 or launches != 21:
        raise AssertionError(f"encoder: {len(calls)} GroupNorm+swish calls and "
                             f"{launches} launches, expected 21 of each")
    return check_norm_calls(torch, gn, calls, "one production-encoder encode",
                            launches)


def check_gn_backward(torch, gn, vae):
    """Kernel 2 where a gradient is wanted (DPS through the decoder): at
    each of the 29 call shapes of one production decode of 16 chunks, the
    gradient with respect to x through the kernel's autograd Function (its
    backward replays the plain VJP in x's dtype, as the JAX package's
    _fgs_bwd does) against autograd through the plain version on the same
    bf16 inputs; then forward + backward of the 29 calls timed beside the
    plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    z = torch.randn((ENCODE_CHUNKS, 4, 16, 16), generator=gen, device="cuda")
    calls, _ = capture_norm_inputs(torch, gn, vae.decoder, lambda: vae.decode(z))
    worst = 0.0
    for x, mod in calls:
        leaf = x.detach().requires_grad_()
        cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        out = gn.groupnorm_swish(leaf, mod.weight, mod.bias, mod.num_groups, 1e-6)
        if out.grad_fn is None:
            raise AssertionError("groupnorm_swish: no grad_fn where a gradient "
                                 "is wanted")
        got = torch.autograd.grad(out, leaf, cot)[0].float()
        want = torch.autograd.grad(gn.groupnorm_swish_reference(
            leaf, mod.weight, mod.bias, mod.num_groups, 1e-6), leaf, cot)[0].float()
        worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
    ok = worst <= GRAD_TOL["bfloat16"]
    print(f"groupnorm_swish gradient at the decoder's {len(calls)} call shapes "
          f"({ENCODE_CHUNKS} chunks, bf16): max abs error over the largest "
          f"gradient {worst:.2e} (tol {GRAD_TOL['bfloat16']:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("groupnorm_swish gradient disagrees with the plain "
                             "version's")
    leaves = [(x.detach().requires_grad_(), mod,
               torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype))
              for x, mod in calls]

    def fwd_bwd(fn):
        return lambda: [torch.autograd.grad(
            fn(x, mod.weight, mod.bias, mod.num_groups), x, cot)
            for x, mod, cot in leaves]

    ms = cuda_time_ms(fwd_bwd(gn.groupnorm_swish), reps=3, warmup=1)
    plain = cuda_time_ms(fwd_bwd(gn.groupnorm_swish_reference), reps=3, warmup=1)
    elems = sum(x.numel() for x, _ in calls)
    # forward: x in, y out; backward: x and dy in, dx out
    nbytes, ops = 5 * elems * 2, 30 * elems
    bnd = bound_ms(nbytes, ops, "float32")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["float32"]
          else "operations")
    print(f"groupnorm_swish forward + backward, one decode of {ENCODE_CHUNKS} "
          f"chunks ({len(calls)} calls) bf16: kernel forward + replayed plain "
          f"backward {ms:.4f} ms, plain forward + backward {plain:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of the bound")
    return dict(max_rel_err=worst, fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=plain,
                shape=f"the decoder's {len(calls)} calls on {ENCODE_CHUNKS} "
                      f"chunks, bf16, forward + backward")


def check_attention_grad(torch, fa, F):
    """dq, dk, dv through the kernel's autograd Function against autograd
    through the plain version, on the same card tensors (views of one qkv
    tensor, as the DiT passes them); then the classifier shape's forward
    and forward + backward times."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in GRAD_SHAPES:
        check_attention_grad_at(torch, fa, gen, shape)
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
    cls = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
               library_ms=lib, fwd_bwd_ms=fwd_bwd, plain_fwd_bwd_ms=plain_fwd_bwd,
               shape=f"{shape} bf16, one launch")

    # the XL DiT at B=2, as DPS differentiates it: forward + backward
    dit = time_attention_fwd_bwd(torch, fa, F, gen, GRAD_SHAPES[2],
                                 "the DiT at B=2 (DPS)")
    return cls, dit


def check_attention_grad_at(torch, fa, gen, shape):
    """dq, dk, dv through the kernel's autograd Function at ``shape`` in
    both dtypes, on views of one qkv tensor, against autograd through the
    plain version."""
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
    return max(errs)


def time_attention_fwd_bwd(torch, fa, F, gen, shape, label):
    """Kernel 1's forward + replayed plain backward at ``shape`` in bf16,
    beside the plain version's and SDPA's forward + backward and the
    bound."""
    b, n, h, d = shape
    leaves = [torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention(*leaves), leaves, cot))
    plain_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention_reference(*leaves), leaves, cot))
    lib_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves)),
        leaves, cot.transpose(1, 2)))
    # forward: q, k, v in, o out; backward: q, k, v, o, do in, dq, dk, dv
    # out; operations: QK^T and PV forward, four products backward
    nbytes, ops = 12 * b * n * h * d * 2, 10 * b * h * n * n * d
    bnd = bound_ms(nbytes, ops, "bfloat16")
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["bfloat16"]
          else "operations")
    print(f"attention {shape} bf16, {label}: kernel forward + "
          f"replayed plain backward {fwd_bwd:.4f} ms, plain forward + backward "
          f"{plain_fwd_bwd:.4f} ms, F.scaled_dot_product_attention forward + "
          f"backward {lib_fwd_bwd:.4f} ms, bound {bnd:.5f} ms ({by}), "
          f"{100 * bnd / fwd_bwd:.1f}% of the bound")
    return dict(fwd_bwd_ms=fwd_bwd, plain_fwd_bwd_ms=plain_fwd_bwd,
                library_ms=lib_fwd_bwd, bound_ms=bnd, bound_by=by,
                shape=f"{shape} bf16, forward + backward")


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
    norm_calls = sum(isinstance(m, FusedNormSwish) for m in vae.decoder.modules())
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
    """GroupNorm+swish calls per call of ``module`` (a decoder or encoder)."""
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
    gn_calls = norm_calls(vae.decoder) if final_decode else 0
    if guided:
        attention += guided * len(scoring.rollout.blocks)
        gn_calls += guided * norm_calls(scoring.decoder.decoder)
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


def build_encoder_vae(torch, pipeline):
    """The production KL-VAE with its encoder (built on request: the
    decode-only paths keep theirs), seeded random weights, bf16."""
    return pipeline.randomize_(pipeline.create_vae(
        encoder=True, dtype=torch.float32), seed=3).to(torch.bfloat16)


def write_test_set(prefix, n=4, seed=31):
    """A test set as ``--data_dir`` names it: ``<prefix>_test_cls_1.csv``
    listing ``n`` seeded uint8 rolls (.npy, 1100 columns)."""
    import csv

    import numpy as np

    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    rows = []
    for i, roll in enumerate(make_rolls(n, length=1100, seed=seed)):
        path = f"{prefix}_roll{i}.npy"
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, 1])
    with open(f"{prefix}_test_cls_1.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return prefix


def yaml_config(name, **edit):
    """The stated tree of a YAML as the port's loader reads it; ``edit``
    overrides fields of its ``edit:`` block."""
    import copy

    from rule_guided_music_tpu_torch.config import dict_to_obj

    tree = copy.deepcopy(YAML_TREES[name])
    tree.get("edit", {}).update(edit)
    return dict_to_obj(tree)


def measured_chain(torch, port, run, warm):
    """``warm()``, then ``run()`` with every count set to 0 just before it
    and read just after; returns (its result, wall s, launches, peak GiB)."""
    fa, gn = port["fa"], port["gn"]
    t0 = time.perf_counter()
    warm()
    torch.cuda.synchronize()
    print(f"warm-up (first launches, cuDNN plans): "
          f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    return out, wall, launches, torch.cuda.max_memory_allocated() / 2**30


def n_guided(config, steps):
    from rule_guided_music_tpu_torch.diffusion.guidance import guide_schedule_mask

    g = config.guidance
    return sum(guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
               and t > config.t_end for t in range(steps))


def edit_path(torch, port, m, vae, prefix):
    """scripts/configs/edit/nd_scg_given_target.yml at full width: the
    source is one batch of the written test set (augmented, as the edit
    CLI loads it), encoded by the production encoder; SCG k=4 on the
    editable slice [32, 64) of a DDPM chain respaced to 100 steps and
    entered at step 50 (the cut: EDIT_RESPACING, EDIT_NOISE_LEVEL)."""
    import numpy as np

    from rule_guided_music_tpu_torch.config import sampler_config_from_yaml
    from rule_guided_music_tpu_torch.data.datasets import load_data
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.edit import resolve_edit_targets

    pipeline = port["pipeline"]
    dit, y, shape = m["dit"], m["y"], m["shape"]
    config = yaml_config("edit/nd_scg_given_target.yml",
                         noise_level=EDIT_NOISE_LEVEL)
    ed = config.edit
    gt, _ = next(load_data(data_dir=f"{prefix}_test_cls_1.csv",
                           batch_size=shape[0], class_cond=True, image_size=1024))
    gt = torch.as_tensor(gt, device="cuda")
    cols = slice(ed.l_start * 8, ed.l_end * 8)
    rules = resolve_edit_targets(config, gt[..., cols], shape[0],
                                 np.random.default_rng(0))
    sc = sampler_config_from_yaml(config, rule_names=list(rules), record=True)
    tables = make_schedule("linear", 1000, EDIT_RESPACING).tables("cuda")

    def chain(sc):
        gt_latent = pipeline.encode_rolls(vae, gt)
        mask = torch.ones_like(gt_latent)
        mask[:, :, ed.l_start:ed.l_end, :] = 0.0
        latents, rec = pipeline.generate(
            dit, vae, tables, sc, shape, rules, y=y, edit_gt=gt_latent,
            edit_mask=mask, generator=torch.Generator(device="cuda").manual_seed(0))
        return gt_latent, latents, rec, pipeline.decode_rolls(vae, latents)

    warm = replace(sc, edit=replace(sc.edit, noise_level=3))
    (gt_latent, latents, rec, rolls), wall, launches, peak = measured_chain(
        torch, port, lambda: chain(sc), lambda: chain(warm))
    nl = sc.edit.noise_level
    guided = n_guided(sc, nl)
    encode_ms = cuda_time_ms(lambda: pipeline.encode_rolls(vae, gt), reps=3,
                             warmup=1)
    print(f"edit chain: {tables.num_timesteps}-step DDPM entered at step {nl}, "
          f"{guided} guided steps (SCG k={sc.scg.num_samples} on latent columns "
          f"[{ed.l_start}, {ed.l_end})); encode + chain + final decode "
          f"{wall:.3f} s, {1e3 * wall / guided:.1f} ms per guided step; one "
          f"encode of {ENCODE_CHUNKS} chunks {encode_ms:.2f} ms (CUDA events)")
    est = pipeline.preflight(dit, vae, sc, shape)["total"] / 2**30
    print(f"peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"preflight estimate {est:.2f} GiB")
    check_launches(launches, {
        "flash_attention": len(dit.blocks) * (nl + guided),
        "flash_attention_fp32": 0,
        "groupnorm_swish": norm_calls(vae.encoder)
        + norm_calls(vae.decoder) * (guided + 1)})
    pinned = torch.ones(shape[2], dtype=torch.bool, device="cuda")
    pinned[ed.l_start:ed.l_end] = False
    scale = gt_latent.abs().max().item()
    kept = (latents[:, :, pinned] - gt_latent[:, :, pinned]).abs().max().item()
    moved = (latents[:, :, ~pinned] - gt_latent[:, :, ~pinned]).abs().mean().item()
    ok = kept <= 1e-3 * scale and moved > 1e-2 * scale
    print(f"pinned latents: max |latents - encoded gt| {kept:.3e} (tol 1e-3 x "
          f"max|gt| = {1e-3 * scale:.3e}); editable slice: mean |latents - gt| "
          f"{moved:.3e} (must exceed 1e-2 x max|gt|) {'ok' if ok else 'FAIL'}")
    searched = int((rec["selected"] >= 0).sum())
    if not ok or searched != guided * shape[0]:
        raise AssertionError("edit chain: pinned region lost, slice unmoved, or "
                             "the SCG search missed a guided step")
    if (tuple(rolls.shape) != (shape[0], 3, 128, 1024)
            or not torch.isfinite(rolls).all()):
        raise AssertionError("edit chain: decoded rolls wrong or not finite")
    return launches


def dps_path(torch, port, m, name):
    """A DPS YAML at full width on a 10-step respaced DDPM chain (B=2,
    XL_8 + production decoder, seeded random weights; the classifiers of
    scg_dps_nn_all.yml seeded random too): ms per step, peak memory,
    launches against the shapes, and a breakdown of the gradient's parts
    with CUDA events."""
    from rule_guided_music_tpu_torch.config import sampler_config_from_yaml
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.sample_rule import classifier_metas_from_config

    pipeline = port["pipeline"]
    dit, vae, y, shape = m["dit"], m["vae"], m["y"], m["shape"]
    config = yaml_config(name)
    names = [n.replace("vertical_nd", "note_density")
             for n in vars(config.target_rules) if n != "horizontal_nd"]
    rules = {n: m["rules"][n] for n in names}
    sc = sampler_config_from_yaml(config, rule_names=names, record=True)
    metas = classifier_metas_from_config(config.guidance, input_size=(128, 16),
                                         in_channels=4, dtype=torch.bfloat16,
                                         device="cuda")
    tables = make_schedule("linear", 1000, DPS_RESPACING).tables("cuda")
    warm_tables = make_schedule("linear", 1000, "2").tables("cuda")

    def chain(tables):
        latents, rec = pipeline.generate(
            dit, vae, tables, sc, shape, rules, y=y, classifier_metas=metas,
            use_decode=config.guidance.vae,
            generator=torch.Generator(device="cuda").manual_seed(0))
        return latents, rec, pipeline.decode_rolls(vae, latents)

    (latents, rec, rolls), wall, launches, peak = measured_chain(
        torch, port, lambda: chain(tables), lambda: chain(warm_tables))
    steps = tables.num_timesteps
    guided = n_guided(sc, steps) if sc.scg is not None else 0
    estimate = pipeline.preflight(dit, vae, sc, shape,
                                  classifier_metas=metas)
    print(f"{name}: {steps} steps, a DPS step on each, SCG on {guided}; chain "
          f"+ final decode {wall:.3f} s, {1e3 * wall / steps:.1f} ms per step")
    print(f"peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
          "preflight estimate " + (f"{estimate['total'] / 2**30:.2f} GiB"
                                   if estimate else
                                   "none (the formula covers SCG decodes only)"))
    cls_blocks = sum(len(x.model.blocks) for x in metas if x.model is not None)
    dps_decodes = 0 if config.guidance.nn else steps
    check_launches(launches, {
        "flash_attention": len(dit.blocks) * (2 * steps + guided)
        + cls_blocks * steps,
        "flash_attention_fp32": 0,
        "groupnorm_swish": norm_calls(vae.decoder) * (dps_decodes + guided + 1)})
    norms = rec["guidance_grad_norm"].float().cpu()
    print("DPS gradient L2 norm per step (after the 1/sqrt(-log p) scale): "
          + " ".join(f"{v:.4g}" for v in norms.tolist()))
    if (not torch.isfinite(latents).all() or not torch.isfinite(rolls).all()
            or not (norms > 0).all() or not torch.isfinite(norms).all()):
        raise AssertionError(f"{name}: non-finite output or a zero DPS gradient")
    if guided and int((rec["selected"] >= 0).sum()) != guided * shape[0]:
        raise AssertionError(f"{name}: the SCG search missed a guided step")

    # the gradient's parts, forward + backward, B=2 (CUDA events)
    b = shape[0]
    x_b = torch.randn(shape, device="cuda", requires_grad=True)
    t_b = torch.full((b,), 500.0, device="cuda")
    cot = torch.randn(shape, device="cuda")
    z = torch.randn((ENCODE_CHUNKS, 4, 16, 16), device="cuda", requires_grad=True)
    cot_z = torch.randn((ENCODE_CHUNKS, 3, 128, 128), device="cuda")
    parts = {f"denoiser XL_8 forward + backward (B={b})":
             lambda: torch.autograd.grad(dit(x_b, t_b, y), x_b, cot)}
    if not config.guidance.nn:
        parts[f"decoder forward + backward ({ENCODE_CHUNKS} chunks)"] = (
            lambda: torch.autograd.grad(vae.decode(z), z, cot_z))
    for label, fn in parts.items():
        print(f"breakdown {label}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")
    return launches


def test_set_cli_path(torch, port, prefix, tmp):
    """The flagship YAML through the CLI, ``sample_rule.main``, with its
    targets measured on the written test set (--data_dir): XL_8 at its
    initialisation and the production decoder, bf16, B=2, a 10-step chain.
    The YAML goes in as JSON (the card has no PyYAML; the loader reads
    JSON without it)."""
    import csv

    from rule_guided_music_tpu_torch import sample_rule
    from rule_guided_music_tpu_torch.data.datasets import load_data
    from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT

    config = os.path.join(tmp, "scg_classifier_all.json")
    with open(config, "w") as f:
        json.dump(YAML_TREES["cond_table/all/scg_classifier_all.yml"], f)
    out = os.path.join(tmp, "cli_out")
    argv = lambda steps, out: [
        "--config_path", config, "--data_dir", prefix, "--batch_size", "2",
        "--num_samples", "2", "--timestep_respacing", steps, "--out_dir", out]
    rows, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_rule.main(argv("10", out)),
        lambda: sample_rule.main(argv("2", out + "_warm")))
    print(f"sample_rule.main, scg_classifier_all with --data_dir: {wall:.3f} s "
          f"for one batch of 2 (model building included), peak {peak:.2f} GiB")
    check_launches(launches, {"flash_attention": 28 * (10 + 9) + 3 * 12 * 10,
                              "flash_attention_fp32": 0,
                              "groupnorm_swish": 29 * (9 + 1)})
    gt, _ = next(load_data(data_dir=f"{prefix}_test_cls_1.csv", batch_size=2,
                           class_cond=True, image_size=1024))
    gt = torch.as_tensor(gt, device="cuda")
    for name in ("pitch_hist", "note_density", "chord_progression"):
        want = FUNC_DICT[name](gt).float().cpu()
        got = torch.tensor([r[f"{name}.target_rule"] for r in rows]).float()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"--data_dir targets of {name} differ from the "
                                 f"test set's first batch")
    with open(os.path.join(out, "results.csv")) as f:
        n_rows = len(list(csv.DictReader(f)))
    if n_rows != 2 or not os.path.exists(os.path.join(out, "summary.csv")):
        raise AssertionError("the CLI did not write results.csv and summary.csv")
    print(f"targets equal the rules of the test set's first batch; "
          f"results.csv ({n_rows} rows) and summary.csv written")
    return launches


def edit_dps_card_vs_cpu(torch, port):
    """On quality_tiny (trained XS DiT + ch-32 VAE with its encoder), fp32
    without TF32, with the same noise on both devices: a 6-step edit chain
    with SCG k=4 on [32, 64) entered at step 5 (the same selections, the
    encoded gt and the final latents within EDIT_DPS_AGREE_TOL of their
    largest magnitude), and a 6-step DPS-rule chain (dps_rule/pitch.yml:
    the per-step DPS gradient norms and the final latents within the same
    relative tolerance)."""
    import numpy as np

    from rule_guided_music_tpu_torch.config import (EditConfig, GuidanceConfig,
                                                    SCGConfig, SamplerConfig,
                                                    sampler_config_from_yaml)
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.sample_rule import classifier_metas_from_config
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    fixture = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    scale = float(np.load(fixture)["scale_factor"])
    arch = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    steps, shape, l_start, l_end = 6, (2, 4, 128, 16), 32, 64
    edit_cfg = SamplerConfig(
        guidance=GuidanceConfig(schedule=True), record=True,
        scg=SCGConfig(num_samples=4, weights=SCG_WEIGHTS),
        edit=EditConfig(noise_level=5, l_start=l_start, l_end=l_end))
    dps_yaml = yaml_config("cond_table/single/dps_rule/pitch.yml")
    dps_cfg = sampler_config_from_yaml(dps_yaml, rule_names=["pitch_hist"],
                                       record=True)
    gt_rolls = make_rolls(2, seed=11)
    src = make_rolls(3, seed=21)[1:]
    out, launches = {}, {}
    noise_for = {"edit": replay_noise(torch, 14), "dps": replay_noise(torch, 15)}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                           model_path=fixture,
                                           dtype=torch.float32, device=device)
            vae = pipeline.create_vae(fixture, arch=arch, encoder=True,
                                      dtype=torch.float32, device=device)
            tables = make_schedule("linear", 1000, str(steps)).tables(device)
            reset_counts(fa, gn)
            gt = pipeline.encode_rolls(vae, torch.as_tensor(gt_rolls, device=device),
                                       scale)
            mask = torch.ones_like(gt)
            mask[:, :, l_start:l_end, :] = 0.0
            rules = pipeline.extract_targets_from_rolls(
                [n for n, _ in SCG_WEIGHTS],
                torch.as_tensor(src[..., l_start * 8:l_end * 8], device=device))
            lat, rec = pipeline.generate(dit, vae, tables, edit_cfg, shape, rules,
                                         noise_fn=noise_for["edit"](device),
                                         num_classes=0, scale_factor=scale,
                                         edit_gt=gt, edit_mask=mask)
            if device == "cuda":
                torch.cuda.synchronize()
                launches["edit"] = read_counts(fa, gn)
            out["edit", device] = (gt.cpu(), lat.cpu(), rec["selected"].cpu())

            metas = classifier_metas_from_config(
                dps_yaml.guidance, input_size=(128, 16), in_channels=4,
                dtype=torch.float32, device=device)
            rules = pipeline.extract_targets_from_rolls(
                ["pitch_hist"], torch.as_tensor(src, device=device))
            reset_counts(fa, gn)
            lat, rec = pipeline.generate(dit, vae, tables, dps_cfg, shape, rules,
                                         classifier_metas=metas,
                                         noise_fn=noise_for["dps"](device),
                                         num_classes=0, scale_factor=scale)
            if device == "cuda":
                torch.cuda.synchronize()
                launches["dps"] = read_counts(fa, gn)
                enc_calls, dec_calls = norm_calls(vae.encoder), norm_calls(vae.decoder)
            out["dps", device] = (lat.cpu(), rec["guidance_grad_norm"].cpu())

    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    gt_err = rel(out["edit", "cuda"][0], out["edit", "cpu"][0])
    lat_err = rel(out["edit", "cuda"][1], out["edit", "cpu"][1])
    same = torch.equal(out["edit", "cuda"][2], out["edit", "cpu"][2])
    print(f"quality_tiny edit chain, 6 steps entered at 5, SCG k=4 on [32, 64): "
          f"selected indices equal {same}; encoded gt max error over its "
          f"largest value {gt_err:.3e}, final latents {lat_err:.3e} (tol "
          f"{EDIT_DPS_AGREE_TOL:.0e})")
    dps_err = rel(out["dps", "cuda"][0], out["dps", "cpu"][0])
    norm_err = rel(out["dps", "cuda"][1], out["dps", "cpu"][1])
    print(f"quality_tiny DPS-rule chain (dps_rule/pitch.yml), 6 steps: DPS "
          f"gradient norms per step, card "
          + " ".join(f"{v:.5g}" for v in out["dps", "cuda"][1].tolist())
          + f", max error over the largest {norm_err:.3e}; final latents "
          f"{dps_err:.3e} (tol {EDIT_DPS_AGREE_TOL:.0e})")
    if (not same or max(gt_err, lat_err, dps_err, norm_err) > EDIT_DPS_AGREE_TOL):
        raise AssertionError("edit or DPS chain: card disagrees with the CPU")
    # fp32 weights: every attention call takes the fp32 SIMT kernel
    check_launches(launches["edit"], {
        "flash_attention": 0, "flash_attention_fp32": 2 * (5 + 4),
        "groupnorm_swish": enc_calls + dec_calls * 4})
    check_launches(launches["dps"], {
        "flash_attention": 0, "flash_attention_fp32": 2 * 2 * steps,
        "groupnorm_swish": dec_calls * steps})


def check_long_kernels(torch, fa, gn, F, vae):
    """Both kernels at the shapes the long-form paths give them: kernel 1
    at the stitched rollout's (64,128,16,72) and (64,256,16,72) in both
    dtypes (timed in bf16), its gradient and forward + backward at the EDM
    ring's (4,256,16,72); kernel 2 on every call of one decode of two
    20.48 s latents (32 chunks, the production decoder)."""
    from rule_guided_music_tpu_torch.diffusion.latent import latent_to_chunks

    out = {}
    for shape, key, label in (
            (LONG_ATTN_SHAPES[0], "at_half_window",
             "stitched rollout's half windows"),
            (LONG_ATTN_SHAPES[1], "at_stitched_rollout",
             "stitched rollout's full windows")):
        out[key] = check_attention_at(torch, fa, F, shape, label,
                                      (torch.float32, torch.bfloat16), seed=16)
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(17)
    grad_err = check_attention_grad_at(torch, fa, gen, EDM_GRAD_SHAPE)
    out["fwd_bwd_at_edm_ring"] = dict(
        max_rel_err=grad_err, **time_attention_fwd_bwd(
            torch, fa, F, gen, EDM_GRAD_SHAPE, "the EDM ring of 4 windows"))
    z = torch.randn((LONG_DECODE_CHUNKS // 16, 4, 256, 16), generator=gen,
                    device="cuda")
    calls, launches = capture_norm_inputs(
        torch, gn, vae.decoder, lambda: vae.decode(latent_to_chunks(z)))
    if len(calls) != norm_calls(vae.decoder) or launches != len(calls):
        raise AssertionError(f"long decode: {len(calls)} calls, {launches} "
                             f"launches, expected {norm_calls(vae.decoder)} "
                             f"of each")
    out["at_long_decode"] = check_norm_calls(
        torch, gn, calls, "one decode of two 20.48 s latents", launches)
    return out


def demo_rules(config, batch):
    """The demo's given targets, note density merged, on the card."""
    from rule_guided_music_tpu_torch import pipeline

    return pipeline.resolve_given_targets(vars(config.target_rules), batch,
                                          device="cuda")


def demo1_path(torch, port, m, tmp):
    """scripts/configs/cond_demo/demo1.yml at full width on a 10-step
    respaced DDPM chain (B=2): XL_8 stitched over the two windows of a
    circle of one image (overlap 64), SCG k=16 per 16-column window, three
    seeded random DiTRotary-S/8 classifiers on the whole latent; states
    recorded, then written by ``sample_rule.save_record`` (record.pkl and
    six decoded states)."""
    import pickle

    from rule_guided_music_tpu_torch.config import (collage_from_config,
                                                    sampler_config_from_yaml)
    from rule_guided_music_tpu_torch.diffusion.collage import make_cond_ind_eps_fn
    from rule_guided_music_tpu_torch.diffusion.guidance import (
        CondFnSpec, make_grad_cond_fn, make_model_fn)
    from rule_guided_music_tpu_torch.diffusion.sampling import _scg_select_windowed
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.sample_rule import (
        classifier_metas_from_config, save_record)

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    dit, vae, y = m["dit"], m["vae"], m["y"]
    config = yaml_config("cond_demo/demo1.yml")
    batch = y.shape[0]
    rules = demo_rules(config, batch)
    sc = sampler_config_from_yaml(config, rule_names=list(rules), record=True,
                                  record_states=True)
    collage, shape = collage_from_config(config, batch)
    metas = classifier_metas_from_config(config.guidance, input_size=(128, 16),
                                         in_channels=4, dtype=torch.bfloat16,
                                         device="cuda")
    tables = make_schedule("linear", 1000, DEMO_RESPACING).tables("cuda")
    warm_tables = make_schedule("linear", 1000, "2").tables("cuda")

    def chain(tables):
        latents, rec = pipeline.generate(
            dit, vae, tables, sc, shape, rules, y=y, classifier_metas=metas,
            collage=collage, generator=torch.Generator(device="cuda").manual_seed(0))
        return latents, rec, pipeline.decode_rolls(vae, latents)

    (latents, rec, rolls), wall, launches, peak = measured_chain(
        torch, port, lambda: chain(tables), lambda: chain(warm_tables))
    steps = tables.num_timesteps
    guided = n_guided(sc, steps)
    n_win = shape[2] // sc.scg.dc_base
    estimate = pipeline.preflight(dit, vae, sc, shape, classifier_metas=metas)
    print(f"demo1: {steps} steps, {guided} guided, {n_win} SCG windows of "
          f"{sc.scg.dc_base} columns; chain + final decode {wall:.3f} s, "
          f"{1e3 * wall / guided:.1f} ms per guided step")
    print(f"peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"preflight estimate {estimate['total'] / 2**30:.2f} GiB (its formula "
          f"counts no windows)")
    cls_blocks = sum(len(x.model.blocks) for x in metas)
    # two stitched calls (full and half windows) per trajectory step and
    # per rollout, the classifiers on every step, a decode per guided step
    check_launches(launches, {
        "flash_attention": len(dit.blocks) * 2 * (steps + guided)
        + cls_blocks * steps,
        "flash_attention_fp32": 0,
        "groupnorm_swish": norm_calls(vae.decoder) * (guided + 1)})
    sel = rec["selected"]
    if (tuple(sel.shape) != (steps, n_win, batch) or not (sel[:guided] >= 0).all()
            or not (sel[guided:] == -1).all()):
        raise AssertionError(f"demo1: per-window selections {tuple(sel.shape)}")
    picks = sel[:guided].cpu()
    print(f"windows whose pick differs from window 0's, per guided step: "
          + " ".join(str(int((p != p[:1]).any(1).sum())) for p in picks))
    if not torch.isfinite(latents).all() or not torch.isfinite(rolls).all():
        raise AssertionError("demo1: non-finite output")

    # the record writer of --record_states (its plots need matplotlib)
    reset_counts(fa, gn)
    rec_np, states = save_record(rec, os.path.join(tmp, "demo1_record"), vae, 1.0)
    torch.cuda.synchronize()
    record_launches = read_counts(fa, gn)
    with open(os.path.join(tmp, "demo1_record", "record.pkl"), "rb") as f:
        keys = sorted(pickle.load(f))
    print(f"record.pkl: {keys}; decoded states at steps {sorted(states)}, "
          f"each {states[next(iter(states))].shape}")
    check_launches(record_launches, {"groupnorm_swish": norm_calls(vae.decoder)})
    if "state" in keys or len(states) != 6 or keys != sorted(rec_np):
        raise AssertionError("record_states: record.pkl or the states are wrong")

    # a guided step's parts (CUDA events)
    k = sc.scg.num_samples
    stitched = make_cond_ind_eps_fn(make_model_fn(dit, 3), **collage)
    t_b = torch.full((batch,), 500.0, device="cuda")
    x_b = torch.randn(shape, device="cuda")
    x_kb = torch.randn((k * batch,) + shape[1:], device="cuda")
    t_kb, y_kb = t_b.repeat(k), y.repeat(k)
    cond_fn = make_grad_cond_fn([CondFnSpec(fn=x.fn, rule_name=x.rule_name,
                                            scale=x.scale, classifier=x.model)
                                 for x in metas])
    chunks = torch.randn((k * batch * 8, 4, 16, 16), device="cuda")
    decoded = torch.rand((k * batch, 3, 128, 1024), device="cuda") * 2 - 1
    cands = torch.randn((k,) + shape, device="cuda")
    with torch.no_grad():
        parts = {
            f"stitched trajectory call (B={batch}: {2 * batch} windows of 256 "
            f"tokens, {2 * batch} of 128)": lambda: stitched(x_b, t_b, y),
            f"stitched rollout call (k*B={k * batch}: {2 * k * batch} + "
            f"{2 * k * batch} windows)": lambda: stitched(x_kb, t_kb, y_kb),
            f"cond_fn (3 classifiers, forward + backward, B={batch})":
                lambda: cond_fn(x_b, t_b, rules),
            f"VAE decode ({k * batch * 8} chunks)": lambda: vae.decode(chunks),
            f"windowed rules + argmax ({n_win} windows, {k * batch} rolls)":
                lambda: _scg_select_windowed(sc, rules, decoded, cands, k, batch),
        }
        for name, fn in parts.items():
            print(f"breakdown {name}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")
    return launches


def demo_cli_path(torch, port, name, tmp):
    """A long-form demo through ``sample_rule.main`` (the YAML as JSON: the
    card has no PyYAML), XL_8 at its initialisation and the production
    decoder, bf16, B=2, a 10-step chain: launches against the shapes, the
    result files, ms per guided step (models built inside)."""
    import csv

    from rule_guided_music_tpu_torch import sample_rule
    from rule_guided_music_tpu_torch.config import sampler_config_from_yaml

    pipeline = port["pipeline"]
    config = os.path.join(tmp, f"{name}.json")
    with open(config, "w") as f:
        json.dump(YAML_TREES[f"cond_demo/{name}.yml"], f)
    out = os.path.join(tmp, name)
    argv = lambda steps, out: [
        "--config_path", config, "--batch_size", "2", "--num_samples", "2",
        "--timestep_respacing", steps, "--out_dir", out]
    # the CLI's own preflight estimate, read as generate makes it
    estimates, preflight = [], pipeline.preflight
    pipeline.preflight = lambda *a, **kw: estimates.append(preflight(*a, **kw)) \
        or estimates[-1]
    try:
        rows, wall, launches, peak = measured_chain(
            torch, port, lambda: sample_rule.main(argv(DEMO_RESPACING, out)),
            lambda: sample_rule.main(argv("2", out + "_warm")))
    finally:
        pipeline.preflight = preflight
    tree = yaml_config(f"cond_demo/{name}.yml")
    rules = demo_rules(tree, 2)
    sc = sampler_config_from_yaml(tree, rule_names=list(rules))
    steps = int(DEMO_RESPACING)
    guided = n_guided(sc, steps)
    n_cls = len(tree.guidance.cond_fn.fns) if tree.guidance.cond_fn else 0
    print(f"sample_rule.main on {name}: {wall:.3f} s for one batch of 2 "
          f"(models built inside), {1e3 * wall / guided:.1f} ms per guided "
          f"step at most; peak {peak:.2f} GiB (preflight estimate "
          f"{estimates[-1]['total'] / 2**30:.2f} GiB); SCG windows of "
          f"{sc.scg.dc_base or 128} columns, {n_cls} classifiers")
    check_launches(launches, {
        "flash_attention": 28 * 2 * (steps + guided) + 12 * n_cls * steps,
        "flash_attention_fp32": 0, "groupnorm_swish": 29 * (guided + 1)})
    with open(os.path.join(out, "results.csv")) as f:
        n_rows = len(list(csv.DictReader(f)))
    midis = [x for x in os.listdir(out) if x.endswith(".midi")]
    if n_rows != 2 or len(midis) != 2 or not os.path.exists(
            os.path.join(out, "summary.csv")):
        raise AssertionError(f"{name}: results.csv, summary.csv or MIDI missing")
    return launches


def sample_cli_path(torch, port, label, module, flags, respacing, tmp, n_files,
                    seconds, cls_blocks=0):
    """One of the sampling CLIs (diffcollage_sample, cfg_sample,
    classifier_sample) at full width: XL_8 at its initialisation and the
    production decoder, bf16, warmed on a 2-step chain, then measured:
    launches (one DiT call per step, two where the score is stitched;
    the classifier's blocks per step; one final decode), the MIDI files
    and their length."""
    from rule_guided_music_tpu_torch.data.midi_io import read_midi
    from rule_guided_music_tpu_torch.data.pianoroll import midi_to_roll

    out = os.path.join(tmp, label)
    argv = lambda r, out: [*flags, "--timestep_respacing", r, "--out_dir", out]
    warm = "ddim2" if respacing.startswith("ddim") else "2"
    _, wall, launches, peak = measured_chain(
        torch, port, lambda: module.main(argv(respacing, out)),
        lambda: module.main(argv(warm, out + "_warm")))
    steps = int(respacing.removeprefix("ddim"))
    stitched = module.__name__.endswith("diffcollage_sample")
    print(f"{module.__name__} {label}: {wall:.3f} s for {steps} steps "
          f"(models built inside), {1e3 * wall / steps:.1f} ms per step at "
          f"most; peak {peak:.2f} GiB; preflight estimate none (no SCG decode)")
    check_launches(launches, {
        "flash_attention": 28 * (2 if stitched else 1) * steps
        + cls_blocks * steps,
        "flash_attention_fp32": 0, "groupnorm_swish": 29})
    midis = sorted(x for x in os.listdir(out) if x.endswith(".midi"))
    cols = [midi_to_roll(read_midi(os.path.join(out, x))).shape[-1] for x in midis]
    print(f"MIDI files {midis}, roll columns {cols} (at most {int(seconds * 100)})")
    if len(midis) != n_files or max(cols) > seconds * 100:
        raise AssertionError(f"{label}: {len(midis)} MIDI files, columns {cols}")
    return launches


def diffcollage_breakdown(torch, m):
    """diffcollage_sample's step (CUDA events): one stitched call over the
    default circle of three images (4 windows per sample, B=2), without
    and with CFG (both halves in each window call)."""
    from rule_guided_music_tpu_torch.diffusion.collage import (
        circle_length, make_cond_ind_eps_fn)
    from rule_guided_music_tpu_torch.diffusion.guidance import make_model_fn

    dit, y = m["dit"], m["y"]
    x = torch.randn((2, 4, circle_length(3, 64), 16), device="cuda")
    t = torch.full((2,), 500.0, device="cuda")
    with torch.no_grad():
        for cfg in (False, True):
            fn = make_cond_ind_eps_fn(make_model_fn(dit, 3, cfg=cfg, w=4.0), 3,
                                      64, circle=True)
            ms = cuda_time_ms(lambda: fn(x, t, y), reps=3, warmup=1)
            print(f"breakdown stitched call, circle of 3 images, B=2"
                  f"{', CFG' if cfg else ''} ({8 * (1 + cfg)} windows of 256 "
                  f"tokens, {8 * (1 + cfg)} of 128): {ms:.2f} ms")


def edm_path(torch, port, m):
    """An EDM Heun chain at full width: XL_8 (seeded random weights, bf16)
    as a VP denoiser driven in sigma space (``vp_eps_fn_from_model``),
    corrected by the circle-loss worker on a ring of 4 windows (a forward
    and a backward through XL_8 per eps call), EDM_STEPS Heun steps; the
    ring merged into one 20.48 s circle and decoded."""
    from rule_guided_music_tpu_torch.diffusion.collage import (
        circle_merge_batch, make_circle_loss_eps_fn)
    from rule_guided_music_tpu_torch.diffusion.edm import (heun_sample_loop,
                                                           vp_eps_fn_from_model)
    from rule_guided_music_tpu_torch.diffusion.guidance import make_model_fn
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule

    pipeline = port["pipeline"]
    dit, vae = m["dit"], m["vae"]
    ring = (4, 4, 128, 16)
    tables = make_schedule("linear", 1000).tables("cuda")
    y4 = torch.full((4,), 1, dtype=torch.long, device="cuda")
    vp = vp_eps_fn_from_model(tables, make_model_fn(dit, 3), y=y4)
    worker = make_circle_loss_eps_fn(lambda x, s, y=None: vp(x, s), 64)

    def chain(steps):
        with torch.no_grad():
            x = heun_sample_loop(lambda x, s: worker(x, s), ring, num_steps=steps,
                                 generator=torch.Generator(device="cuda")
                                 .manual_seed(2), device="cuda")
            long = circle_merge_batch(x, 64)
            return x, long, pipeline.decode_rolls(vae, long)

    (x, long, rolls), wall, launches, peak = measured_chain(
        torch, port, lambda: chain(EDM_STEPS), lambda: chain(2))
    calls = 2 * EDM_STEPS - 1
    print(f"EDM Heun, circle-loss worker on a ring of 4 windows: {EDM_STEPS} "
          f"steps, {calls} worker calls, chain + decode {wall:.3f} s, "
          f"{1e3 * wall / EDM_STEPS:.1f} ms per Heun step; peak {peak:.2f} GiB "
          f"(no preflight: no SCG decode); merged latent {tuple(long.shape)}")
    # each worker call: one forward launch per block (the backward replays
    # the plain version); one decode of the merged circle
    check_launches(launches, {"flash_attention": len(dit.blocks) * calls,
                              "flash_attention_fp32": 0,
                              "groupnorm_swish": norm_calls(vae.decoder)})
    if (tuple(long.shape) != (1, 4, 256, 16) or tuple(rolls.shape) != (1, 3, 128, 2048)
            or not torch.isfinite(x).all() or not torch.isfinite(rolls).all()):
        raise AssertionError("EDM chain: wrong shape or non-finite output")
    xr = torch.randn(ring, device="cuda")
    sig = torch.full((4,), 2.0, device="cuda")
    with torch.no_grad():
        for label, fn in (("circle-loss worker call (XL_8 forward + backward, "
                           "B=4)", lambda: worker(xr, sig)),
                          ("plain VP eps call (XL_8 forward, B=4)",
                           lambda: vp(xr, sig))):
            print(f"breakdown {label}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")
    return launches


def tiny_models(torch, pipeline, device):
    fixture = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                   model_path=fixture, dtype=torch.float32,
                                   device=device)
    vae = pipeline.create_vae(fixture, arch=dict(ch=32, ch_mult=(1, 1, 2, 2),
                                                 num_res_blocks=1),
                              dtype=torch.float32, device=device)
    return dit, vae


def stitched_eps_card_vs_cpu(torch, port):
    """The stitched score of quality_tiny's XS DiT over diffcollage_sample's
    circle (three images, overlap 64: full and half windows), fp32 without
    TF32, card against CPU; returns the error over the largest value."""
    from rule_guided_music_tpu_torch.diffusion.collage import make_cond_ind_eps_fn

    gen = torch.Generator().manual_seed(18)
    x = torch.randn((2, 4, 256, 16), generator=gen)
    t = torch.tensor([120.0, 870.0])
    out = {}
    with no_tf32(torch), torch.no_grad():
        for device in ("cpu", "cuda"):
            dit, _ = tiny_models(torch, port["pipeline"], device)
            fn = make_cond_ind_eps_fn(lambda a, s, y=None: dit(a, s), 3, 64,
                                      circle=True)
            out[device] = fn(x.to(device), t.to(device)).cpu()
    err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
    print(f"quality_tiny stitched eps, circle of 3 images: max error over the "
          f"largest value {err:.3e} (tol {LONGFORM_AGREE_TOL:.0e})")
    if err > LONGFORM_AGREE_TOL:
        raise AssertionError("stitched eps: card disagrees with the CPU")
    return err


def longform_card_vs_cpu(torch, port):
    """A 6-step stitched chain on quality_tiny (circle of three images, 256
    columns, B=2), SCG k=4 per 16-column window, fp32 without TF32, the
    same noise on both devices: the same pick in every window at every
    step, final latents within LONGFORM_AGREE_TOL of their largest value;
    launches of the fp32 kernel against the shapes."""
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    steps, shape = 6, (2, 4, 256, 16)
    config = SamplerConfig(guidance=GuidanceConfig(schedule=True), record=True,
                           scg=SCGConfig(num_samples=4, weights=SCG_WEIGHTS,
                                         dc_base=16))
    collage = dict(num_img=3, overlap=64, circle=True)
    rolls = make_rolls(2, length=2048, seed=19)
    noise_fn_for = replay_noise(torch, 20)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            dit, vae = tiny_models(torch, pipeline, device)
            tables = make_schedule("linear", 1000, str(steps)).tables(device)
            rules = pipeline.extract_targets_from_rolls(
                [n for n, _ in SCG_WEIGHTS], torch.as_tensor(rolls, device=device))
            reset_counts(fa, gn)
            lat, rec = pipeline.generate(dit, vae, tables, config, shape, rules,
                                         noise_fn=noise_fn_for(device),
                                         num_classes=0, scale_factor=1.0,
                                         collage=collage)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
                blocks, dec_calls = len(dit.blocks), norm_calls(vae.decoder)
            out[device] = (lat.cpu(), rec["selected"].cpu())
    err = ((out["cuda"][0] - out["cpu"][0]).abs().max()
           / out["cpu"][0].abs().max()).item()
    same = torch.equal(out["cuda"][1], out["cpu"][1])
    print(f"quality_tiny stitched chain, circle of 3 images, 6 steps, SCG k=4 "
          f"per 16-column window ({out['cpu'][1].shape[1]} windows): picks "
          f"equal in every window {same}; final latents max error over the "
          f"largest value {err:.3e} (tol {LONGFORM_AGREE_TOL:.0e})")
    if not same or err > LONGFORM_AGREE_TOL:
        raise AssertionError("stitched windowed chain: card disagrees with the CPU")
    guided = steps - 1
    check_launches(launches, {
        "flash_attention": 0, "flash_attention_fp32": blocks * 2 * (steps + guided),
        "groupnorm_swish": dec_calls * guided})
    return launches


def edm_chain(torch, dit, device, seed, bump=0.0):
    """The circle-loss worker's output (eps plus its optimal-weight
    gradient step, through quality_tiny's XS DiT ``dit`` as a VP denoiser)
    and the final latents of a 4-step Heun chain with it, on a ring of 4
    windows drawn from ``seed``, on ``device``. With ``bump`` the DiT's
    output is moved by up to ``bump`` times its largest magnitude, along a
    normal draw made on the CPU (the same on every device)."""
    from rule_guided_music_tpu_torch.diffusion.collage import make_circle_loss_eps_fn
    from rule_guided_music_tpu_torch.diffusion.edm import (heun_sample_loop,
                                                           vp_eps_fn_from_model)
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule

    gen = torch.Generator().manual_seed(seed)
    ring = (4, 4, 128, 16)
    x = torch.randn(ring, generator=gen)
    sigma = torch.tensor([0.5, 1.0, 2.0, 4.0])

    def model(a, t, y=None):
        out = dit(a, t)
        if bump:
            r = torch.randn(out.shape, generator=torch.Generator().manual_seed(
                seed + sum(out.shape)))
            out = out + bump * out.detach().abs().max() * (r / r.abs().max()).to(device)
        return out

    tables = make_schedule("linear", 1000, "100").tables(device)
    vp = vp_eps_fn_from_model(tables, model)
    worker = make_circle_loss_eps_fn(lambda a, s, y=None: vp(a, s), 64)
    one = worker(x.to(device), sigma.to(device)).cpu()
    final = heun_sample_loop(lambda a, s: worker(a, s), ring, num_steps=4,
                             sigma_max=10.0,
                             noise_fn=replay_noise(torch, seed + 1)(device)).cpu()
    return one, final


def edm_card_vs_cpu(torch, port):
    """The EDM circle-loss worker and a 4-step Heun chain with it
    (:func:`edm_chain`), card against CPU in fp32 without TF32, on
    ``EDM_SEEDS``: the worker's output within LONGFORM_AGREE_TOL and the
    chain's final latents within EDM_CHAIN_AGREE_TOL of their largest
    value. The witness: on each device the chain is run again with the
    DiT's output moved by the worker's worst card-vs-CPU difference; the
    worst card-vs-CPU chain difference may be at most EDM_WITNESS_RATIO
    times the worst move that gives. Returns the worst worker and chain
    differences."""
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    out = {}
    with no_tf32(torch), torch.no_grad():
        dits = {d: tiny_models(torch, port["pipeline"], d)[0] for d in ("cpu", "cuda")}
        for seed in EDM_SEEDS:
            for device, dit in dits.items():
                out[device, seed] = edm_chain(torch, dit, device, seed)
        worker = [rel(out["cuda", s][0], out["cpu", s][0]) for s in EDM_SEEDS]
        chain = [rel(out["cuda", s][1], out["cpu", s][1]) for s in EDM_SEEDS]
        bump = max(worker)
        floor = [max(rel(edm_chain(torch, dit, device, s, bump)[1], out[device, s][1])
                     for device, dit in dits.items()) for s in EDM_SEEDS]
    for s, w, c, f in zip(EDM_SEEDS, worker, chain, floor):
        print(f"quality_tiny EDM circle-loss, draw {s}: worker output max error "
              f"over the largest value {w:.3e} (tol {LONGFORM_AGREE_TOL:.0e}); "
              f"4-step Heun chain {c:.3e} (tol {EDM_CHAIN_AGREE_TOL:.0e}); the "
              f"chain moved by a {bump:.2e} move of the DiT's output {f:.3e}")
    ok = (max(worker) <= LONGFORM_AGREE_TOL and max(chain) <= EDM_CHAIN_AGREE_TOL
          and max(chain) <= EDM_WITNESS_RATIO * max(floor))
    print(f"EDM chain: worst card-vs-CPU {max(chain):.3e}, worst move "
          f"{max(floor):.3e}, ratio {max(chain) / max(floor):.2f} "
          f"(at most {EDM_WITNESS_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("EDM worker: card disagrees with the CPU")
    return max(worker), max(chain)


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
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{kind}, device count {count}")
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
        attn_cls, attn_dit_grad = check_attention_grad(torch, fa, F)
        attn_roll = check_attention_rollout(torch, fa, F)
        # the ch=64 decoder alone: the serving bundle is built after the
        # SCG and flagship paths, whose peak memory it would otherwise hold
        decoder = pipeline.ScoringBundle.create(
            decoder_path=os.path.join(REPO, SCORING_ASSETS["decoder_path"]),
            dtype=torch.bfloat16, device="cuda").decoder
        gn_scoring = check_scoring_decode(torch, gn, decoder)
        del decoder
        torch.cuda.empty_cache()
        # the production KL-VAE with its encoder, freed before the main
        # paths, whose peak memory it would otherwise hold
        vae_enc = build_encoder_vae(torch, pipeline)
        gn_encoder = check_encoder(torch, gn, vae_enc)
        gn_backward = check_gn_backward(torch, gn, vae_enc)
        del vae_enc
        torch.cuda.empty_cache()
        attn_src = dict(route="cuda",
                        source="rule_guided_music_tpu_torch/csrc/flash_attention.cu",
                        replaces="rule_guided_music_tpu/ops/pallas_attention.py:90")
        kernels = [
            dict(name="flash_attention", **attn_src, **attn["flash_attention"],
                 at_classifier_shape=attn_cls, at_rollout_shape=attn_roll,
                 fwd_bwd_at_dit_b2=attn_dit_grad),
            dict(name="flash_attention_fp32", **attn_src,
                 **attn["flash_attention_fp32"]),
            dict(name="groupnorm_swish", route="cuda",
                 source="rule_guided_music_tpu_torch/csrc/groupnorm_swish.cu",
                 replaces="rule_guided_music_tpu/ops/pallas_groupnorm.py:117",
                 **check_groupnorm(torch, gn), at_scoring_decode=gn_scoring,
                 at_encoder=gn_encoder, fwd_bwd_at_decoder=gn_backward),
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
    del scoring
    torch.cuda.empty_cache()

    slice5_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = write_test_set(os.path.join(tmp, "test_set"))
        with phase("edit: scripts/configs/edit/nd_scg_given_target.yml, "
                   "DiTRotary_XL_8 + KL-VAE with its encoder, SCG k=4 on "
                   f"[32, 64), DDPM respaced to {EDIT_RESPACING} entered at "
                   f"step {EDIT_NOISE_LEVEL}, B=2"):
            slice5_launches["edit"] = edit_path(
                torch, port, models, build_encoder_vae(torch, pipeline), prefix)
        for label, yaml_name in (
                ("dps_rule", "cond_table/single/dps_rule/pitch.yml"),
                ("scg_dps_nn", "cond_table/all/scg_dps_nn_all.yml")):
            with phase(f"DPS: scripts/configs/{yaml_name}, DiTRotary_XL_8 + "
                       f"KL-VAE, {DPS_RESPACING} steps, B=2"):
                slice5_launches[label] = dps_path(torch, port, models, yaml_name)
        del models
        torch.cuda.empty_cache()
        with phase("test-set targets: sample_rule.main on "
                   "scg_classifier_all with --data_dir, 10 steps, B=2"):
            slice5_launches["test_set_targets"] = test_set_cli_path(
                torch, port, prefix, tmp)
    torch.cuda.empty_cache()

    with phase("small-input agreement: card vs CPU"):
        fp32_launches = small_input_agreement(torch, port)
        cond_fn_card_vs_cpu(torch, port)
        serving_card_vs_cpu(torch, port)
        edit_dps_card_vs_cpu(torch, port)

    # long-form generation and the remaining sampling entry points, after
    # every earlier path, so that none of them moves an earlier peak
    from rule_guided_music_tpu_torch import (cfg_sample, classifier_sample,
                                             diffcollage_sample)

    models = build_main_models(torch, pipeline)
    with phase("long-form kernel checks: attention at the stitched rollout's "
               "64 windows of 128 and 256 tokens and at the EDM ring's "
               "gradient, GroupNorm+swish on a decode of two 20.48 s latents"):
        long_kernels = check_long_kernels(torch, fa, gn, F, models["vae"])
    torch.cuda.empty_cache()
    slice6_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        with phase("demo1: scripts/configs/cond_demo/demo1.yml, DiTRotary_XL_8 "
                   "stitched over a circle of one image + 3 DiTRotary-S/8 "
                   "classifiers + KL-VAE, SCG k=16 per 16-column window, "
                   f"{DEMO_RESPACING} steps, B=2, states recorded"):
            slice6_launches["demo1"] = demo1_path(torch, port, models, tmp)
        with phase(f"EDM: Heun, {EDM_STEPS} steps, circle-loss worker around "
                   "vp_eps_fn_from_model(DiTRotary_XL_8) on a ring of 4 "
                   "windows, the merged 20.48 s circle decoded"):
            slice6_launches["edm_circle_loss"] = edm_path(torch, port, models)
        with phase("diffcollage_sample: a stitched step's parts"):
            diffcollage_breakdown(torch, models)
        del models
        torch.cuda.empty_cache()
        for demo in ("demo2", "demo3"):
            with phase(f"{demo}: sample_rule.main on scripts/configs/cond_demo/"
                       f"{demo}.yml, {DEMO_RESPACING} steps, B=2"):
                slice6_launches[demo] = demo_cli_path(torch, port, demo, tmp)
        for label, flags in (("circle", []),
                             ("linear", ["--dc_type", "linear"]),
                             ("circle_cfg", ["--cfg", "True", "--class_cond",
                                             "True"])):
            with phase(f"diffcollage_sample {' '.join(flags) or 'defaults'}: "
                       f"three images, overlap 64, 20.48 s, DDPM respaced to "
                       f"{SAMPLE_RESPACING}, B=2"):
                slice6_launches[f"diffcollage_{label}"] = sample_cli_path(
                    torch, port, f"diffcollage_{label}", diffcollage_sample,
                    ["--batch_size", "2", "--num_samples", "2", *flags],
                    SAMPLE_RESPACING, tmp, n_files=2, seconds=20.48)
        for label, flags, respacing in (
                ("ddim", ["--use_ddim", "True"], f"ddim{SAMPLE_RESPACING}"),
                ("dpmpp", ["--sampler", "dpmpp"], SAMPLE_RESPACING)):
            with phase(f"cfg_sample {' '.join(flags)}: CFG w=4, "
                       f"{respacing} steps, B=4"):
                slice6_launches[f"cfg_{label}"] = sample_cli_path(
                    torch, port, f"cfg_{label}", cfg_sample,
                    ["--batch_size", "4", "--num_samples", "4", "--class_cond",
                     "True", *flags], respacing, tmp, n_files=4, seconds=10.24)
        with phase(f"classifier_sample: one DiTRotary-S/8 classifier (seeded "
                   f"random), {CLASSIFIER_RESPACING} steps, B=4"):
            slice6_launches["classifier_sample"] = sample_cli_path(
                torch, port, "classifier_sample", classifier_sample,
                ["--batch_size", "4", "--num_samples", "4"],
                CLASSIFIER_RESPACING, tmp, n_files=4, seconds=10.24,
                cls_blocks=12)
    torch.cuda.empty_cache()
    with phase("long-form agreement: card vs CPU"):
        stitched_eps_card_vs_cpu(torch, port)
        longform_card_vs_cpu(torch, port)
        edm_card_vs_cpu(torch, port)

    # the bf16 kernels' launches are the flagship path's (each path's too);
    # the fp32 attention kernel's are those of the fp32 fixture run, the
    # path that takes it
    for k in kernels:
        if k["name"] == "flash_attention":
            k.update({key: long_kernels[key] for key in (
                "at_half_window", "at_stitched_rollout", "fwd_bwd_at_edm_ring")})
        elif k["name"] == "groupnorm_swish":
            k["at_long_decode"] = long_kernels["at_long_decode"]
        if k["name"] == "flash_attention_fp32":
            k["launches"] = fp32_launches[k["name"]]
            k["launched_in"] = "card-vs-CPU fixture run, fp32"
        else:
            k["launches"] = cls_launches[k["name"]]
            k["launched_in"] = "main path with classifier guidance, bf16"
            k["launches_by_path"] = {"scg": scg_launches[k["name"]],
                                     "classifier_guidance": cls_launches[k["name"]],
                                     **{n: v[k["name"]]
                                        for n, v in serving_launches.items()},
                                     **{n: v[k["name"]]
                                        for n, v in slice5_launches.items()},
                                     **{n: v[k["name"]]
                                        for n, v in slice6_launches.items()}}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launched_in", "launches_by_path", "at_classifier_shape",
            "at_rollout_shape", "fwd_bwd_at_dit_b2", "at_scoring_decode",
            "at_encoder", "fwd_bwd_at_decoder", "at_half_window",
            "at_stitched_rollout", "fwd_bwd_at_edm_ring", "at_long_decode"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    # the card's name, read where the result line is printed
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
