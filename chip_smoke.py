#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds every CUDA source from this checkout with nvcc (one process each,
all in parallel: kernel 1's bf16 forward, bf16 backward and fp32 sources,
kernel 2's) and prints each one's seconds, checks each hand-written kernel
against its plain PyTorch version at the main path's shapes (attention in
bf16 and in fp32, both on the tensor cores, fp32 as three TF32 products,
on contiguous tensors and on strided views of one qkv tensor;
GroupNorm+swish at every decoder geometry, so every cluster size), drives
the port's SCG generation at full width (DiTRotary_XL_8 + the production
KL-VAE decoder, bf16, seeded random weights, k=16, weights 40/1/1 as in
scripts/configs/cond_table/all/scg.yml, on a 10-step respaced DDPM chain,
B=2), asserts that the run launched each kernel as often as its shapes say,
writes and reads back one MIDI file, and checks the port's card path
against its CPU path on the committed tiny fixture (the fp32 run, which
goes through the fp32 attention kernel). It then checks the attention
backward kernels (dQ, dK, dV; the autograd Function's backward launches
them) against autograd through the plain forward and against the plain
backward, drives the
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
and both backward kernels where a gradient is wanted (kernel 2's at the
decoder's 29 call shapes on 16 chunks, kernel 1's at the DiT's
(2,256,16,72)), against both plain versions, forward + backward and the
backward alone timed beside the plain versions', the library's and the
bounds. Every path that differentiates asserts its backward launches
beside its forward ones. It writes a test set of seeded uint8 rolls
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

Int8 serving and the pixel-space paths, after every earlier path: kernel 1
at the pixel paths' shapes in both dtypes (the UNet's (2,1024,4,64),
(8,1024,4,64), (2,256,4,96), (2,64,4,128); DiT-B/8 under CFG
(4,256,12,64)) and kernel 2 on every call of one forward of
``pixel.sample_pixel``'s UNet at eps 1e-5; then, with launch checks:
``pixel.sample_pixel --scg True`` at its defaults (the UNet on (3, 128,
128), k=4, B=2), ``pixel.cfg_sample_pixel`` under DDIM and DPM-Solver++
(DiT-B/8, CFG w=4), each first on the CLI's build with seeded random
weights (ms per step, MIDI) and then through its ``main``; the scg.yml
chain with the fp, w8a16 and w8a8 XL_8 trunks (the same seeded weights)
in one call, with the trunk's linears timed and w8a16's per-call bf16
weight cast measured; ``sample_rule.main --quant`` in both modes; and,
card against CPU: QuantLinear, the quantized XS_8 of quality_tiny within
JAX's envelope of the fp trunk, and a small UNet and 2-D DiT (forward and
a 4-step chain).

The evaluation chain, after every earlier path (every phase writes under
one temporary root): ``eval_results.compute_rule`` on the flagship CLI's
MIDI on the card and on the CPU (the two agree; the JAX chain test's
contract against the sampler's results.csv holds; its MIDI round-trip
envelopes, measured on trained weights, are printed), compute_rule on
200 excerpts of 10.24 s in one batched call (files per second, the
host's read, the rule call's device ms against its bound, peak memory),
eval_rule over every results.csv of the run (each mean equal to its
summary.csv), eval_quality 200 against 200 and with --runs 3,
eval_uncond and eval_uncond_summary, edit_create_bins and edit_accuracy
on the edit phase's tables (two batches), and compute_fad's proxy on 16
against 16 of those files, with the vggish backend's gate error.

Training, after every earlier path: kernel 1 forward + backward and the
backward alone at train_dit's (32,256,16,72), and kernel 2's backward with
the weight and bias gradients on every call of one train_vae step (the
production VAE's encoder and decoder at 128 chunks, bf16 under autocast),
each beside its plain versions, the library's and its bound; then
``train_dit.main`` at the JAX script's defaults (DiTRotary_XL_8, batch 32
latents from 8 rolls of 2560 columns x encode_rep 4, bf16 compute over
fp32 parameters, AdamW, EMA 0.9999, the production VAE encoder; seeded
random weights and rolls): one warm-up step, five measured, one under
torch.profiler (the device's idle share), the save, a launch check and a
CUDA-event breakdown of one more step; ``train_vae.main`` at its defaults
(batch 128 chunks, bf16, four steps) with its launch check; and an fp32
train step card against CPU (a class-conditional XS_8; a VAE of the
fixture's geometry) and resume on the card (bit-equal).

Each phase prints its wall seconds. The line before the last is a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX and no PyYAML.
"""

import contextlib
import json
import re
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

REPO = os.path.dirname(os.path.abspath(__file__))
# the card's name and power limit as nvidia-smi prints them, set by main
CARD = "not read"

# The H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# kernel 1 in fp32 runs on the tensor cores as three TF32 products (the
# 3xTF32 split): its bound counts three times the operations at the TF32
# rate; the fp32 pipes' bound (one product at 67 TFLOP/s) is printed beside
ATTN_PEAK = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3)}

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
# the same values): fp32 allows summation-order differences (and, for
# attention, the 3xTF32 split's residue, about 2^-21 of a product). In bf16,
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
# past the cluster backward's N <= 512 (the pixel UNet's attention), where
# the bf16 backward takes the dQ and dK/dV kernels: no port path
# differentiates there, so only this check holds them to their plain version
PAIR_GRAD_SHAPE = (2, 1024, 4, 64)
# max abs difference of the backward kernels' gradients (dq, dk, dv; dx, dw,
# dbias) from autograd through the plain forward and from the plain
# backward, over the largest gradient: fp32 kernels differ from both in
# summation order and, for attention, the 3xTF32 split's residue (about
# 2^-21 of a product; tests/test_torch_kernels.py holds an emulation of
# the split to this tolerance of JAX's VJP); bf16 kernels round P and dS
# to bf16 where they enter a product and each gradient once at the end
# (2^-8 relative), which tests/test_torch_backward.py emulates within
# 4.7e-3 of JAX's VJP
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the composite classifier gradient, card (fp32 kernels; TF32 off for
# cuBLAS and cuDNN) against CPU, over its largest magnitude: the kernels'
# summation order and split (a few 1e-6 on attention outputs), carried
# through two blocks and a head
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
    "cond_table/all/scg.yml": {
        "target_rules": _TARGETS_ALL,
        "guidance": {"vae": True, "nn": False, "scg": True,
                     "method": "no_guidance", "cond_fn": None, **_SCHEDULE},
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
# int8 serving and the pixel-space paths. Kernel 1 at the pixel paths'
# shapes: sample_pixel's UNet (4 heads) at the 32 x 32 map (N=1024, D=64;
# B=2 and the SCG rollout's k*B=8), the 16 x 16 map (N=256, D=96) and the
# 8 x 8 map and middle block (N=64, D=128); cfg_sample_pixel's DiT-B/8
# under CFG (2B=4, 256 tokens, 12 heads of 64)
PIXEL_ATTN_SHAPES = [(2, 1024, 4, 64), (8, 1024, 4, 64), (2, 256, 4, 96),
                     (2, 64, 4, 128), (4, 256, 12, 64)]
# one forward of sample_pixel's UNet: 16 attention blocks (6 down, 1
# middle, 9 up) and 28 fused GroupNorm+swish calls (27 ResBlock in_norms
# and the final out_norm), both read off the module
UNET_ATTN_PER_FORWARD, UNET_GN_PER_FORWARD = 16, 28
# the pixel CLIs' cut: 10-step chains (both default to DDPM-1000)
PIXEL_RESPACING = "10"
QUANT_MODES = ("w8a16", "w8a8")
# the quantized trunk's eps against the fp trunk's on quality_tiny,
# relative L2: JAX's envelope (tests/test_quant.py:106-109)
QUANT_ENVELOPE = {"w8a8": 0.05, "w8a16": 0.04}
# the quantized XS_8, card against CPU in fp32, relative L2 of eps: w8a16
# the fp32 summation order; w8a8 also an int8 activation one step off
# where an fp32 ulp moves it across a rounding boundary (the CPU tests
# hold the port against JAX to the same limits, tests/test_torch_quant.py)
QUANT_AGREE_TOL = {"w8a8": 1e-3, "w8a16": 1e-5}
# QuantLinear, card against CPU on the same fp32 inputs, over the largest
# output: w8a8's int8 values and int32 sums are exact, so only the fp32
# dequantization (elementwise, the same operations) is left; w8a16's fp32
# product sums in another order
QUANT_LINEAR_TOL = {"w8a8": 1e-6, "w8a16": 1e-5}
# XL_8's four token-level linears (in, out): qkv, proj, fc1, fc2
XL_LINEARS = [(1152, 3456), (1152, 1152), (1152, 4608), (4608, 1152)]
# the edit path's cut: a DDPM chain respaced to 100 steps (the YAML runs
# DDPM-1000) entered at step 50 (the YAML's noise_level 500 of 1000)
EDIT_RESPACING, EDIT_NOISE_LEVEL = "100", 50
# the DPS paths: a 10-step respaced chain (the YAMLs run DDPM-1000)
DPS_RESPACING = "10"
ENCODE_CHUNKS = 16   # B * 8 chunks: one encode, or one decode, at B=2
# the evaluation group: the paper's evaluation size, two sets of 200
# excerpts of 10.24 s (make_rolls at these seeds); compute_fad's proxy on
# the first 16 files of each set, a cut made for time (it synthesizes each
# file's audio on the host)
EVAL_EXCERPTS, EVAL_SEEDS, FAD_FILES = 200, (41, 42), 16
EVAL_RULES = ("pitch_hist", "note_density", "chord_progression")
# compute_rule, card against CPU: the float rules within this (abs); chord
# tags equal except in windows whose best triads tie in float64 (ROADMAP
# 3.1). eval_rule's .loss means against each summary.csv's Mean
EVAL_RULE_AGREE_TOL, EVAL_MEAN_TOL = 1e-5, 1e-9
# the FAD gate's error without frechet_audio_distance (eval/fad.py)
FAD_GATE_TEXT = "FAD evaluation needs 'frechet_audio_distance'"
# the card-vs-CPU chains on quality_tiny, fp32 without TF32: final latents
# within this much of the largest latent (the models' summation order,
# carried through the chain as in the fixture checks above)
EDIT_DPS_AGREE_TOL = 1e-3
# training: train_dit at the JAX script's defaults (XL_8, batch 32 latents
# = 8 rolls of 2560 columns x encode_rep 4, bf16) for one warm-up step,
# five measured steps and one step under torch.profiler, then its save;
# train_vae at its defaults (batch 128 chunks) for four steps; the
# synthetic data: seeded make_rolls rolls written as uint8 .npy
TRAIN_DIT_STEPS, TRAIN_DIT_MEASURED, TRAIN_DIT_PROFILED = 7, slice(1, 6), 6
TRAIN_ROLLS, TRAIN_ROLL_COLUMNS = 16, 2700
TRAIN_VAE_STEPS, TRAIN_VAE_CHUNKS = 4, 128
TRAIN_ATTN_SHAPE = (32, 256, 16, 72)    # XL_8 at 32 latents of 256 tokens
# a train step card against CPU, fp32 without TF32: the gradients (read
# from Adam's first moment) within TRAIN_GRAD_TOL of the largest gradient
# (the port's fp32 model tolerance); the loss and the per-example losses
# within TRAIN_AGREE_TOL of their largest, the EMA and the updated
# parameters within TRAIN_AGREE_TOL of the module's largest parameter, the
# parameters elementwise where the gradient is settled (card and CPU
# within a tenth of it, and |g| >= 100 eps): Adam's first update is
# lr g / (|g| + eps), +-lr whatever |g| >> eps, so an element whose
# gradient is rounding noise (a conv bias ahead of a one-channel
# GroupNorm, the key bias of an attention: structurally 0) may move
# either way, by <= 2 lr, and one with |g| near eps by a share of lr that
# follows its rounding
TRAIN_AGREE_TOL, TRAIN_GRAD_TOL, TRAIN_SETTLED, ADAM_EPS = 1e-5, 1e-4, 0.1, 1e-8


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


@contextlib.contextmanager
def kept_dir(root, name):
    """A new directory ``root/name`` that outlives its block: the
    evaluation group reads what the earlier phases wrote there."""
    path = os.path.join(root, name)
    os.makedirs(path)
    yield path


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
        peak, mult = ATTN_PEAK[dname]
        bnd, by = bound_and_kind(nbytes, mult * ops, peak)
        fma = bound_ms(nbytes, ops, "float32")
        print(f"attention {ATTN_SHAPES[0]} {dname} ({name}): kernel {ms:.4f} ms "
              f"contiguous, {strided:.4f} ms on qkv views; plain {plain:.4f} ms, "
              f"F.scaled_dot_product_attention {lib:.4f} ms, bound {bnd:.4f} ms "
              f"({by}), {100 * bnd / ms:.1f}% of the bound"
              + (f"; the fp32 pipes' bound {fma:.4f} ms" if mult == 3 else ""))
        results[name] = dict(max_abs_err=worst[dname], ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             strided_ms=strided,
                             shape=f"{ATTN_SHAPES[0]} {dname}, one launch",
                             **({"fp32_pipes_bound_ms": fma} if mult == 3 else {}))
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
        out = gn.groupnorm_swish(x, mod.weight, mod.bias, mod.num_groups, mod.eps)
        ref = gn.groupnorm_swish_reference(x.float(), mod.weight.float(),
                                           mod.bias.float(), mod.num_groups,
                                           mod.eps)
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
        return lambda: [fn(x, mod.weight, mod.bias, mod.num_groups, mod.eps)
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
                                                      mod.num_groups, mod.eps),
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


def rel_err(got, want):
    """Max abs difference over the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_gn_backward(torch, gn, vae):
    """Kernel 2's backward where a gradient is wanted (DPS through the
    decoder): at each of the 29 call shapes of one production decode of 16
    chunks, bf16, the backward kernel's dx (x alone wants a gradient, as in
    DPS: one backward call, no weight or bias reduction) and then its dx,
    dw and dbias (one reduction launch), each against autograd through the
    plain forward and against the plain backward, both in fp32 on the same
    bf16 values; then the 29 calls' forward + backward and backward alone
    timed beside the plain backward, F.group_norm+F.silu autograd and the
    bounds."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    z = torch.randn((ENCODE_CHUNKS, 4, 16, 16), generator=gen, device="cuda")
    calls, _ = capture_norm_inputs(torch, gn, vae.decoder, lambda: vae.decode(z))
    worst = {"x only": 0.0, "x, w, b": 0.0}
    for x, mod in calls:
        cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        fp32 = [t.detach().float().requires_grad_() for t in (x, mod.weight, mod.bias)]
        autograd = torch.autograd.grad(gn.groupnorm_swish_reference(
            *fp32, mod.num_groups, 1e-6), fp32, cot.float())
        plain = gn.groupnorm_swish_backward_reference(
            x, mod.weight, mod.bias, cot, mod.num_groups, 1e-6)
        for label, wants in (("x only", (True, False)), ("x, w, b", (True, True))):
            leaves = [x.detach().requires_grad_()] + [
                t.detach().requires_grad_(wants[1]) for t in (mod.weight, mod.bias)]
            before = (gn.backward_launches, gn.param_grad_launches)
            out = gn.groupnorm_swish(*leaves, mod.num_groups, 1e-6)
            grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                                        cot)
            if (gn.backward_launches, gn.param_grad_launches) != (
                    before[0] + 1, before[1] + wants[1]):
                raise AssertionError(f"groupnorm_swish backward ({label}): "
                                     f"launches moved by {gn.backward_launches - before[0]}"
                                     f" and {gn.param_grad_launches - before[1]}")
            worst[label] = max(worst[label], *(
                max(rel_err(g, a), rel_err(g, p))
                for g, a, p in zip(grads, autograd, plain)))
    ok = max(worst.values()) <= GRAD_TOL["bfloat16"]
    print(f"groupnorm_swish backward kernel at the decoder's {len(calls)} call "
          f"shapes ({ENCODE_CHUNKS} chunks, bf16), against autograd through the "
          f"plain forward and the plain backward: max abs error over the largest "
          f"gradient, dx alone {worst['x only']:.2e}, dx/dw/dbias "
          f"{worst['x, w, b']:.2e} (tol {GRAD_TOL['bfloat16']:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("groupnorm_swish backward kernel disagrees with the "
                             "plain versions")
    leaves = [(x.detach().requires_grad_(), mod,
               torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype))
              for x, mod in calls]

    def fwd_bwd(fn):
        return lambda: [torch.autograd.grad(
            fn(x, mod.weight, mod.bias, mod.num_groups), x, cot)
            for x, mod, cot in leaves]

    def bwd(fn):
        outs = [(fn(x, mod.weight, mod.bias, mod.num_groups), x, cot)
                for x, mod, cot in leaves]
        return lambda: [torch.autograd.grad(out, x, cot, retain_graph=True)
                        for out, x, cot in outs]

    ms = cuda_time_ms(fwd_bwd(gn.groupnorm_swish), reps=3, warmup=1)
    lib = cuda_time_ms(fwd_bwd(library_gn), reps=3, warmup=1)
    bwd_ms = cuda_time_ms(bwd(gn.groupnorm_swish), reps=3, warmup=1)
    lib_bwd = cuda_time_ms(bwd(library_gn), reps=3, warmup=1)
    plain = cuda_time_ms(lambda: [gn.groupnorm_swish_backward_reference(
        x, mod.weight, mod.bias, cot, mod.num_groups) for x, mod, cot in leaves],
        reps=3, warmup=1)
    elems = sum(x.numel() for x, _ in calls)
    # forward: x in, y out; backward: x and dy in, dx out (bf16)
    bnd, by = bound_and_kind(5 * elems * 2, 30 * elems, "float32")
    bnd_bwd, by_bwd = bound_and_kind(3 * elems * 2, 20 * elems, "float32")
    print(f"groupnorm_swish, one decode of {ENCODE_CHUNKS} chunks ({len(calls)} "
          f"calls) bf16 with a gradient: kernel forward + backward {ms:.4f} ms, "
          f"F.group_norm+F.silu forward + backward {lib:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of the bound; backward "
          f"alone: kernel {bwd_ms:.4f} ms, F.group_norm+F.silu {lib_bwd:.4f} ms, "
          f"plain backward {plain:.4f} ms, bound {bnd_bwd:.4f} ms ({by_bwd}), "
          f"{100 * bnd_bwd / bwd_ms:.1f}% of the bound")
    return dict(max_abs_err=max(worst.values()), ms=bwd_ms, plain_ms=plain,
                bound_ms=bnd_bwd, bound_by=by_bwd, library_ms=lib_bwd,
                fwd_bwd_ms=ms, library_fwd_bwd_ms=lib, fwd_bwd_bound_ms=bnd,
                shape=f"the decoder's {len(calls)} calls on {ENCODE_CHUNKS} "
                      f"chunks, bf16, backward alone (dx)")


def bound_and_kind(nbytes, ops, dtype_name):
    """(bound ms, "bytes" or "operations", whichever sets it)."""
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S[dtype_name]
          else "operations")
    return bound_ms(nbytes, ops, dtype_name), by


def attention_bwd_bound(shape):
    """The backward alone: q, k, v, o, dO read and dq, dk, dv written in
    bf16, LSE read; five products (S recomputed, dP, dV, dQ, dK)."""
    b, n, h, d = shape
    return bound_and_kind(8 * b * n * h * d * 2 + 4 * b * h * n,
                          10 * b * h * n * n * d, "bfloat16")


def check_attention_grad(torch, fa, F):
    """The backward kernels at every GRAD_SHAPES entry and at PAIR_GRAD_SHAPE
    (check_attention_grad_at); then, at the classifiers' shape (the flagship's cond_fn), the forward,
    forward + backward and backward alone timed beside the plain versions,
    SDPA and the bounds; and forward + backward at the DiT's B=2 (DPS)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = [check_attention_grad_at(torch, fa, gen, shape)
            for shape in GRAD_SHAPES + [PAIR_GRAD_SHAPE]]
    worst = {dname: max(e[dname] for e in errs) for dname in errs[0]}
    shape = GRAD_SHAPES[0]
    b, n, h, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
    bnd, by = bound_and_kind(4 * b * n * h * d * 2, 4 * b * h * n * n * d,
                             "bfloat16")
    print(f"attention {shape} bf16, the classifiers' shape: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bnd:.5f} ms ({by}), {100 * bnd / ms:.1f}% of the bound")
    cls = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
               library_ms=lib, shape=f"{shape} bf16, one launch",
               **time_attention_fwd_bwd(torch, fa, F, gen, shape,
                                        "the classifiers (the flagship's cond_fn)"))
    # the XL DiT at B=2, as DPS differentiates it
    dit = time_attention_fwd_bwd(torch, fa, F, gen, GRAD_SHAPES[2],
                                 "the DiT at B=2 (DPS)")
    fp32 = time_attention_bwd_fp32(torch, fa, F, gen, shape)
    return cls, dit, fp32, worst


def time_attention_bwd_fp32(torch, fa, F, gen, shape):
    """The fp32 backward kernels alone at ``shape`` (one autograd backward
    of a retained graph) beside SDPA's fp32 backward, the plain backward
    and the bound (three TF32 products at 495 TFLOP/s; the fp32 pipes'
    67 TFLOP/s beside)."""
    b, n, h, d = shape
    leaves = [torch.randn(shape, generator=gen, device="cuda").requires_grad_()
              for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device="cuda")
    with no_tf32(torch):
        out = fa.flash_attention(*leaves)
        lib_out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in leaves)).transpose(1, 2)
        ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                      retain_graph=True))
        lib = cuda_time_ms(lambda: torch.autograd.grad(lib_out, leaves, cot,
                                                       retain_graph=True))
        qf, kf, vf = (x.detach() for x in leaves)
        ref = fa.flash_attention_reference_lse(qf, kf, vf)
        plain = cuda_time_ms(lambda: fa.flash_attention_backward_reference(
            qf, kf, vf, *ref, cot))
    nbytes, ops = 8 * b * n * h * d * 4 + 4 * b * h * n, 10 * b * h * n * n * d
    bnd, by = bound_and_kind(nbytes, 3 * ops, "tf32")
    fma = bound_ms(nbytes, ops, "float32")
    print(f"attention {shape} fp32, backward alone: kernel {ms:.4f} ms, SDPA "
          f"{lib:.4f} ms, plain backward {plain:.4f} ms, bound {bnd:.5f} ms "
          f"({by}), {100 * bnd / ms:.1f}% of the bound; the fp32 pipes' bound "
          f"{fma:.5f} ms")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                shape=f"{shape} fp32, backward alone", fp32_pipes_bound_ms=fma)


def check_attention_grad_at(torch, fa, gen, shape):
    """dq, dk, dv through the backward kernels at ``shape`` in both dtypes,
    on views of one qkv tensor (one forward and one backward call each),
    against autograd through the plain forward and against the plain
    backward on the plain forward's output and LSE (fp32). Returns the
    worst error of each dtype."""
    b, n, h, d = shape
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        qkv = torch.randn((b, n, 3, h, d), generator=gen,
                          device="cuda").to(dtype).requires_grad_()
        cot = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        before = dict(fa.kernel_launches)
        out = fa.flash_attention(q, k, v)
        if out.grad_fn is None:
            raise AssertionError("flash_attention: no grad_fn where a "
                                 "gradient is wanted")
        got = torch.autograd.grad(out, qkv, cot)[0]
        name, bwd = fa.KERNEL_NAME[dtype], fa.BWD_KERNEL_NAME[dtype]
        if fa.kernel_launches != {**before, name: before[name] + 1,
                                  bwd: before[bwd] + 1}:
            raise AssertionError(f"flash_attention {shape} {dname}: launches "
                                 f"{fa.kernel_launches}, before {before}")
        want = torch.autograd.grad(fa.flash_attention_reference(q, k, v),
                                   qkv, cot)[0]
        qf, kf, vf = (x.detach().float() for x in (q, k, v))
        plain = fa.flash_attention_backward_reference(
            qf, kf, vf, *fa.flash_attention_reference_lse(qf, kf, vf), cot.float())
        errs = [max(rel_err(got[:, :, i], want[:, :, i]), rel_err(got[:, :, i], plain[i]))
                for i in range(3)]
        del qkv, got, want, plain
        ok = max(errs) <= GRAD_TOL[dname]
        print(f"attention backward kernel {shape} {dname} ({bwd}), against "
              f"autograd through the plain forward and the plain backward: max "
              f"abs error over the largest gradient dq {errs[0]:.2e}, dk "
              f"{errs[1]:.2e}, dv {errs[2]:.2e} (tol {GRAD_TOL[dname]:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention gradient {shape} {dname}")
        worst[dname] = max(errs)
    return worst


def time_attention_fwd_bwd(torch, fa, F, gen, shape, label):
    """Kernel 1 with a gradient at ``shape`` in bf16: forward + backward
    beside the plain version's and SDPA's, and the backward alone (one
    autograd backward of a retained graph) beside SDPA's, the plain
    backward and its bound."""
    b, n, h, d = shape
    leaves = [torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in leaves)).transpose(1, 2)
    fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention(*leaves), leaves, cot))
    plain_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        fa.flash_attention_reference(*leaves), leaves, cot))
    lib_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(sdpa(), leaves, cot))
    out, lib_out = fa.flash_attention(*leaves), sdpa()
    bwd = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                   retain_graph=True))
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(lib_out, leaves, cot,
                                                       retain_graph=True))
    qf, kf, vf = (x.detach().float() for x in leaves)
    ref = fa.flash_attention_reference_lse(qf, kf, vf)
    plain_bwd = cuda_time_ms(lambda: fa.flash_attention_backward_reference(
        qf, kf, vf, *ref, cot))
    # forward + backward: q, k, v and dO in, o out and read again, dq, dk,
    # dv out; six products (S and PV forward; dV, dP, dQ, dK backward)
    bnd, by = bound_and_kind(12 * b * n * h * d * 2, 12 * b * h * n * n * d,
                             "bfloat16")
    bnd_bwd, by_bwd = attention_bwd_bound(shape)
    print(f"attention {shape} bf16 with a gradient, {label}: kernel forward + "
          f"backward {fwd_bwd:.4f} ms, plain {plain_fwd_bwd:.4f} ms, "
          f"F.scaled_dot_product_attention {lib_fwd_bwd:.4f} ms, bound "
          f"{bnd:.5f} ms ({by}), {100 * bnd / fwd_bwd:.1f}% of the bound; "
          f"backward alone: kernel {bwd:.4f} ms, SDPA {lib_bwd:.4f} ms, plain "
          f"backward {plain_bwd:.4f} ms, bound {bnd_bwd:.5f} ms ({by_bwd}), "
          f"{100 * bnd_bwd / bwd:.1f}% of the bound")
    return dict(fwd_bwd_ms=fwd_bwd, plain_fwd_bwd_ms=plain_fwd_bwd,
                library_fwd_bwd_ms=lib_fwd_bwd, fwd_bwd_bound_ms=bnd,
                bwd_ms=bwd, library_bwd_ms=lib_bwd, plain_bwd_ms=plain_bwd,
                bwd_bound_ms=bnd_bwd, bwd_bound_by=by_bwd,
                grad_shape=f"{shape} bf16, with a gradient")


def attention_bwd_repeats(torch, fa, gen, shape):
    """Kernel 1's bf16 backward called twice on the same inputs at
    ``shape``: bit-equal dq, dk, dv (no atomics, a fixed order of
    summation), or AssertionError."""
    leaves = [torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    out = fa.flash_attention(*leaves)
    first, second = (torch.autograd.grad(out, leaves, cot, retain_graph=True)
                     for _ in range(2))
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"attention backward kernel {shape} bf16, called twice on the same "
          f"inputs: dq, dk, dv bit-equal {same}")
    if not same:
        raise AssertionError(f"flash_attention backward {shape}: a repeat call differs")
    return same


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


def library_gn(x, w, b, g, eps=1e-6):
    import torch.nn.functional as F

    return F.silu(F.group_norm(x, g, w, b, eps))


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
    classifier gradient (every step when SCG is on, in DDPM), each with
    one backward call."""
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
        "attention_bwd": cls_blocks * n_cond,
        "groupnorm_swish": norm_calls * (n_guided + final_decode)}


def reset_counts(fa, gn):
    fa.kernel_launches = dict.fromkeys(fa.kernel_launches, 0)
    gn.launches = gn.backward_launches = gn.param_grad_launches = 0


def read_counts(fa, gn):
    return {**fa.kernel_launches, "groupnorm_swish": gn.launches,
            "groupnorm_swish_bwd": gn.backward_launches,
            "groupnorm_swish_param_grad": gn.param_grad_launches}


def build_main_models(torch, pipeline, quant_modes=()):
    """DiTRotary_XL_8 and the production KL-VAE decoder in bf16 with seeded
    random weights, the 10-step chain, targets and labels (B=2). With
    ``quant_modes``, also ``qdits``: a copy of the fp32 XL_8 per mode, its
    trunk quantized in place (the fold timed), then cast to bf16."""
    import copy

    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.ops.quant import quantize_
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    batch = 2
    dit = pipeline.create_denoiser("DiTRotary_XL_8", dtype=torch.float32)
    pipeline.randomize_(dit, seed=0)
    qdits = {}
    for mode in quant_modes:
        qdit = copy.deepcopy(dit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quantize_(qdit, mode)
        torch.cuda.synchronize()
        print(f"quantize_ {mode}: XL_8's 112 trunk linears (0.45 G fp32 "
              f"weights) folded to int8 in {time.perf_counter() - t0:.3f} s "
              f"(host numpy, copies to and from the card included)")
        qdits[mode] = qdit.to(torch.bfloat16)
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
        shape=(batch, 4, 128, 16), **({"qdits": qdits} if quant_modes else {}))


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
                "flash_attention_bwd": predicted["attention_bwd"],
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
    # every classifier launch takes a gradient: one backward call each
    check_launches(launches, {"flash_attention": 0,
                              "flash_attention_fp32": 2 * len(cpu_models),
                              "flash_attention_bwd": 0,
                              "flash_attention_bwd_fp32": 2 * len(cpu_models),
                              "groupnorm_swish": 0})
    return launches


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


def edit_path(torch, port, m, vae, prefix, out_dir):
    """scripts/configs/edit/nd_scg_given_target.yml at full width: the
    source is one batch of the written test set (augmented, as the edit
    CLI loads it), encoded by the production encoder; SCG k=4 on the
    editable slice [32, 64) of a DDPM chain respaced to 100 steps and
    entered at step 50 (the cut: EDIT_RESPACING, EDIT_NOISE_LEVEL). A
    second batch on the same source follows, unmeasured, and the edit
    CLI's tables of both (results.csv and summary.csv, scored on the
    slice) go to ``out_dir``, where the evaluation group reads them."""
    import numpy as np

    from rule_guided_music_tpu_torch.config import sampler_config_from_yaml
    from rule_guided_music_tpu_torch.constants import NORM_SCALE
    from rule_guided_music_tpu_torch.data.pianoroll import finalize_decoded_sample
    from rule_guided_music_tpu_torch.sample_rule import rule_results
    from rule_guided_music_tpu_torch.utils.tables import (summarize_losses,
                                                          write_summary,
                                                          write_table)
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

    def chain(sc, seed=0):
        gt_latent = pipeline.encode_rolls(vae, gt)
        mask = torch.ones_like(gt_latent)
        mask[:, :, ed.l_start:ed.l_end, :] = 0.0
        latents, rec = pipeline.generate(
            dit, vae, tables, sc, shape, rules, y=y, edit_gt=gt_latent,
            edit_mask=mask, generator=torch.Generator(device="cuda").manual_seed(seed))
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
    results = []
    for batch_rolls in (rolls, chain(sc, seed=1)[3]):
        arr = finalize_decoded_sample(batch_rolls.float().cpu().numpy())
        generated = torch.as_tensor(arr.astype(np.float32) / NORM_SCALE - 1.0,
                                    device="cuda")
        results += rule_results(generated[..., cols], rules)
    write_table(os.path.join(out_dir, "results.csv"), results)
    write_summary(os.path.join(out_dir, "summary.csv"), summarize_losses(results))
    print(f"edit tables: results.csv ({len(results)} rows, a second batch "
          f"unmeasured) and summary.csv in {os.path.basename(out_dir)}/")
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
    # each DPS step differentiates XL_8, and the decoder or the classifiers:
    # one backward call per block, per classifier block and per decoder norm
    check_launches(launches, {
        "flash_attention": len(dit.blocks) * (2 * steps + guided)
        + cls_blocks * steps,
        "flash_attention_fp32": 0,
        "flash_attention_bwd": (len(dit.blocks) + cls_blocks) * steps,
        "groupnorm_swish": norm_calls(vae.decoder) * (dps_decodes + guided + 1),
        "groupnorm_swish_bwd": norm_calls(vae.decoder) * dps_decodes})
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
        "--num_samples", "2", "--class_cond", "True", "--timestep_respacing",
        steps, "--out_dir", out]
    rows, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_rule.main(argv("10", out)),
        lambda: sample_rule.main(argv("2", out + "_warm")))
    print(f"sample_rule.main, scg_classifier_all with --data_dir: {wall:.3f} s "
          f"for one batch of 2 (model building included), peak {peak:.2f} GiB")
    check_launches(launches, {"flash_attention": 28 * (10 + 9) + 3 * 12 * 10,
                              "flash_attention_fp32": 0,
                              "flash_attention_bwd": 3 * 12 * 10,
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
    # fp32 weights: every attention call takes the fp32 kernel (3xTF32)
    check_launches(launches["edit"], {
        "flash_attention": 0, "flash_attention_fp32": 2 * (5 + 4),
        "groupnorm_swish": enc_calls + dec_calls * 4})
    check_launches(launches["dps"], {
        "flash_attention": 0, "flash_attention_fp32": 2 * 2 * steps,
        "flash_attention_bwd_fp32": 2 * steps,
        "groupnorm_swish": dec_calls * steps, "groupnorm_swish_bwd": dec_calls * steps})


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
    out["at_edm_ring"] = dict(
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
        "flash_attention_bwd": cls_blocks * steps,
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
        "--class_cond", "True", "--timestep_respacing", steps, "--out_dir", out]
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
        "flash_attention_fp32": 0, "flash_attention_bwd": 12 * n_cls * steps,
        "groupnorm_swish": 29 * (guided + 1)})
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
        "flash_attention_fp32": 0, "flash_attention_bwd": cls_blocks * steps,
        "groupnorm_swish": 29})
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
    # each worker call: one forward and one backward call per block; one
    # decode of the merged circle
    check_launches(launches, {"flash_attention": len(dit.blocks) * calls,
                              "flash_attention_fp32": 0,
                              "flash_attention_bwd": len(dit.blocks) * calls,
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


def unet_defaults(torch, pipeline, dtype):
    """sample_pixel's UNet at its defaults (128 channels, mult (1,1,2,3,4),
    2 res blocks, attention at 128 // (32, 16, 8), 3 classes), seeded
    random weights (no zero-initialised layer), in ``dtype`` on the card."""
    unet = pipeline.create_unet(dtype=torch.float32, device="cuda",
                                attention_resolutions=(4, 8, 16), num_classes=3)
    pipeline.randomize_(unet, seed=4)
    return unet.to(dtype)


def check_pixel_kernels(torch, fa, gn, F, pipeline):
    """Kernel 1 at the pixel paths' shapes in both dtypes (timed in bf16);
    kernel 2 on every call of one forward of sample_pixel's UNet (B=2,
    bf16, eps 1e-5), with the forward's launches of both kernels."""
    out = {}
    for i, shape in enumerate(PIXEL_ATTN_SHAPES):
        label = ("2-D DiT-B/8 under CFG" if shape[2] == 12
                 else f"UNet at N={shape[1]}, D={shape[3]}, B={shape[0]}")
        out[str(shape)] = check_attention_at(torch, fa, F, shape, label,
                                             (torch.float32, torch.bfloat16),
                                             seed=30 + i)
        torch.cuda.empty_cache()
    unet = unet_defaults(torch, pipeline, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(36)
    x = torch.randn((2, 3, 128, 128), generator=gen, device="cuda")
    t = torch.full((2,), 500.0, device="cuda")
    y = torch.full((2,), 1, dtype=torch.long, device="cuda")
    reset_counts(fa, gn)
    calls, launches = capture_norm_inputs(torch, gn, unet, lambda: unet(x, t, y))
    attn = fa.kernel_launches["flash_attention"]
    if (len(calls), launches, attn) != (UNET_GN_PER_FORWARD, UNET_GN_PER_FORWARD,
                                        UNET_ATTN_PER_FORWARD):
        raise AssertionError(f"UNet forward: {len(calls)} norm calls, {launches} "
                             f"kernel-2 and {attn} kernel-1 launches, expected "
                             f"{UNET_GN_PER_FORWARD} / {UNET_GN_PER_FORWARD} / "
                             f"{UNET_ATTN_PER_FORWARD}")
    if any(mod.eps != 1e-5 for _, mod in calls):
        raise AssertionError("a UNet GroupNorm+swish call does not use eps 1e-5")
    print(f"one UNet forward (B=2, bf16): {attn} flash_attention and {launches} "
          f"groupnorm_swish launches (expected {UNET_ATTN_PER_FORWARD} and "
          f"{UNET_GN_PER_FORWARD}), eps 1e-5")
    out["at_unet_forward"] = check_norm_calls(
        torch, gn, calls, "one UNet forward at eps 1e-5", launches)
    return out


def print_breakdown(torch, parts):
    for name, fn in parts.items():
        with torch.no_grad():
            print(f"breakdown {name}: {cuda_time_ms(fn, reps=3, warmup=1):.2f} ms")


def check_midis(out, n_files, columns):
    """The MIDI files under ``out``: ``n_files`` of them, read back, at
    most ``columns`` roll columns long at fs=12.5."""
    from rule_guided_music_tpu_torch.data.midi_io import read_midi
    from rule_guided_music_tpu_torch.data.pianoroll import midi_to_roll

    midis = sorted(x for x in os.listdir(out) if x.endswith(".midi"))
    cols = [midi_to_roll(read_midi(os.path.join(out, x)), fs=12.5).shape[-1]
            for x in midis]
    print(f"MIDI files {midis}, roll columns at fs=12.5 {cols} (at most "
          f"{columns})")
    if len(midis) != n_files or max(cols) > columns:
        raise AssertionError(f"{out}: {len(midis)} MIDI files, columns {cols}")


def pixel_scg_path(torch, port, tmp):
    """pixel.sample_pixel at its defaults with --scg True (k=4, B=2) on a
    10-step chain: the CLI's own build with seeded random UNet weights, a
    measured batch (ms per guided step, peak, launches against the shapes:
    16 kernel-1 and 28 kernel-2 launches per UNet forward, one forward per
    step and one k*B=8 rollout per guided step), the batch written as
    MIDI, a breakdown; then ``sample_pixel.main`` itself (models built
    inside) with its launches and MIDI files."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.pixel import sample_pixel
    from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT, LOSS_DICT

    pipeline = port["pipeline"]
    argv = ["--scg", "True", "--num_samples", "2", "--timestep_respacing",
            PIXEL_RESPACING]
    args = sample_pixel.create_argparser().parse_args(argv)
    run = sample_pixel.build(args)
    pipeline.randomize_(run.model, seed=5)
    warm = replace_ns(run, tables=make_schedule("linear", 1000, "2").tables("cuda"))
    rolls, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_pixel.sample_batch(run),
        lambda: sample_pixel.sample_batch(warm))
    steps = int(PIXEL_RESPACING)
    guided = n_guided(run.config, steps)
    k = run.config.scg.num_samples
    print(f"sample_pixel --scg True: UNet at the defaults, k={k}, B=2, {steps} "
          f"steps ({guided} guided): chain {wall:.3f} s, "
          f"{1e3 * wall / guided:.1f} ms per guided step; peak {peak:.2f} GiB")
    forwards = steps + guided
    check_launches(launches, {
        "flash_attention": UNET_ATTN_PER_FORWARD * forwards,
        "flash_attention_fp32": 0, "groupnorm_swish": UNET_GN_PER_FORWARD * forwards})
    if tuple(rolls.shape) != (2, 3, 128, 128) or not torch.isfinite(rolls).all():
        raise AssertionError("sample_pixel: wrong shape or non-finite rolls")
    out = os.path.join(tmp, "pixel_batch")
    sample_pixel.save_rolls(args, rolls, run.y, out, 0)
    check_midis(out, 2, 128)
    x2 = torch.randn((2, 3, 128, 128), device="cuda")
    x8 = torch.randn((2 * k, 3, 128, 128), device="cuda")
    t2, t8 = (torch.full((n,), 500.0, device="cuda") for n in (2, 2 * k))
    y8 = torch.full((2 * k,), 1, dtype=torch.long, device="cuda")
    target = run.rules["note_density_pixel"].repeat(k, 1)
    print_breakdown(torch, {
        "UNet trajectory call (B=2)": lambda: run.model(x2, t2, run.y),
        f"UNet rollout call (k*B={2 * k})": lambda: run.model(x8, t8, y8),
        f"note_density_pixel + loss ({2 * k} rolls)": lambda: LOSS_DICT[
            "note_density_pixel"](FUNC_DICT["note_density_pixel"](x8), target)})
    del run, warm
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "pixel_cli")
    _, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_pixel.main(argv + ["--out_dir", out]),
        lambda: None)
    print(f"sample_pixel.main --scg True: {wall:.3f} s for one batch of 2 "
          f"(UNet built inside, at its initialisation), peak {peak:.2f} GiB")
    check_launches(launches, {
        "flash_attention": UNET_ATTN_PER_FORWARD * forwards,
        "flash_attention_fp32": 0, "groupnorm_swish": UNET_GN_PER_FORWARD * forwards})
    check_midis(out, 2, 128)
    return launches


def replace_ns(ns, **kw):
    from types import SimpleNamespace

    return SimpleNamespace(**{**vars(ns), **kw})


def pixel_cfg_path(torch, port, sampler, tmp):
    """pixel.cfg_sample_pixel (DiT-B/8 2-D on (3, 128, 128), CFG w=4, B=2,
    bf16) on a 10-step chain of ``sampler``: the CLI's build with seeded
    random weights, a measured batch (ms per step, launches: 12 per step,
    both CFG halves in one call), its MIDI; then ``cfg_sample_pixel.main``
    itself with its launches and MIDI files."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.pixel import cfg_sample_pixel

    pipeline = port["pipeline"]
    respacing = f"ddim{PIXEL_RESPACING}" if sampler == "ddim" else PIXEL_RESPACING
    argv = ["--sampler", sampler, "--num_samples", "2", "--timestep_respacing",
            respacing]
    args = cfg_sample_pixel.create_argparser().parse_args(argv)
    run = cfg_sample_pixel.build(args)
    pipeline.randomize_(run.model, seed=6)
    warm_spacing = "ddim2" if sampler == "ddim" else "2"
    warm = replace_ns(run, tables=make_schedule("linear", 1000, warm_spacing)
                      .tables("cuda"))
    rolls, wall, launches, peak = measured_chain(
        torch, port, lambda: cfg_sample_pixel.sample_batch(run),
        lambda: cfg_sample_pixel.sample_batch(warm))
    steps = int(PIXEL_RESPACING)
    blocks = len(run.model.blocks)
    print(f"cfg_sample_pixel --sampler {sampler}: DiT-B/8, CFG w=4, B=2, "
          f"{steps} steps: chain {wall:.3f} s, {1e3 * wall / steps:.1f} ms per "
          f"step; peak {peak:.2f} GiB")
    check_launches(launches, {"flash_attention": blocks * steps,
                              "flash_attention_fp32": 0, "groupnorm_swish": 0})
    if tuple(rolls.shape) != (2, 3, 128, 128) or not torch.isfinite(rolls).all():
        raise AssertionError("cfg_sample_pixel: wrong shape or non-finite rolls")
    out = os.path.join(tmp, f"pixel_cfg_{sampler}_batch")
    cfg_sample_pixel.save_rolls(args, rolls, run.y, out, 0)
    check_midis(out, 2, 128)
    x = torch.randn((2, 3, 128, 128), device="cuda")
    t = torch.full((2,), 500.0, device="cuda")
    print_breakdown(torch, {"DiT-B/8 CFG call (2B=4, 256 tokens)":
                            lambda: run.model_fn(x, t, run.y)})
    del run, warm
    out = os.path.join(tmp, f"pixel_cfg_{sampler}_cli")
    _, wall, launches, peak = measured_chain(
        torch, port, lambda: cfg_sample_pixel.main(argv + ["--out_dir", out]),
        lambda: None)
    print(f"cfg_sample_pixel.main --sampler {sampler}: {wall:.3f} s for one "
          f"batch of 2 (DiT built inside, at its initialisation), peak "
          f"{peak:.2f} GiB")
    check_launches(launches, {"flash_attention": blocks * steps,
                              "flash_attention_fp32": 0, "groupnorm_swish": 0})
    check_midis(out, 2, 128)
    return launches


def quant_path(torch, port, m, qdits):
    """The main path's SCG chain (scg.yml, k=16, B=2, 10 steps) with the
    fp XL_8 trunk and with each int8 trunk, in one call: ms per guided
    step, peak, launches (unchanged); then the trunk's calls and its four
    linears at B=2 and k*B=32, and what w8a16's per-call bf16 weight
    costs."""
    from rule_guided_music_tpu_torch.ops import quant

    steps_ms, launches = {}, {}
    for label, dit in (("fp", m["dit"]), *qdits.items()):
        print(f"-- trunk {label}")
        launches[label], _, steps_ms[label] = run_chain(
            torch, port, {**m, "dit": dit}, sampler_config())
    print("ms per guided step, the same chain and weights: " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps_ms.items()))
    gen = torch.Generator(device="cuda").manual_seed(40)
    for n in (2, 32):
        x = torch.randn((n, 4, 128, 16), generator=gen, device="cuda")
        t = torch.full((n,), 500.0, device="cuda")
        y = torch.full((n,), 1, dtype=torch.long, device="cuda")
        print_breakdown(torch, {f"XL_8 call at B={n}, trunk {label}":
                                (lambda d=dit: d(x, t, y))
                                for label, dit in (("fp", m["dit"]),
                                                   *qdits.items())})
    rows = {}
    for tokens in (512, 8192):
        total = dict.fromkeys(("bf16", "w8a16", "w8a8", "cast"), 0.0)
        for k_in, n_out in XL_LINEARS:
            x = torch.randn((tokens, k_in), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            w = torch.randn((n_out, k_in), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            w8 = torch.randint(-127, 128, (n_out, k_in), generator=gen,
                               device="cuda", dtype=torch.int8)
            sc = torch.rand(n_out, generator=gen, device="cuda") / 127
            b = torch.zeros(n_out, device="cuda")
            bb = b.to(torch.bfloat16)
            with torch.no_grad():
                ms = {"bf16": cuda_time_ms(lambda: torch.nn.functional.linear(x, w, bb)),
                      "w8a16": cuda_time_ms(lambda: quant.wo_dense_apply(x, w8, sc, b)),
                      "w8a8": cuda_time_ms(lambda: quant.quant_dense_apply(x, w8, sc, b)),
                      "cast": cuda_time_ms(lambda: w8.to(torch.bfloat16))}
            print(f"  linear {k_in}->{n_out} at {tokens} tokens: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()))
            for key in total:
                total[key] += 28 * ms[key]
        rows[tokens] = total
        print(f"XL_8 trunk linears per forward at {tokens} tokens (28 blocks x 4; "
              f"CUDA events): bf16 {total['bf16']:.2f} ms, w8a16 "
              f"{total['w8a16']:.2f} ms (of which the int8 -> bf16 weight "
              f"cast {total['cast']:.2f} ms), w8a8 {total['w8a8']:.2f} ms")
    # _int_mm's small-M padding: 16 rows padded to 17 against 32 rows
    x16, x32 = (torch.randn((m_rows, 64), generator=gen, device="cuda")
                for m_rows in (16, 32))
    w8 = torch.randint(-127, 128, (192, 64), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand(192, generator=gen, device="cuda") / 127
    pad = {n: cuda_time_ms(lambda xx=xx: quant.quant_dense_apply(xx, w8, sc))
           for n, xx in ((16, x16), (32, x32))}
    print(f"w8a8 linear 64->192 (XS_8's qkv): 16 rows (padded to 17) "
          f"{pad[16]:.4f} ms, 32 rows {pad[32]:.4f} ms")
    return launches, steps_ms, rows


def quant_cli_path(torch, port, mode, tmp):
    """``sample_rule.main --quant <mode>`` on scg.yml (as JSON) at full
    width: XL_8 at its initialisation, quantized, and the production
    decoder, bf16, k=16, B=2, a 10-step chain: launches as the fp trunk's,
    results.csv, summary.csv and the MIDI files."""
    from rule_guided_music_tpu_torch import sample_rule

    config = os.path.join(tmp, "scg.json")
    with open(config, "w") as f:
        json.dump(YAML_TREES["cond_table/all/scg.yml"], f)
    out = os.path.join(tmp, f"quant_{mode}")
    argv = ["--config_path", config, "--batch_size", "2", "--num_samples", "2",
            "--class_cond", "True", "--timestep_respacing", "10", "--quant", mode,
            "--out_dir", out]
    # no warm-up: the int8 chain has just run every shape of this path
    rows, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_rule.main(argv), lambda: None)
    print(f"sample_rule.main --quant {mode} on scg.yml: {wall:.3f} s for one batch of 2 (models built and "
          f"quantized inside), peak {peak:.2f} GiB")
    check_launches(launches, {"flash_attention": 28 * (10 + 9),
                              "flash_attention_fp32": 0,
                              "groupnorm_swish": 29 * (9 + 1)})
    midis = [x for x in os.listdir(out) if x.endswith(".midi")]
    if len(rows) != 2 or len(midis) != 2 or not os.path.exists(
            os.path.join(out, "summary.csv")):
        raise AssertionError(f"--quant {mode}: results, summary or MIDI missing")
    return launches


def check_quant_linear(torch):
    """QuantLinear on the card against the port's CPU QuantLinear on the
    same fp32 inputs and buffers, both modes, at XL_8's qkv (512 tokens)
    and XS_8's qkv at 16 tokens (the padded _int_mm call); fp32 without
    TF32. Returns the worst error over the largest output per mode."""
    from rule_guided_music_tpu_torch.ops.quant import QuantLinear

    gen = torch.Generator().manual_seed(41)
    worst = dict.fromkeys(QUANT_MODES, 0.0)
    with no_tf32(torch), torch.no_grad():
        for (k_in, n_out), tokens in (((1152, 3456), 512), ((64, 192), 16)):
            for mode in QUANT_MODES:
                lin = QuantLinear(k_in, n_out, mode=mode)
                lin.weight.copy_(torch.randint(-127, 128, (n_out, k_in),
                                               generator=gen, dtype=torch.int8))
                lin.scale.copy_(torch.rand(n_out, generator=gen) / 127)
                lin.bias.copy_(0.1 * torch.randn(n_out, generator=gen))
                x = torch.randn((1, tokens, k_in), generator=gen)
                want = lin(x)
                got = lin.to("cuda")(x.to("cuda")).cpu()
                err = ((got - want).abs().max() / want.abs().max()).item()
                worst[mode] = max(worst[mode], err)
                print(f"QuantLinear {mode} {k_in}->{n_out} at {tokens} tokens, "
                      f"card vs CPU (fp32): error over the largest output "
                      f"{err:.3e} (tol {QUANT_LINEAR_TOL[mode]:.0e})")
                if err > QUANT_LINEAR_TOL[mode]:
                    raise AssertionError(f"QuantLinear {mode}: card vs CPU {err}")
    return worst


def quant_envelope_on_card(torch, port):
    """quality_tiny's XS_8 with its trunk quantized, on the card in fp32
    without TF32: eps against the fp trunk's within JAX's envelope at four
    steps of a 16-step chain (tests/test_quant.py's inputs drawn by numpy),
    and against the CPU's quantized model."""
    import numpy as np

    pipeline = port["pipeline"]
    fixture = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (4, 4, 128, 16)).astype(np.float32))
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    out = {}
    with no_tf32(torch), torch.no_grad():
        fp = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                      model_path=fixture, dtype=torch.float32,
                                      device="cuda")
        for mode in QUANT_MODES:
            models = {dev: pipeline.create_denoiser(
                "DiTRotary_XS_8", num_classes=0, model_path=fixture,
                dtype=torch.float32, device=dev, quant=mode)
                for dev in ("cpu", "cuda")}
            env = agree = 0.0
            for t_val in (2, 7, 12, 15):
                t = torch.full((4,), t_val)
                e_q = models["cuda"](x.cuda(), t.cuda())
                env = max(env, rel(e_q, fp(x.cuda(), t.cuda())))
                agree = max(agree, rel(e_q.cpu(), models["cpu"](x, t)))
            print(f"quality_tiny XS_8 {mode} on the card: eps against the fp "
                  f"trunk {env:.4e} (JAX's envelope {QUANT_ENVELOPE[mode]}), "
                  f"against the CPU's {mode} model {agree:.3e} (tol "
                  f"{QUANT_AGREE_TOL[mode]:.0e})")
            if env >= QUANT_ENVELOPE[mode] or agree > QUANT_AGREE_TOL[mode]:
                raise AssertionError(f"{mode}: envelope {env}, card vs CPU {agree}")
            out[mode] = dict(envelope=env, card_vs_cpu=agree)
    return out


TINY_UNET = dict(in_channels=3, model_channels=8, out_channels=3,
                 num_res_blocks=1, attention_resolutions=(2, 4),
                 channel_mult=(1, 2, 2), num_heads=2, num_classes=3)
TINY_DIT2D = dict(input_size=(16, 16), patch_size=4, in_channels=3,
                  hidden_size=64, depth=2, num_heads=2, num_classes=3)


def pixel_card_vs_cpu(torch, port):
    """A small UNet (SCG k=4 on note_density_pixel, (3, 32, 32)) and a
    small 2-D DiT (CFG w=4, DDIM, (3, 16, 16)) with seeded random weights,
    fp32 without TF32, card against CPU with the same noise: one forward
    within LONGFORM_AGREE_TOL of its largest value, and a 4-step chain
    (the same picks; final rolls within EDIT_DPS_AGREE_TOL of the largest
    magnitude); launches of the card's forward against the modules."""
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)
    from rule_guided_music_tpu_torch.diffusion.guidance import make_model_fn
    from rule_guided_music_tpu_torch.diffusion.sampling import sample_loop
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.models.dit import DiT
    from rule_guided_music_tpu_torch.models.unet import AttentionBlock, UNetModel

    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    cpu_unet = pipeline.randomize_(UNetModel(**TINY_UNET), seed=42)
    cpu_dit = pipeline.randomize_(DiT(**TINY_DIT2D), seed=43)
    scg = SamplerConfig(
        guidance=GuidanceConfig(method="no_guidance", schedule=True, t_start=4),
        scg=SCGConfig(num_samples=4, weights=(("note_density_pixel", 1.0),)),
        record=True)
    gen = torch.Generator().manual_seed(44)
    xu, xd = torch.randn((2, 3, 32, 32), generator=gen), torch.randn(
        (2, 3, 16, 16), generator=gen)
    t, y = torch.tensor([40.0, 730.0]), torch.tensor([1, 2])
    cases = {"UNet": (cpu_unet, xu, scg, "4", lambda m: m),
             "2-D DiT": (cpu_dit, xd, SamplerConfig(sampler="ddim", eta=1.0),
                         "ddim4", lambda m: make_model_fn(m, 3, cfg=True, w=4.0))}
    out = {}
    with no_tf32(torch), torch.no_grad():
        for name, (cpu_model, x, config, spacing, wrap) in cases.items():
            noise_for = replay_noise(torch, 45)
            res = {}
            for dev in ("cpu", "cuda"):
                model = cpu_model if dev == "cpu" else type(cpu_model)(
                    **(TINY_UNET if name == "UNet" else TINY_DIT2D)).to(dev)
                model.load_state_dict(cpu_model.state_dict())
                reset_counts(fa, gn)
                eps = model(x.to(dev), t.to(dev), y.to(dev)).cpu()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches = read_counts(fa, gn)
                tables = make_schedule("linear", 1000, spacing).tables(dev)
                rolls, rec = sample_loop(
                    wrap(model), tuple(x.shape), tables, config,
                    noise_fn=noise_for(dev), y=y.to(dev),
                    rules={"note_density_pixel": torch.full(
                        (2, 2 * x.shape[-1] // 16), 2.0, device=dev)},
                    decode_fn=lambda v: v)
                picks = rec.get("candidate_log_prob")
                res[dev] = (eps, rolls.cpu(),
                            None if picks is None else picks.argmax(1).cpu())
            fwd = ((res["cuda"][0] - res["cpu"][0]).abs().max()
                   / res["cpu"][0].abs().max()).item()
            chain = ((res["cuda"][1] - res["cpu"][1]).abs().max()
                     / res["cpu"][1].abs().max()).item()
            same = res["cpu"][2] is None or torch.equal(res["cpu"][2], res["cuda"][2])
            n_attn = (sum(isinstance(m, AttentionBlock) for m in cpu_model.modules())
                      if name == "UNet" else len(cpu_model.blocks))
            n_gn = norm_calls(cpu_model)
            print(f"small {name}, card vs CPU (fp32): forward {fwd:.3e} (tol "
                  f"{LONGFORM_AGREE_TOL:.0e}), 4-step chain {chain:.3e} (tol "
                  f"{EDIT_DPS_AGREE_TOL:.0e}), picks equal {same}")
            check_launches(launches, {"flash_attention": 0,
                                      "flash_attention_fp32": n_attn,
                                      "groupnorm_swish": n_gn})
            if fwd > LONGFORM_AGREE_TOL or chain > EDIT_DPS_AGREE_TOL or not same:
                raise AssertionError(f"small {name}: card disagrees with the CPU")
            out[name] = dict(forward=fwd, chain=chain)
    return out


def chord_tags_agree(torch, rolls, a, b, fs=100, window=1.28):
    """Chord tags ``a`` and ``b`` of the CPU ``rolls`` equal, except in
    windows whose best triads tie in float64, where each may be any tied
    triad's tag (ROADMAP 3.1); returns how many windows differed at a
    tie and raises at any other difference."""
    import numpy as np

    from rule_guided_music_tpu_torch.rules import chord

    a, b = np.asarray(a), np.asarray(b)
    mismatches = np.argwhere(a != b)
    if not len(mismatches):
        return 0
    active = chord._active_notes(rolls).numpy().astype(np.float64)
    tonic = chord.classify_keys(rolls, fs=fs)[2].numpy() % 12
    cols = int(round(window * fs))
    norms = np.linalg.norm(chord._TRIADS, axis=1)
    for i, w in mismatches:
        counts = active[i, :, w * cols:(w + 1) * cols].sum(axis=-1)
        chroma = np.bincount(np.arange(128) % 12, weights=counts, minlength=12)
        scores = chord._TRIADS @ chroma / norms
        tied = np.flatnonzero(scores == scores.max())
        tags = set(chord._SEMITONE2DEGREE[(tied % 12 - tonic[i]) % 12].tolist())
        if len(tied) < 2 or a[i, w] not in tags or b[i, w] not in tags:
            raise AssertionError(f"chord tag of file {i}, window {w} differs "
                                 f"outside an exact tie: {a[i, w]} vs {b[i, w]}")
    return len(mismatches)


def rules_agree(torch, card, cpu, rolls):
    """compute_rule's values on the card against the CPU's on the same
    files: the float rules within EVAL_RULE_AGREE_TOL, chord tags up to
    exact ties. Returns (largest float difference, tags differing at a tie)."""
    import numpy as np

    if card["file"] != cpu["file"]:
        raise AssertionError("compute_rule read other files on the card")
    worst, ties = 0.0, 0
    for rule in EVAL_RULES:
        a, b = np.asarray(card[rule]), np.asarray(cpu[rule])
        if a.shape != b.shape:
            raise AssertionError(f"{rule}: shapes {a.shape} vs {b.shape}")
        if "chord" in rule:
            ties += chord_tags_agree(torch, rolls, a, b)
        else:
            worst = max(worst, float(np.abs(a - b).max()))
    if worst > EVAL_RULE_AGREE_TOL:
        raise AssertionError(f"compute_rule: card and CPU differ by {worst:.3e}")
    return worst, ties


def round_trip_checks(rule, gen_cli, gen_sampler, target, loss):
    """tests/test_cli_eval_chain.py's asserts after compute_rule, for one
    sample, in two groups: the contract (shapes, finite values, chord tags
    in the vocabulary, the sampler's .loss against its own gen_rule), which
    holds for any excerpt; and the MIDI round-trip envelopes (the rule
    recomputed from the written MIDI against the sampler's self-report),
    which that test measured on the trained fixture's excerpts. Returns
    (contract failures, envelope failures)."""
    import numpy as np
    import torch

    from rule_guided_music_tpu_torch.rules.registry import LOSS_DICT

    def loss_of(gen):
        cast = torch.int32 if "chord" in rule else torch.float32
        return float(LOSS_DICT[rule](torch.as_tensor(gen[None]).to(cast),
                                     torch.as_tensor(target[None]).to(cast)))

    if gen_cli.shape != gen_sampler.shape or not np.isfinite(gen_cli).all():
        return ["shape or finite values"], []
    contract, envelope = [], []
    if not np.isclose(loss_of(gen_sampler), loss, rtol=1e-3, atol=1e-3):
        contract.append("the sampler's .loss against its gen_rule (1e-3)")
    if rule == "pitch_hist":
        if not np.allclose(gen_cli, gen_sampler, rtol=0, atol=0.06):
            envelope.append("pitch_hist (atol 0.06)")
        if not np.isclose(loss_of(gen_cli), loss, rtol=0.3, atol=0.05):
            envelope.append("pitch_hist loss (rtol 0.3, atol 0.05)")
    elif rule == "note_density":
        n = gen_cli.shape[0] // 2
        if not np.allclose(gen_cli[:n], gen_sampler[:n], rtol=0.2, atol=3.0):
            envelope.append("vertical density (rtol 0.2, atol 3)")
        if (gen_cli[n:] < 0).any():
            contract.append("horizontal density below 0")
        if (gen_cli[n:] > gen_sampler[n:] + 1.0).any():
            envelope.append("horizontal density above the sampler's + 1")
    elif (gen_cli != np.round(gen_cli)).any() or gen_cli.min() < 0 or \
            gen_cli.max() > max(float(gen_sampler.max()), 96.0):
        contract.append("chord tags outside the vocabulary")
    return contract, envelope


def eval_flagship_rules(torch, cli_out, root):
    """Evaluation step 1: compute_rule on the flagship CLI's MIDI, on the
    card and with --device cpu; the two agree, and the values meet the JAX
    chain test's contract against the sampler's own results.csv. Its MIDI
    round-trip envelopes are printed, not held: the flagship runs seeded
    random weights, and the envelopes were measured on the trained
    fixture's excerpts (tests/test_torch_eval_chain.py holds them there)."""
    import ast

    import numpy as np

    from rule_guided_music_tpu_torch.constants import EXCERPT_COLS
    from rule_guided_music_tpu_torch.eval_results import compute_rule
    from rule_guided_music_tpu_torch.utils.tables import read_table

    outs = {d: os.path.join(root, f"computed_rules_{d}.csv") for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    card = compute_rule.main(["--midi_dir", cli_out, "--out", outs["cuda"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = compute_rule.main(["--midi_dir", cli_out, "--out", outs["cpu"],
                             "--device", "cpu"])
    files = compute_rule.midi_files(cli_out)
    rolls = compute_rule.load_batch(files, EXCERPT_COLS, "cpu")
    worst, ties = rules_agree(torch, card, cpu, rolls)
    results = read_table(os.path.join(cli_out, "results.csv"))
    n = len(results[f"{EVAL_RULES[0]}.loss"])
    want = sorted(f for f in os.listdir(cli_out) if f.endswith(".midi"))
    if card["file"] != want or len(want) != n:
        raise AssertionError(f"compute_rule files {card['file']} against {n} rows")
    contract, envelope = [], []
    for rule in EVAL_RULES:
        for i, name in enumerate(card["file"]):
            row = int(name.split("_")[1])      # sample_<i>[_y_<label>].midi
            cell = lambda col: np.asarray(ast.literal_eval(
                results[f"{rule}.{col}"][row]), dtype=np.float64)
            c, e = round_trip_checks(
                rule, np.asarray(card[rule][i], dtype=np.float64),
                cell("gen_rule"), cell("target_rule"),
                float(results[f"{rule}.loss"][row]))
            contract += [f"{name}: {x}" for x in c]
            envelope += [f"{name}: {x}" for x in e]
    notes = [int(rolls[i, 1].gt(0).sum()) for i in range(len(files))]
    print(f"compute_rule on the flagship CLI's {len(files)} MIDI files "
          f"({notes} onsets read back): {wall:.3f} s on the card ({CARD}); card "
          f"vs CPU: float rules within {worst:.2e} (tol {EVAL_RULE_AGREE_TOL:g}), "
          f"{ties} chord tags differing at exact ties; the JAX chain test's "
          f"contract against results.csv: {contract or 'held'}; its MIDI "
          f"round-trip envelopes on these random-weight excerpts: "
          f"{envelope or 'all within'}")
    if contract:
        raise AssertionError("compute_rule breaks the chain test's contract: "
                             + "; ".join(contract))


def write_eval_sets(root):
    """The two evaluation sets, EVAL_EXCERPTS 10.24 s excerpts each from
    make_rolls, written as MIDI through save_piano_roll_midi (set-up)."""
    from rule_guided_music_tpu_torch.data.pianoroll import (
        finalize_decoded_sample, save_piano_roll_midi)
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    t0 = time.perf_counter()
    sets = {}
    for name, seed in zip(("gen", "ref"), EVAL_SEEDS):
        sets[name] = os.path.join(root, name)
        save_piano_roll_midi(finalize_decoded_sample(
            make_rolls(EVAL_EXCERPTS, seed=seed)), sets[name], 100)
    print(f"set-up: 2 x {EVAL_EXCERPTS} MIDI files from make_rolls (seeds "
          f"{EVAL_SEEDS}) written in {time.perf_counter() - t0:.2f} s")
    return sets


def eval_full_size(torch, gen_dir, root):
    """Evaluation step 2: compute_rule on EVAL_EXCERPTS files in one
    batched call on the card: files per second, the host's read time, the
    rule call's device ms (CUDA events) against its bound, peak memory."""
    import numpy as np

    from rule_guided_music_tpu_torch.constants import EXCERPT_COLS
    from rule_guided_music_tpu_torch.eval_results import compute_rule

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = compute_rule.main(["--midi_dir", gen_dir, "--out",
                             os.path.join(root, "computed_rules_200.csv")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    shapes = {r: np.asarray(out[r]).shape for r in EVAL_RULES}
    if len(out["file"]) != EVAL_EXCERPTS or any(
            s[0] != EVAL_EXCERPTS or not np.isfinite(out[r]).all()
            for r, s in shapes.items()):
        raise AssertionError(f"compute_rule at full size: {shapes}")
    files = compute_rule.midi_files(gen_dir)
    t0 = time.perf_counter()
    batch = compute_rule.load_batch(files, EXCERPT_COLS, "cuda")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    vals = compute_rule.rule_values(batch, EVAL_RULES)
    device_ms = cuda_time_ms(lambda: compute_rule.rule_values(batch, EVAL_RULES),
                             reps=5, warmup=1)
    nbytes = batch.numel() * batch.element_size() + sum(
        v.numel() * v.element_size() for v in vals.values())
    bound = bound_ms(nbytes, 0, "float32")
    print(f"compute_rule, {EVAL_EXCERPTS} files ({tuple(batch.shape)} fp32, "
          f"{nbytes / 2**20:.1f} MiB) on {CARD}: {wall:.3f} s, "
          f"{EVAL_EXCERPTS / wall:.1f} files/s; host read + rasterize + copy "
          f"{host_s:.3f} s; the rule call {device_ms:.3f} ms on the device "
          f"(CUDA events; bound {bound:.4f} ms, the bytes over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak {peak:.1f} MiB above the "
          f"resident models (torch.cuda.max_memory_allocated)")
    return dict(files_per_s=EVAL_EXCERPTS / wall, wall_s=wall, host_s=host_s,
                device_ms=device_ms, bound_ms=bound, peak_mib=peak)


def eval_rule_tables(torch, root):
    """Evaluation step 3: eval_rule over the run's output root, one row
    per results.csv that the earlier phases wrote, each .loss mean equal
    to that directory's summary.csv Mean."""
    from rule_guided_music_tpu_torch.eval_results import eval_rule
    from rule_guided_music_tpu_torch.utils.tables import is_nan, read_table

    want = [os.path.relpath(d, root) for d, _, files in os.walk(root)
            if "results.csv" in files]
    t0 = time.perf_counter()
    rows = eval_rule.main(["--root", root, "--out",
                           os.path.join(root, "rule_table.csv")])
    wall = time.perf_counter() - t0
    if [r["method"] for r in rows] != want or not rows:
        raise AssertionError(f"eval_rule rows {[r['method'] for r in rows]}")
    worst = 0.0
    for r in rows:
        summary = read_table(os.path.join(root, r["method"], "summary.csv"))
        for attr, mean in zip(summary["Attr"], summary["Mean"]):
            got = r[attr + ".mean"]
            if is_nan(got) != is_nan(mean) or (
                    not is_nan(mean) and abs(got - mean) > EVAL_MEAN_TOL):
                raise AssertionError(f"eval_rule {r['method']} {attr}: "
                                     f"{got} vs summary.csv {mean}")
            if not is_nan(mean):
                worst = max(worst, abs(got - mean))
    print(f"eval_rule over the run's root: {len(rows)} results.csv in "
          f"{wall:.3f} s on the card's host ({CARD}); every .loss mean within "
          f"{worst:.1e} of its summary.csv (tol {EVAL_MEAN_TOL:g})")


def eval_quality_tables(torch, sets, root):
    """Evaluation step 4: eval_quality at --runs 1 on the two full sets
    (--max_files 200), then --runs 3 --subsample 32, eval_uncond and
    eval_uncond_summary on those files; KL finite, OA in [0, 1]."""
    import math

    from rule_guided_music_tpu_torch.eval_results import (eval_quality,
                                                          eval_uncond,
                                                          eval_uncond_summary)
    from rule_guided_music_tpu_torch.utils.tables import read_table, table_rows

    def check(rows, kl, oa, label):
        bad = [r for r in rows if not math.isfinite(r[kl])
               or not 0.0 <= r[oa] <= 1.0]
        if bad or not rows:
            raise AssertionError(f"{label}: KL not finite or OA outside [0, 1]: {bad}")

    flags = ["--generated_dir", sets["gen"], "--reference_dir", sets["ref"]]
    out = os.path.join(root, "quality")
    t0 = time.perf_counter()
    rows = eval_quality.main(flags + ["--out", out])
    t_one = time.perf_counter() - t0
    check(rows, "kl_divergence", "overlap_area", "--runs 1")
    if len(rows) != 7 or not os.path.exists(out + "_statistics.txt"):
        raise AssertionError("eval_quality --runs 1: files or rows missing")
    folder = os.path.join(root, "uncond", "d_m")
    t0 = time.perf_counter()
    eval_quality.main(flags + ["--out", os.path.join(folder, "quality"), "--runs",
                               "3", "--subsample", "32", "--dataset", "d",
                               "--method", "m"])
    t_runs = time.perf_counter() - t0
    check(table_rows(read_table(os.path.join(folder, "d.m.mean.csv"))), "KL",
          "OA", "--runs 3 mean")
    t0 = time.perf_counter()
    eval_uncond.main(["--path_to_folder", folder])
    eval_uncond_summary.main(["--path_to_folder", os.path.join(root, "uncond")])
    t_pivot = time.perf_counter() - t0
    summary = read_table(os.path.join(root, "uncond", "summary_mean.csv"))
    if summary.get("method") != ["m"] or not os.path.exists(
            os.path.join(folder, "results_std.csv")):
        raise AssertionError("eval_uncond / eval_uncond_summary: tables missing")
    print(f"eval_quality {EVAL_EXCERPTS} vs {EVAL_EXCERPTS} (7 features x "
          f"{2 * EVAL_EXCERPTS} file reads): {t_one:.3f} s; --runs 3 "
          f"--subsample 32: {t_runs:.3f} s; eval_uncond + eval_uncond_summary "
          f"{t_pivot:.3f} s; on the card's host ({CARD}); KL finite, OA in "
          f"[0, 1]; avg OA {rows and sum(r['overlap_area'] for r in rows) / 7:.4f}")


def eval_edit_bins(torch, edit_dir, root):
    """Evaluation step 5: edit_create_bins, then edit_accuracy, on the
    edit phase's results.csv."""
    import json

    from rule_guided_music_tpu_torch.eval_results import (edit_accuracy,
                                                          edit_create_bins)

    results = os.path.join(edit_dir, "results.csv")
    path = os.path.join(root, "nd_bins.json")
    t0 = time.perf_counter()
    edit_create_bins.main(["--file_name", results, "--out", path])
    hits, near, total = edit_accuracy.main(["--results", results])
    wall = time.perf_counter() - t0
    with open(path) as f:
        bins = json.load(f)
    shape = {k: len(v) for k, v in bins.items()}
    if any(shape[f"{axis}_bounds"] != 7 or shape[f"{axis}_centers"] != 8
           for axis in ("vertical", "horizontal")) or not total \
            or not 0 <= hits <= near <= total:
        raise AssertionError(f"edit bins {shape}, accuracy {hits}/{near}/{total}")
    print(f"edit_create_bins + edit_accuracy on the edit phase's results.csv: "
          f"{wall:.3f} s on the card's host ({CARD}); 7 bounds and 8 centres "
          f"per axis; bin accuracy {hits / total:.3f}, within one bin "
          f"{near / total:.3f}")


def eval_fad(torch, sets):
    """Evaluation step 6: compute_fad's proxy on the first FAD_FILES files
    of each set; --backend vggish raises the gate's error."""
    import math

    from rule_guided_music_tpu_torch.eval_results import compute_fad

    flags = ["--background_dir", sets["ref"], "--eval_dir", sets["gen"]]
    t0 = time.perf_counter()
    score = compute_fad.main(flags + ["--max_files", str(FAD_FILES)])
    wall = time.perf_counter() - t0
    if not math.isfinite(score) or score < 0:
        raise AssertionError(f"FAD proxy {score}")
    try:
        compute_fad.main(flags + ["--backend", "vggish"])
    except RuntimeError as e:
        if FAD_GATE_TEXT not in str(e):
            raise
        gate = str(e)
    else:
        raise AssertionError("compute_fad --backend vggish ran without its stack")
    print(f"compute_fad --backend proxy, {FAD_FILES} vs {FAD_FILES} files (cut "
          f"from {EVAL_EXCERPTS} for time): {score:.4f} in {wall:.3f} s on the "
          f"card's host ({CARD}); --backend vggish raised the gate's error: {gate}")


def write_train_manifest(prefix, n=TRAIN_ROLLS, length=TRAIN_ROLL_COLUMNS,
                         seed=51):
    """A training manifest as ``--data_dir`` names it: ``<prefix>_train.csv``
    listing ``n`` seeded uint8 rolls (.npy, ``length`` columns, room for
    the loader's +-5% time stretch of 2560) with labels 0, 1, 2, ..."""
    import csv

    import numpy as np

    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    rows = []
    for i, roll in enumerate(make_rolls(n, length=length, seed=seed)):
        path = f"{prefix}_train{i}.npy"
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, i % 3])
    with open(f"{prefix}_train.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return f"{prefix}_train.csv"


def check_training_kernels(torch, fa, gn, F):
    """Both backward kernels at the trainers' shapes: kernel 1 forward +
    backward and the backward alone at train_dit's (32,256,16,72) bf16
    beside SDPA, the plain versions and the bounds (its gradient there is
    checked in the kernel checks, GRAD_SHAPES), and two backward calls on
    the same inputs there bit-equal; kernel 2's backward with the weight
    and bias gradients on every GroupNorm+swish call of one train_vae step
    (the production VAE's encoder and decoder at 128 chunks, bf16 under
    autocast, fp32 masters): each call against autograd through the plain
    forward and the plain backward, each called twice bit-equal, then the
    50 calls' backward timed beside F.group_norm+F.silu autograd, the plain
    backward and the bound."""
    from rule_guided_music_tpu_torch import pipeline

    gen = torch.Generator(device="cuda").manual_seed(17)
    attn = time_attention_fwd_bwd(torch, fa, F, gen, TRAIN_ATTN_SHAPE,
                                  "train_dit's XL_8 at 32 latents")
    attn["bit_equal"] = attention_bwd_repeats(torch, fa, gen, TRAIN_ATTN_SHAPE)
    vae = pipeline.randomize_(pipeline.create_vae(encoder=True, dtype=torch.float32),
                              seed=5)
    x = torch.rand((TRAIN_VAE_CHUNKS, 3, 128, 128), generator=gen,
                   device="cuda") * 2 - 1
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, launches = capture_norm_inputs(torch, gn, vae,
                                              lambda: vae.reconstruct(x))
    del x
    if len(calls) != norm_calls(vae) or launches != len(calls):
        raise AssertionError(f"{len(calls)} norm calls, {launches} launches, "
                             f"{norm_calls(vae)} modules")
    worst = 0.0
    leaves = []
    for x, mod in calls:
        w, b = mod.weight.detach().to(x.dtype), mod.bias.detach().to(x.dtype)
        cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        ins = [t.detach().requires_grad_() for t in (x, w, b)]
        before = (gn.backward_launches, gn.param_grad_launches)
        got = torch.autograd.grad(gn.groupnorm_swish(*ins, mod.num_groups, 1e-6),
                                  ins, cot)
        if (gn.backward_launches, gn.param_grad_launches) != (before[0] + 1,
                                                              before[1] + 1):
            raise AssertionError("groupnorm_swish backward with dw/dbias: "
                                 "launches did not move by one each")
        fp32 = [t.detach().float().requires_grad_() for t in (x, w, b)]
        autograd = torch.autograd.grad(gn.groupnorm_swish_reference(
            *fp32, mod.num_groups, 1e-6), fp32, cot.float())
        del fp32
        plain = gn.groupnorm_swish_backward_reference(x, w, b, cot, mod.num_groups)
        worst = max(worst, *(max(rel_err(g, a), rel_err(g, p))
                             for g, a, p in zip(got, autograd, plain)))
        del got, autograd, plain
        leaves.append((ins, mod.num_groups, cot))
    del calls
    # a repeat of every call on the same inputs: bit-equal gradients
    same = True
    for ins, g, cot in leaves:
        first, second = (torch.autograd.grad(gn.groupnorm_swish(*ins, g, 1e-6),
                                             ins, cot) for _ in range(2))
        same = same and all(torch.equal(a, b) for a, b in zip(first, second))
        del first, second
    print(f"groupnorm_swish backward kernel with dw/dbias at train_vae's "
          f"{len(leaves)} call shapes, each called twice on the same inputs: "
          f"dx, dw and dbias bit-equal {same}")
    if not same:
        raise AssertionError("groupnorm_swish backward: a repeat call differs")
    ok = worst <= GRAD_TOL["bfloat16"]
    print(f"groupnorm_swish backward kernel with dw/dbias at train_vae's "
          f"{len(leaves)} call shapes ({TRAIN_VAE_CHUNKS} chunks, bf16), against "
          f"autograd through the plain forward and the plain backward: max abs "
          f"error over the largest gradient {worst:.2e} (tol "
          f"{GRAD_TOL['bfloat16']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("groupnorm_swish backward kernel disagrees at the "
                             "training shapes")

    def bwd(fn):
        outs = [(fn(*ins, g), ins, cot) for ins, g, cot in leaves]
        return lambda: [torch.autograd.grad(out, ins, cot, retain_graph=True)
                        for out, ins, cot in outs]

    before = gn.param_grad_launches
    ms = cuda_time_ms(bwd(gn.groupnorm_swish), reps=3, warmup=1)
    if gn.param_grad_launches - before != 4 * len(leaves):
        raise AssertionError("the timed backward calls did not each reduce dw/dbias")
    # the same calls with x alone wanting a gradient: no dw/dbias reduction
    outs = [(gn.groupnorm_swish(ins[0], ins[1].detach(), ins[2].detach(), g),
             ins[0], cot) for ins, g, cot in leaves]
    dx_ms = cuda_time_ms(lambda: [torch.autograd.grad(out, x, cot, retain_graph=True)
                                  for out, x, cot in outs], reps=3, warmup=1)
    del outs
    lib = cuda_time_ms(bwd(library_gn), reps=3, warmup=1)
    plain = cuda_time_ms(lambda: [gn.groupnorm_swish_backward_reference(
        *(t.detach() for t in ins), cot, g) for ins, g, cot in leaves],
        reps=3, warmup=1)
    elems = sum(ins[0].numel() for ins, _, _ in leaves)
    # x and dy read, dx written (bf16); dw and dbias are C-sized
    bnd, by = bound_and_kind(3 * elems * 2, 20 * elems, "float32")
    print(f"groupnorm_swish backward with dw/dbias, one train_vae step's "
          f"{len(leaves)} calls ({TRAIN_VAE_CHUNKS} chunks, {elems / 1e9:.3f} G "
          f"elements, bf16): kernel {ms:.4f} ms, F.group_norm+F.silu {lib:.4f} ms, "
          f"plain backward {plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"{100 * bnd / ms:.1f}% of the bound; the kernel's dx alone (no "
          f"reduction) {dx_ms:.4f} ms")
    gn_row = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                  bound_by=by, library_ms=lib, dx_alone_ms=dx_ms, bit_equal=same,
                  shape=f"train_vae's {len(leaves)} calls (encoder "
                        f"{norm_calls(vae.encoder)}, decoder "
                        f"{norm_calls(vae.decoder)}) on {TRAIN_VAE_CHUNKS} chunks, "
                        f"bf16, backward alone with dw/dbias")
    del leaves, vae
    torch.cuda.empty_cache()
    return attn, gn_row


def train_dit_path(torch, port, tmp):
    """``train_dit.main`` at the JAX script's defaults (DiTRotary_XL_8,
    batch 32, encode_rep 4, pr_image_size 2560, bf16, AdamW, EMA 0.9999,
    the production VAE encoder; seeded random weights, synthetic rolls):
    one warm-up step, five measured, one under torch.profiler (the
    profile_step path: the device's idle share), then the save. Every
    loss finite, no step skipped, the launches as the shapes predict;
    then one step more, timed in parts with CUDA events."""
    import csv

    import numpy as np

    from rule_guided_music_tpu_torch import train_dit

    fa, gn = port["fa"], port["gn"]
    data = write_train_manifest(os.path.join(tmp, "rolls"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    loop = train_dit.main(["--data_dir", data, "--dir", os.path.join(tmp, "train_dit"),
                           "--max_steps", str(TRAIN_DIT_STEPS), "--profile_step",
                           str(TRAIN_DIT_PROFILED), "--log_interval", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vae = loop.vae_encode.__self__
    blocks = len(loop.model.blocks)
    check_launches(launches, {
        "flash_attention": blocks * TRAIN_DIT_STEPS, "flash_attention_fp32": 0,
        "flash_attention_bwd": blocks * TRAIN_DIT_STEPS,
        "groupnorm_swish": norm_calls(vae.encoder) * TRAIN_DIT_STEPS})
    with open(os.path.join(tmp, "train_dit", "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if len(rows) != TRAIN_DIT_STEPS or not all(
            np.isfinite([losses, [float(r["grad_norm"]) for r in rows]]).ravel()):
        raise AssertionError(f"train_dit: {len(rows)} logged steps, losses {losses}")
    if loop.state.updates != TRAIN_DIT_STEPS:
        raise AssertionError(f"train_dit: {TRAIN_DIT_STEPS - loop.state.updates} "
                             f"steps skipped")
    ckpt = loop.latest_checkpoint(os.path.join(tmp, "train_dit", "checkpoints"))
    size = os.path.getsize(os.path.join(ckpt, "state.pt")) / 2 ** 30
    with open(os.path.join(ckpt, "SCHEMA")) as f:
        if f.read().strip() != loop.CKPT_SCHEMA:
            raise AssertionError(f"{ckpt}: wrong SCHEMA")
    shutil.rmtree(ckpt)             # 2.5 GiB of weights and 3 copies' worth more
    steps = loop.step_ms[TRAIN_DIT_MEASURED]
    ms = sum(steps) / len(steps)
    n_lat = 32
    trace = loop.trace
    print(f"train_dit XL_8, batch {n_lat} latents (8 rolls x 4 windows), bf16: "
          f"steps {', '.join(f'{v:.1f}' for v in loop.step_ms)} ms (warm-up first, "
          f"profiled last); {ms:.2f} ms per step over steps 1-5, "
          f"{1e3 * n_lat / ms:.1f} latents/s; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; peak {peak:.2f} GiB; "
          f"main {wall:.1f} s with the build and the save ({os.path.basename(ckpt)}, "
          f"{size:.2f} GiB)")
    if trace is None or not trace.events:
        raise AssertionError("the profiled step saw no device activity")
    print(f"train_dit profiled step (torch.profiler): {trace.wall_ms:.2f} ms wall, "
          f"device busy {trace.device_busy_ms:.2f} ms over {trace.events} device "
          f"events, idle share {trace.idle_share:.4f}")
    breakdown = train_step_breakdown(torch, loop)
    return launches, dict(ms_per_step=ms, steps_ms=loop.step_ms,
                          latents_per_s=1e3 * n_lat / ms, peak_gib=peak,
                          idle_share=trace.idle_share, losses=losses, **breakdown)


def train_step_breakdown(torch, loop):
    """One more train step of ``loop`` cut by CUDA events: the batch
    (loading, encode and get_kl_input, the draws), the forward with the
    loss, the backward, AdamW and the EMA."""
    from rule_guided_music_tpu_torch.diffusion import gaussian as gd
    from rule_guided_music_tpu_torch.training import train_loop as ttl

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    latents, _, t, _, w, y = loop._prepare_batch(*next(loop.data))
    noise, drop = loop.draw(latents, y)
    ev[1].record()
    cfg = loop.config
    terms = gd.training_losses(
        loop.tables, ttl._model_fn(loop.model, y, drop, torch.bfloat16), latents,
        t, noise, mean_type=cfg.mean_type, var_type=cfg.var_type,
        loss_type=cfg.loss_type)
    loss = (terms["loss"] * w).mean()
    ev[2].record()
    loss.backward()
    ev[3].record()
    loop.state.optimizer.step()
    ttl._ema_update(loop.state, cfg.ema_rate)
    ev[4].record()
    torch.cuda.synchronize()
    loop.state.optimizer.zero_grad(set_to_none=True)
    names = ("batch: load, encode + get_kl_input, draws", "forward + loss",
             "backward", "AdamW + EMA")
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    for n, v in parts.items():
        print(f"breakdown train_dit {n}: {v:.2f} ms")
    return {"breakdown_ms": parts}


def train_vae_path(torch, port, tmp):
    """``train_vae.main`` at the JAX script's defaults (the production f8
    KL-VAE, batch 128 chunks, L1 + KL, Adam (0.5, 0.9), bf16 compute) on
    seeded synthetic chunks, four steps: every loss finite, the kernel-2
    launches as the modules predict (each norm's forward, backward and
    dw/dbias reduction once per step)."""
    import numpy as np

    from rule_guided_music_tpu_torch import train_vae
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    fa, gn = port["fa"], port["gn"]
    chunk_dir = os.path.join(tmp, "chunks")
    os.makedirs(chunk_dir)
    rolls = make_rolls(TRAIN_VAE_CHUNKS // 8, length=1024, seed=61)
    for i, roll in enumerate(rolls):
        for j in range(8):
            np.save(os.path.join(chunk_dir, f"c{i:03d}_{j}.npy"), np.round(
                (roll[:, :, 128 * j:128 * (j + 1)] + 1.0) * 63.5).astype(np.uint8))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    vae, history = train_vae.main(["--chunk_dir", chunk_dir, "--dir",
                                   os.path.join(tmp, "train_vae"), "--iterations",
                                   str(TRAIN_VAE_STEPS), "--log_interval", "1"])
    torch.cuda.synchronize()
    launches = read_counts(fa, gn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    norms = norm_calls(vae) * TRAIN_VAE_STEPS
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": 0,
                              "groupnorm_swish": norms, "groupnorm_swish_bwd": norms,
                              "groupnorm_swish_param_grad": norms})
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"train_vae: a non-finite loss in {history}")
    steps = [h["ms"] for h in history]
    ms = sum(steps[1:]) / len(steps[1:])
    print(f"train_vae production KL-VAE, batch {TRAIN_VAE_CHUNKS} chunks, bf16: "
          f"steps {', '.join(f'{v:.1f}' for v in steps)} ms (warm-up first); "
          f"{ms:.2f} ms per step over steps 1-{len(steps) - 1}, "
          f"{1e3 * TRAIN_VAE_CHUNKS / ms:.1f} chunks/s; aeloss "
          f"{', '.join('%.4f' % h['aeloss'] for h in history)}; peak {peak:.2f} GiB")
    del vae
    torch.cuda.empty_cache()
    return launches, dict(ms_per_step=ms, steps_ms=steps, peak_gib=peak)


def train_model(torch, device, seed=3):
    """A class-conditional fp32 DiTRotary_XS_8 at fixture width with every
    parameter non-zero (JAX's init, then a seeded perturbation), the same
    weights on every device."""
    from rule_guided_music_tpu_torch.models.dit import DiT_models, init_weights_

    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(DiT_models["DiTRotary_XS_8"](num_classes=3), gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.to(device)


def _train_inputs(torch, seed, b=4):
    """A batch of latents, t, loss weights, labels, noise and a drop mask."""
    gen = torch.Generator().manual_seed(seed)
    lat = torch.randn((b, 4, 128, 16), generator=gen)
    return (lat, torch.randint(0, 1000, (b,), generator=gen),
            0.5 + torch.rand(b, generator=gen), torch.randint(0, 3, (b,), generator=gen),
            torch.randn(lat.shape, generator=gen), torch.rand(b, generator=gen) < 0.5)


def adam_step_agrees(torch, label, cpu_named, card_named, grads, lr, extra=(),
                     ema=None):
    """One Adam step, card against CPU: ``grads`` maps each name to the
    (CPU, card) gradients, ``ema`` is (CPU, card) dicts or None;
    ``extra`` (name, card, cpu) pairs are held by their own largest (see
    TRAIN_AGREE_TOL for the rest)."""
    gmax = max(g.abs().max().item() for g, _ in grads.values())
    grad_err = max((c - g).abs().max().item() for g, c in grads.values()) / gmax
    pmax = max(p.abs().max().item() for p in cpu_named.values())
    worst, worst_all, loose, total = 0.0, 0.0, 0, 0
    for name, cpu in cpu_named.items():
        diff = (card_named[name].float().cpu() - cpu).abs()
        g, gc = grads[name]
        settled = ((gc - g).abs() <= TRAIN_SETTLED * g.abs()) & (
            g.abs() >= 100 * ADAM_EPS)
        if settled.any():
            worst = max(worst, diff[settled].max().item() / pmax)
        worst_all = max(worst_all, diff.max().item() / pmax)
        loose += int((~settled).sum())
        total += g.numel()
        if (~settled).any() and diff[~settled].max().item() > 2 * lr * (1 + 1e-5):
            raise AssertionError(f"{label} {name}: an update beyond 2 lr")
    errs = {n: ((a.cpu().float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item() for n, a, b in extra}
    if ema is not None:
        emax = max(e.abs().max().item() for e in ema[0].values())
        errs["EMA"] = max((ema[1][n].float().cpu() - e).abs().max().item()
                          for n, e in ema[0].items()) / emax
    ok = max([worst, *errs.values()]) <= TRAIN_AGREE_TOL and grad_err <= TRAIN_GRAD_TOL
    print(f"{label}, card vs CPU: gradients max abs error over the largest "
          f"{grad_err:.2e} (tol {TRAIN_GRAD_TOL:.0e}); updated parameters max abs "
          f"error over the largest parameter {worst:.2e} where the gradient is "
          f"settled, {worst_all:.2e} over all elements ({loose} of {total} "
          f"elements' gradients unsettled, each moved within 2 lr); "
          f"{', '.join(f'{n} {v:.2e}' for n, v in errs.items())} (tol "
          f"{TRAIN_AGREE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return max(worst, *errs.values())


def train_step_card_vs_cpu(torch, port):
    """One fp32 train step of a class-conditional DiTRotary_XS_8 on the
    card and on the CPU from the same weights, batch, t, noise and drop
    mask, TF32 off: the loss, per-example losses, the gradient norm, the
    updated parameters and the EMA. The card's step launches the fp32
    attention kernels, two forwards and two backward calls."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.training import train_loop as ttl

    fa, gn = port["fa"], port["gn"]
    config = ttl.TrainConfig(lr=1e-4, weight_decay=0.01, ema_rate=0.9999)
    inputs = _train_inputs(torch, 7)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            model = train_model(torch, device)
            state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                                   optimizer=ttl.make_optimizer(config,
                                                                model.parameters()))
            step = ttl.make_train_step(model, make_schedule("linear", 1000).tables(
                device), config)
            reset_counts(fa, gn)
            metrics = step(state, *(a.to(device) for a in inputs))
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
            # one step in: Adam's first moment is (1 - b1) g
            grads = {n: state.optimizer.state[p]["exp_avg"].float().cpu() / 0.1
                     for n, p in model.named_parameters()}
            out[device] = (metrics, state, grads)
    (mc, sc, gc), (mg, sg, gg) = out["cpu"], out["cuda"]
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": 2,
                              "flash_attention_bwd_fp32": 2, "groupnorm_swish": 0})
    return adam_step_agrees(
        torch, "DiTRotary_XS_8 fp32 train step",
        {n: p.detach() for n, p in sc.model.named_parameters()},
        dict(sg.model.named_parameters()), {n: (gc[n], gg[n]) for n in gc},
        config.lr, [(k, mg[k], mc[k]) for k in ("loss", "per_example_loss",
                                                  "grad_norm")],
        (sc.ema_params, sg.ema_params))


def vae_step_card_vs_cpu(torch, port):
    """One fp32 VAE train step (the fixture's geometry: ch 32, ch_mult
    (1, 1, 2, 2), one res-block; L1 + KL, Adam (0.5, 0.9)) on the card and
    on the CPU from the same weights, chunks and posterior noise, TF32
    off: the losses and the updated parameters. On the card every norm
    runs kernel 2 forward and backward, with dw/dbias."""
    import copy

    from rule_guided_music_tpu_torch.models.vae import AutoencoderKL
    from rule_guided_music_tpu_torch.training.vae_train import (VAETrainConfig,
                                                                make_vae_train_steps)

    fa, gn = port["fa"], port["gn"]
    config = VAETrainConfig(lr=1e-4)
    gen = torch.Generator().manual_seed(9)
    batch = torch.rand((4, 3, 128, 128), generator=gen) * 2 - 1
    noise = torch.randn((4, 4, 16, 16), generator=gen)
    torch.manual_seed(4)
    ref = AutoencoderKL(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, encoder=True)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            vae = copy.deepcopy(ref).to(device)
            opt, _, ae_step, _ = make_vae_train_steps(vae, config)
            reset_counts(fa, gn)
            aux = ae_step(batch.to(device), 0, noise=noise.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
            grads = {n: opt.state[p]["exp_avg"].float().cpu() / (1 - config.betas[0])
                     for n, p in vae.named_parameters()}
            out[device] = (aux, vae, grads)
    (ac, vc, gc), (ag, vg, gg) = out["cpu"], out["cuda"]
    norms = norm_calls(ref)
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": 0,
                              "groupnorm_swish": norms, "groupnorm_swish_bwd": norms,
                              "groupnorm_swish_param_grad": norms})
    return adam_step_agrees(
        torch, "KL-VAE fp32 train step (fixture geometry)",
        {n: p.detach() for n, p in vc.named_parameters()}, dict(vg.named_parameters()),
        {n: (gc[n], gg[n]) for n in gc}, config.lr, [(k, ag[k], ac[k]) for k in ac])


def train_resume_on_card(torch, port, tmp):
    """Save after step 2, restore into a fresh TrainLoop, take step 3 with
    the same inputs as an uninterrupted run's step 3: bf16 compute on the
    card (both kernels' training path), parameters and EMA bit-equal."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.training import train_loop as ttl

    from rule_guided_music_tpu_torch.utils import logger

    logger.configure(dir=os.path.join(tmp, "resume_log"), format_strs=["log"])
    tables = make_schedule("linear", 1000).tables("cuda")

    def loop(name):
        return ttl.TrainLoop(model=train_model(torch, "cuda"), tables=tables,
                             data=None, config=ttl.TrainConfig(ema_rate=0.99),
                             checkpoint_dir=os.path.join(tmp, name),
                             compute_dtype=torch.bfloat16)

    inputs = [tuple(a.to("cuda") for a in _train_inputs(torch, 20 + i))
              for i in range(3)]
    straight = loop("straight")
    for args in inputs:
        straight.step_fn(straight.state, *args)
    first = loop("first")
    for args in inputs[:2]:
        first.step_fn(first.state, *args)
    first.step = 2
    first.save()
    resumed = loop("resumed")
    resumed.restore(first.latest_checkpoint(os.path.join(tmp, "first")))
    resumed.step_fn(resumed.state, *inputs[2])
    torch.cuda.synchronize()
    same = all(torch.equal(p, resumed.model.state_dict()[n])
               and torch.equal(straight.state.ema_params[n], resumed.state.ema_params[n])
               for n, p in straight.model.state_dict().items())
    print(f"resume on the card (XS_8, bf16): step 3 after save at step 2 and "
          f"restore into a fresh TrainLoop, parameters and EMA bit-equal to the "
          f"uninterrupted run's: {same}")
    if not same:
        raise AssertionError("the resumed step differs from the uninterrupted one")


# the backward kernels' counters: a path that differentiates names its
# backward launches; every other path must take none
BWD_COUNTS = ("flash_attention_bwd", "flash_attention_bwd_fp32",
              "groupnorm_swish_bwd", "groupnorm_swish_param_grad")


def check_launches(launches, expected):
    expected = {**dict.fromkeys(BWD_COUNTS, 0), **expected}
    for name in expected:
        if name in BWD_COUNTS and expected[name] == 0 == launches[name]:
            continue
        print(f"launches {name}: {launches[name]} (expected {expected[name]})")
    for name in expected:
        if launches[name] != expected[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {expected[name]}")
    if not any(expected[name] for name in BWD_COUNTS):
        print("launches of the backward kernels: none (expected none)")


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
    # fp32 weights: every attention call takes the fp32 kernel (3xTF32)
    check_launches(launches, {"flash_attention": 0,
                              "flash_attention_fp32": predicted["attention"],
                              "groupnorm_swish": predicted["groupnorm_swish"]})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # every phase writes under one root, which the evaluation group reads
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        return smoke(torch, root)


def smoke(torch, root) -> int:
    global CARD
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
        CARD = smi[0] if smi else "nvidia-smi: no output"
        print(CARD)

    with phase("build"):
        # one nvcc per source, all started together: kernel 1's three
        # libraries and kernel 2's
        jobs = [(name, fa, name) for name in fa.LIBRARIES] + [
            ("groupnorm_swish", gn, None)]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = [pool.submit(mod._load, *([arg] if arg else []))
                       for _, mod, arg in jobs]
            for job in futures:
                job.result()
        results = {**fa.build_results, "groupnorm_swish": gn.build_result}
        for label, _, _ in jobs:
            print(f"nvcc {label}.cu: {results[label].seconds:.2f} s")
            entry = ""
            for line in results[label].log.splitlines():
                # the kernel and its template arguments, as mangled
                found = re.search(r"(?<=\d)((?:flash|gn)_\w+?_kernel)(?:I(\w+?)EEv|E)", line)
                if "Compiling entry" in line and found:
                    entry = f"{found.group(1)}<{found.group(2) or ''}>"
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {entry}: {line.strip()}")
        for name in fa.LIBRARIES:
            # the bf16 kernels' mma.sync and the fp32 kernels' TF32 mma.sync
            # are both HMMA in SASS
            hmma = count_sass(results[name].path, "HMMA")
            print(f"cuobjdump -sass {name}: {hmma} HMMA (tensor-core mma) "
                  f"instructions")
            if hmma == 0:
                raise AssertionError(f"{name}: no HMMA instruction")

    with phase("kernel checks"):
        attn = check_attention(torch, fa, F)
        attn_cls, attn_dit_grad, attn_bwd_fp32, attn_grad_err = (
            check_attention_grad(torch, fa, F))
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
        attn_fp32_src = dict(attn_src,
                             source="rule_guided_music_tpu_torch/csrc/flash_attention_fp32.cu")
        gn_src = dict(route="cuda",
                      source="rule_guided_music_tpu_torch/csrc/groupnorm_swish.cu",
                      replaces="rule_guided_music_tpu/ops/pallas_groupnorm.py:117")
        # the backward kernels: the gradient of each Pallas kernel, which the
        # JAX package takes as jax.vjp of its XLA formulation
        vjp = dict(vjp_of="rule_guided_music_tpu/ops/attention.py:27")
        attn_bwd = dict(attn_src, **vjp,
                        source="rule_guided_music_tpu_torch/csrc/flash_attention_bwd.cu")
        kernels = [
            dict(name="flash_attention", **attn_src, **attn["flash_attention"],
                 at_classifier_shape=attn_cls, at_rollout_shape=attn_roll),
            dict(name="flash_attention_fp32", **attn_fp32_src,
                 **attn["flash_attention_fp32"]),
            dict(name="flash_attention_bwd", **attn_bwd,
                 max_abs_err=attn_grad_err["bfloat16"], ms=attn_cls["bwd_ms"],
                 plain_ms=attn_cls["plain_bwd_ms"], bound_ms=attn_cls["bwd_bound_ms"],
                 bound_by=attn_cls["bwd_bound_by"], library_ms=attn_cls["library_bwd_ms"],
                 shape=f"{GRAD_SHAPES[0]} bf16, backward alone",
                 at_dit_b2=attn_dit_grad),
            dict(name="flash_attention_bwd_fp32", **attn_fp32_src, **vjp,
                 max_abs_err=attn_grad_err["float32"], **attn_bwd_fp32),
            dict(name="groupnorm_swish", **gn_src, **check_groupnorm(torch, gn),
                 at_scoring_decode=gn_scoring, at_encoder=gn_encoder),
            dict(name="groupnorm_swish_bwd", **gn_src,
                 vjp_of="rule_guided_music_tpu/ops/pallas_groupnorm.py:166",
                 **gn_backward),
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
    with kept_dir(root, "edit_dps_test_set") as tmp:
        prefix = write_test_set(os.path.join(tmp, "test_set"))
        with phase("edit: scripts/configs/edit/nd_scg_given_target.yml, "
                   "DiTRotary_XL_8 + KL-VAE with its encoder, SCG k=4 on "
                   f"[32, 64), DDPM respaced to {EDIT_RESPACING} entered at "
                   f"step {EDIT_NOISE_LEVEL}, B=2"):
            edit_dir = os.path.join(tmp, "edit")
            os.makedirs(edit_dir)
            slice5_launches["edit"] = edit_path(
                torch, port, models, build_encoder_vae(torch, pipeline), prefix,
                edit_dir)
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
        cli_out = os.path.join(tmp, "cli_out")    # the flagship CLI's files
    torch.cuda.empty_cache()

    with phase("small-input agreement: card vs CPU"):
        fp32_launches = small_input_agreement(torch, port)
        cond_fp32_launches = cond_fn_card_vs_cpu(torch, port)
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
    with kept_dir(root, "long_form") as tmp:
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

    # int8 serving and the pixel-space paths, after every earlier path
    with phase("pixel kernel checks: attention at the UNet's and the 2-D "
               "DiT's shapes, GroupNorm+swish on every call of one UNet "
               "forward at eps 1e-5"):
        pixel_kernels = check_pixel_kernels(torch, fa, gn, F, pipeline)
    torch.cuda.empty_cache()
    slice7_launches = {}
    with kept_dir(root, "pixel_int8") as tmp:
        with phase(f"pixel.sample_pixel --scg True: the UNet at its defaults "
                   f"on (3, 128, 128), SCG k=4 on note_density_pixel, "
                   f"{PIXEL_RESPACING} steps, B=2"):
            slice7_launches["pixel_scg"] = pixel_scg_path(torch, port, tmp)
        torch.cuda.empty_cache()
        for sampler in ("ddim", "dpmpp"):
            with phase(f"pixel.cfg_sample_pixel --sampler {sampler}: DiT-B/8 "
                       f"on (3, 128, 128), CFG w=4, {PIXEL_RESPACING} steps, B=2"):
                slice7_launches[f"pixel_cfg_{sampler}"] = pixel_cfg_path(
                    torch, port, sampler, tmp)
        torch.cuda.empty_cache()
        with phase("int8 models: DiTRotary_XL_8 in fp32, a copy per mode "
                   "quantized, + KL-VAE"):
            models = build_main_models(torch, pipeline, QUANT_MODES)
            qdits = models.pop("qdits")
        with phase("int8: the scg.yml chain (DiTRotary_XL_8 + KL-VAE, k=16, "
                   "B=2, 10 steps) with the fp, w8a16 and w8a8 trunks"):
            q_launches, _, _ = quant_path(torch, port, models, qdits)
        slice7_launches.update({f"int8_{k}": v for k, v in q_launches.items()
                                if k != "fp"})
        del models, qdits
        torch.cuda.empty_cache()
        for mode in QUANT_MODES:
            with phase(f"sample_rule.main --quant {mode} on scg.yml: "
                       f"DiTRotary_XL_8 + KL-VAE, k=16, 10 steps, B=2"):
                slice7_launches[f"sample_rule_scg_{mode}"] = quant_cli_path(
                    torch, port, mode, tmp)
    torch.cuda.empty_cache()
    with phase("int8 and pixel agreement: card vs CPU"):
        check_quant_linear(torch)
        quant_envelope_on_card(torch, port)
        pixel_card_vs_cpu(torch, port)

    # the evaluation chain, after every path whose files it reads: the
    # flagship CLI's MIDI, every results.csv under the root, the edit tables
    eval_root = os.path.join(root, "eval")
    os.makedirs(eval_root)
    with phase("evaluation 1: compute_rule on the flagship CLI's MIDI, card "
               "and CPU, against the sampler's results.csv"):
        eval_flagship_rules(torch, cli_out, eval_root)
    with phase(f"evaluation 2: compute_rule on {EVAL_EXCERPTS} excerpts of "
               f"10.24 s in one batched call"):
        sets = write_eval_sets(eval_root)
        eval_full = eval_full_size(torch, sets["gen"], eval_root)
    with phase("evaluation 3: eval_rule over every results.csv of this run"):
        eval_rule_tables(torch, root)
    with phase(f"evaluation 4: eval_quality {EVAL_EXCERPTS} vs {EVAL_EXCERPTS}, "
               f"--runs 3, eval_uncond, eval_uncond_summary"):
        eval_quality_tables(torch, sets, eval_root)
    with phase("evaluation 5: edit_create_bins, edit_accuracy"):
        eval_edit_bins(torch, edit_dir, eval_root)
    with phase(f"evaluation 6: compute_fad, proxy on {FAD_FILES} vs {FAD_FILES}, "
               f"the vggish gate"):
        eval_fad(torch, sets)

    # training, after every earlier path: the trainers hold the card's
    # memory (the optimizer state, the VAE's activations at 128 chunks)
    with phase("training kernel checks: attention's backward at train_dit's "
               f"{TRAIN_ATTN_SHAPE}, GroupNorm+swish's backward with dw/dbias on "
               f"one train_vae step's calls at {TRAIN_VAE_CHUNKS} chunks"):
        train_attn, train_gn = check_training_kernels(torch, fa, gn, F)
    slice10_launches = {}
    with kept_dir(root, "training") as tmp:
        with phase("train_dit.main: DiTRotary_XL_8, batch 32 (8 rolls of 2560 "
                   "columns x encode_rep 4), bf16, AdamW, EMA 0.9999, the "
                   f"production VAE encoder; {TRAIN_DIT_STEPS} steps, the save"):
            slice10_launches["train_dit"], _ = train_dit_path(torch, port, tmp)
        with phase(f"train_vae.main: the production KL-VAE, batch "
                   f"{TRAIN_VAE_CHUNKS} chunks, bf16, {TRAIN_VAE_STEPS} steps"):
            slice10_launches["train_vae"], _ = train_vae_path(torch, port, tmp)
        torch.cuda.empty_cache()
        with phase("training agreement: a train step card vs CPU (XS_8, the "
                   "fixture-size VAE), resume on the card"):
            train_step_card_vs_cpu(torch, port)
            vae_step_card_vs_cpu(torch, port)
            train_resume_on_card(torch, port, tmp)

    # each kernel's launches are those of the path that takes it, counted
    # from 0 just before it: the bf16 kernels' the flagship path's (and each
    # path's too), kernel 2's backward DPS-rule's, the fp32 attention
    # kernels' those of the fp32 card-vs-CPU runs
    main_run = {
        "flash_attention_fp32": (fp32_launches, "card-vs-CPU fixture run, fp32"),
        "flash_attention_bwd_fp32": (cond_fp32_launches,
                                     "card-vs-CPU classifier cond_fn, fp32"),
        "groupnorm_swish_bwd": (slice5_launches["dps_rule"],
                                "DPS-rule path (single/dps_rule/pitch.yml), bf16")}
    for k in kernels:
        name = k["name"]
        if name == "flash_attention":
            k.update({key: long_kernels[key] for key in (
                "at_half_window", "at_stitched_rollout")})
            k["at_pixel_shapes"] = {
                str(shape): pixel_kernels[str(shape)] for shape in PIXEL_ATTN_SHAPES}
        elif name == "flash_attention_bwd":
            k["at_edm_ring"] = long_kernels["at_edm_ring"]
            k["at_training"] = train_attn
        elif name == "groupnorm_swish_bwd":
            k["at_training"] = train_gn
        elif name == "groupnorm_swish":
            k["at_long_decode"] = long_kernels["at_long_decode"]
            k["at_unet_forward"] = pixel_kernels["at_unet_forward"]
        run, k["launched_in"] = main_run.get(
            name, (cls_launches, "main path with classifier guidance, bf16"))
        k["launches"] = run[name]
        if not name.endswith("fp32"):
            k["launches_by_path"] = {"scg": scg_launches[name],
                                     "classifier_guidance": cls_launches[name],
                                     **{n: v[name] for launches in (
                                         serving_launches, slice5_launches,
                                         slice6_launches, slice7_launches,
                                         slice10_launches)
                                        for n, v in launches.items()}}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launched_in"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{**{key: k[key] for key in keys}, **k}
                                  for k in kernels]}))
    # the card's name, read where the result line is printed
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
