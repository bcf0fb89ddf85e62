#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds every CUDA source from this checkout with nvcc (one process each,
all in parallel: kernel 1's bf16 forward, bf16 backward and fp32 sources,
kernel 2's, the int8 GEMMs') and prints each one's seconds, checks each hand-written kernel
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
``pixel.sample_pixel``'s UNet at eps 1e-5; the int8 kernels
(csrc/quant_gemm.cu: the w8a16 GEMM and its fp32 route, the per-token
quantization, the w8a8 GEMM; the GEMMs fed by TMA, split across a cluster
where the tiles are few) against their plain versions at XL_8's four
linears at 512 and 8192 tokens, a 1-row and a 16-row call, XS_8's 64 ->
192, ragged shapes with K not a multiple of 64 and a k-split shape, and
at every route forced on three shapes (w8a8 in bf16 and fp32 and its
unit-scale route, the one-call linear, and the quantization, bit-equal;
w8a16 within one bf16 ulp and in fp32 within 1e-5); the quantization on
every route (K = 16, 1152, 4608 and 16400, past the rows held in
registers, at 1, 7, 512 and 8192 rows, bf16 and fp32) with rows whose
x / s land on halves, all-zero rows and ties at the amax, bit-equal, and
the one-call w8a8 linear against the quantization and the GEMM called
apart, bit-equal, one launch of each; then, with launch checks:
``pixel.sample_pixel --scg True`` at its defaults (the UNet on (3, 128,
128), k=4, B=2), ``pixel.cfg_sample_pixel`` under DDIM and DPM-Solver++
(DiT-B/8, CFG w=4), each first on the CLI's build with seeded random
weights (ms per step, MIDI) and then through its ``main``; the scg.yml
chain with the fp, w8a16 and w8a8 XL_8 trunks (the same seeded weights)
in one call, the int8 kernels' launches counted, and the trunk's linears
timed (each kernel beside bf16 ``F.linear``, ``torch._int_mm`` or fp32
``F.linear``, its plain version and its bound; the host ms of one w8a8
linear at 1 and 16 rows, one call against two); ``sample_rule.main
--quant`` in both modes and ``--quant w8a16 --dtype float32`` (4 x 28 x
19 GEMM launches each); and, card against CPU: QuantLinear
(w8a8 equal), the quantized XS_8 of quality_tiny within
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

Parallelism: a process group of one rank (NCCL, a file store in the
run's temporary directory); ``train_dit.main`` at the JAX defaults for
three steps plain and with ``--dp 1 --fsdp 1 --tp 1`` through the mesh
code (DTensor parameters, each block on its leaves), step 1's loss and
grad_norm equal, launches checked, ms a step of each;
``pipelined_dit_rotary_apply`` on XL_8 at batch 32 over a 1-rank stage
mesh (``keep_stage_blocks_`` keeps all 28 blocks on the one stage), GPipe
with 4 microbatches and the circular schedule, against the
model's forward; ``sample_rule.main --mesh 1`` on scg.yml, byte-equal to
the run without it; ``train_probe`` at its full geometry; ``train_soak``
(XS_8 and the fixture's VAE, fp32, 40 steps killed past 25) with every
check. The group prints a ``{"parallel": ...}`` JSON line.

The distillation and study scripts, last: kernel 2's backward with
dw/dbias on the ch=64 ScoringDecoder student's 29 calls at 32 chunks,
its forward on every call of the ch=128 teacher's decode and of the
production encoder's encode at 128 chunks, kernel 1 at the XL_8
teacher's (16,256,16,72) and with a gradient at the B_8 student's
(16,256,12,64), each against its plain version beside the library and
the bound; then, with launch checks, ``distill_scoring_decoder`` and
``distill_scoring_features`` at their defaults (400 and 600 steps) and
``distill_scoring_rollout`` at its widths and batch cut to 200 steps and
8 gate groups (bf16 under autocast, seeded random teachers): seconds, ms
a step, peak, the first and last logged loss (the last below the first)
and the agreement, and each npz loaded through
``pipeline.ScoringBundle.create`` giving the trained module's outputs bit
for bit; a decoder-distill step card against CPU; MIDI written by
``data/midi_io`` through ``prepare_data chunks`` and ``rearrange`` to
``compute_std`` at its defaults (a finite scale_factor); the chord
divergence study card against CPU (tags equal off exact ties); and
``allrules_gate_study --variants plain,feat_pre4_light --skip_regret`` on
the fixtures in fp32, seed 0 of each row card against CPU under the same
noise, its launches equal to the module calls. The group prints a
``{"distill": ...}`` JSON line.

Each phase prints its wall seconds. The line before the last is a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX and no PyYAML.
"""

import contextlib
import csv
import copy
import json
import re
import os
import shutil
import statistics
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12,
                  "int8": 1979e12}
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
# output: w8a8's int8 values and int32 sums are exact and its kernels take
# the plain version's float operations in its order (true divisions, no
# FMA), so the two are equal; w8a16's fp32 product sums in another order
QUANT_LINEAR_TOL = {"w8a8": 0.0, "w8a16": 1e-5}
# w8a16 in bf16 against its plain version: the share of outputs that may
# differ (by one ulp; the fp32 sums' order alone moves a few in 10^4,
# rounding them to bf16 before the rescale about a quarter)
QUANT_BF16_SHARE = 1e-3
# QuantLinear's gradient with respect to its input, card against CPU in
# fp32, over the largest: w8a16's fp32 product and w8a8's sum over N of
# dy * acc * scale (the int8 sums exact) each add in another order
QUANT_GRAD_TOL = 1e-5
# XL_8's four token-level linears (in, out): qkv, proj, fc1, fc2
XL_LINEARS = [(1152, 3456), (1152, 1152), (1152, 4608), (4608, 1152)]
# the int8 kernels against their plain versions, (rows, in, out): XL_8's
# four linears at B=2 (512 tokens) and at k*B=32 (8192), a 1-row and a
# 16-row call, XS_8's qkv at 16 tokens (B=1); ragged M and N at the TMA
# boxes' edges with K a multiple of 16 but not of 64 (one k-tile and a
# tail), and fc2 at 64 rows (a k-split cluster); bias on the XL_8 calls
# and on (300, 1168, 200) and (64, 4608, 1152), absent elsewhere
QUANT_KERNEL_CASES = ([(m, k, n) for m in (512, 8192) for k, n in XL_LINEARS]
                      + [(1, 1152, 3456), (16, 1152, 3456), (16, 64, 192),
                         (300, 1168, 200), (33, 48, 130), (64, 4608, 1152)])
QUANT_TOKENS = (512, 8192)
QUANT_BIAS = (300, 64, 4500)   # rows of the other cases with a bias
# every route of the TMA GEMMs (BN tokens a block, blocks of a k-split
# cluster), forced on a ragged shape, a B=2 linear, a tiny one and a ragged
# one of more tiles than SMs at either BN (more than one wave of blocks)
QUANT_ROUTES = [(128, 1), (128, 2), (128, 4), (256, 1), (256, 3)]
QUANT_ROUTE_CASES = [(300, 1168, 200), (512, 1152, 1152), (33, 48, 130),
                     (4500, 1168, 1000)]
# the quantization's routes, (rows, K): one thread a row (K = 16), one warp
# (1152), four (4608), and a row past what registers hold, read twice
# (16400); at 1, 7, 512 and 8192 rows
QUANTIZE_CASES = [(m, k) for k in (16, 1152, 4608, 16400) for m in (1, 7, 512, 8192)]
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


def device_ms(torch, fn, reps=3, tries=3):
    """Device ms per call of ``fn``: the sum of its CUDA kernels' durations
    by torch.profiler, each kernel event counted once, over ``reps`` calls
    after one unprofiled call. A trace in which some kernel's events are
    not a multiple of ``reps`` has lost events (seen late in a long
    process): it is taken again, up to ``tries`` times, then None."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts = Counter(e.name for e in kernels)
        if kernels and all(n % reps == 0 for n in counts.values()):
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return None


def fmt_ms(value):
    return "not measured" if value is None else f"{value:.4f} ms"


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


def check_attention_grad_at(torch, fa, gen, shape,
                            dtypes=("float32", "bfloat16")):
    """dq, dk, dv through the backward kernels at ``shape`` in ``dtypes``
    (both by default),
    on views of one qkv tensor (one forward and one backward call each),
    against autograd through the plain forward and against the plain
    backward on the plain forward's output and LSE (fp32). Returns the
    worst error of each dtype."""
    b, n, h, d = shape
    worst = {}
    for dname in dtypes:
        dtype = getattr(torch, dname)
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
    from rule_guided_music_tpu_torch.ops import quant

    fa.kernel_launches = dict.fromkeys(fa.kernel_launches, 0)
    gn.launches = gn.backward_launches = gn.param_grad_launches = 0
    quant.kernel_launches = dict.fromkeys(quant.kernel_launches, 0)


def read_counts(fa, gn):
    from rule_guided_music_tpu_torch.ops import quant

    return {**fa.kernel_launches, "groupnorm_swish": gn.launches,
            "groupnorm_swish_bwd": gn.backward_launches,
            "groupnorm_swish_param_grad": gn.param_grad_launches,
            **quant.kernel_launches}


def expected_quant(dit, calls):
    """The int8 kernels' launches in ``calls`` forwards of ``dit``: a GEMM
    per QuantLinear of its mode, and a quantization per w8a8 one."""
    from rule_guided_music_tpu_torch.ops.quant import QuantLinear

    modes = [mod.mode for mod in dit.modules() if isinstance(mod, QuantLinear)]
    return {"w8a16_gemm": modes.count("w8a16") * calls,
            "w8a8_gemm": modes.count("w8a8") * calls,
            "quantize_rows": modes.count("w8a8") * calls}


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
                "groupnorm_swish": predicted["groupnorm_swish"],
                **expected_quant(dit, steps + n_guided)}
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


def quant_inputs(torch, gen, m, k, n, bias=True):
    """fp32 activations (m, k), an int8 (n, k) weight, its fp32 scale and
    bias, drawn on the card."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand(n, generator=gen, device="cuda") / 127
    b = 0.1 * torch.randn(n, generator=gen, device="cuda") if bias else None
    return x, w8, sc, b


def quant_case(torch, quant, gen, m, k, n, bias):
    """One shape's checks of the int8 kernels against their plain versions:
    {quantize_rows, w8a8_gemm: elements off (w8a8 in bf16 and fp32, its
    unit-scale route of the backward, and the whole w8a8 path), w8a16_share,
    w8a16_beyond (bf16), w8a16_fp32 (over the largest output)}."""
    x, w8, sc, b = quant_inputs(torch, gen, m, k, n, bias=bias)
    xb = x.bfloat16()
    q, s_x = quant.quantize_rows(xb)
    q_ref, s_ref = quant.quantize_rows_reference(xb)
    off_q = int((q != q_ref).sum()) + int((s_x != s_ref[:, 0]).sum())
    off_8 = 0
    for dtype in (torch.bfloat16, torch.float32):
        y8 = quant.w8a8_gemm(q, s_x, w8, sc, b, dtype)
        off_8 += int((y8 != quant.w8a8_gemm_reference(q_ref, s_ref, w8, sc, b, dtype)).sum())
    ones = lambda size: torch.ones(size, device="cuda")
    # the backward's route: unit scales, no bias, the int32 sums in fp32
    off_8 += int((quant.w8a8_gemm(q, ones(m), w8, ones(n), None, torch.float32)
                   != quant.int_mm(q_ref, w8).float()).sum())
    off_8 += int((quant.quant_dense_apply(xb, w8, sc, b)
                  != quant.quant_dense_reference(xb, w8, sc, b)).sum())
    share, beyond = quant.bf16_disagreement(
        quant.wo_dense_apply(xb, w8, sc, b),
        quant.wo_dense_reference(xb, w8, sc, b), xb, w8, sc)
    want32 = quant.wo_dense_reference(x, w8, sc, b)
    err32 = ((quant.wo_dense_apply(x, w8, sc, b) - want32).abs().max()
             / want32.abs().max()).item()
    torch.cuda.synchronize()
    return dict(quantize_rows=off_q, w8a8_gemm=off_8, w8a16_share=share,
                w8a16_beyond=beyond, w8a16_fp32=err32)


def quantize_edge_input(torch, gen, m, k, dtype):
    """(m, k) of ``dtype`` drawn on the card, row i of kind i % 4: a row
    whose x / s all land on halves (the amax 127 c, the others odd
    multiples of c / 2 of both signs, c = 2^-3, so that s = c exactly; all
    exact in bf16), an all-zero row (the 1e-8 floor), a row whose largest
    |x| is tied three times with both signs, a row drawn from a normal."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    col = torch.arange(k, device="cuda")
    c = 2.0 ** -3
    halves = ((col % 127) + 0.5) * c * (1 - 2 * (col % 2)).float()
    halves[5 % k] = 127 * c
    ties = x[0].clamp(-2, 2)
    ties[[1, k // 2, k - 1]] = torch.tensor([2.5, -2.5, 2.5], device="cuda")
    kind = (torch.arange(m, device="cuda") % 4)[:, None]
    x = torch.where(kind == 0, halves, torch.where(kind == 1, 0.0, torch.where(
        kind == 2, ties, x)))
    return x.to(dtype)


def quantize_case(torch, quant, gen, m, k, dtype):
    """The quantization of :func:`quantize_edge_input`'s (m, k) rows against
    its plain version: (elements of x_i8 and s_x off, the route taken)."""
    x = quantize_edge_input(torch, gen, m, k, dtype)
    q, s_x = quant.quantize_rows(x)
    q_ref, s_ref = quant.quantize_rows_reference(x)
    off = int((q != q_ref).sum()) + int((s_x != s_ref[:, 0]).sum())
    return off, quant.quantize_route(m, k, dtype)


def w8a8_linear_case(torch, quant, gen, m, k, n, x_dtype, dtype):
    """The one-call w8a8 linear against the quantization and the GEMM
    called apart on the same inputs: elements off; raises unless it
    launched one quantization and one GEMM."""
    x, w8, sc, b = quant_inputs(torch, gen, m, k, n)
    x = x.to(x_dtype)
    before = dict(quant.kernel_launches)
    got = quant.w8a8_linear(x, w8, sc, b, dtype)
    launched = {name: quant.kernel_launches[name] - before[name] for name in before}
    if launched != {**dict.fromkeys(before, 0), "quantize_rows": 1, "w8a8_gemm": 1}:
        raise AssertionError(f"w8a8_linear at {m} x {k} -> {n} launched {launched}")
    q, s_x = quant.quantize_rows(x)
    return int((got != quant.w8a8_gemm(q, s_x, w8, sc, b, dtype)).sum())


def check_quant_kernels(torch, quant):
    """Each int8 kernel against its plain version on the card at every
    QUANT_KERNEL_CASES call, by the route each takes, and at every
    QUANT_ROUTES route forced on QUANT_ROUTE_CASES, without TF32: the
    quantization (x_i8, s_x) and w8a8 (bf16 and fp32 outputs, the unit-scale
    route) bit-equal; w8a16 in bf16 at most QUANT_BF16_SHARE of the outputs
    different, none by more than one ulp (``quant.bf16_disagreement``), in
    fp32 within QUANT_LINEAR_TOL["w8a16"] of the largest output. Then the
    quantization at every QUANTIZE_CASES shape, bf16 and fp32, on rows of
    halves, zeros and ties, every route taken, and the one-call w8a8 linear
    at every QUANT_KERNEL_CASES call (bf16 and fp32 in, bf16 and fp32 out)
    against the two kernels called apart, all bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    worst = dict(quantize_rows=0, w8a8_gemm=0, w8a16_share=0.0, w8a16_beyond=0,
                 w8a16_fp32=0.0)
    runs = [(shape, None) for shape in QUANT_KERNEL_CASES] + [
        (shape, route) for shape in QUANT_ROUTE_CASES for route in QUANT_ROUTES]
    with no_tf32(torch), torch.no_grad():
        for (m, k, n), route in runs:
            bias = m in QUANT_TOKENS + QUANT_BIAS
            with quant.force_route(*(route or ())):
                taken = {mode: quant.gemm_route(m, n, k, mode) for mode in QUANT_MODES}
                got = quant_case(torch, quant, gen, m, k, n, bias)
            print(f"int8 kernels at {m} x {k} -> {n}{'' if bias else ', no bias'}"
                  f"{f', forced {route}' if route else ''} (routes (BN, split): w8a16 "
                  f"{taken['w8a16']}, w8a8 {taken['w8a8']}): quantization "
                  f"{got['quantize_rows']} and w8a8 {got['w8a8_gemm']} elements off the "
                  f"plain versions (the GEMM in bf16 and fp32, its unit-scale route, the "
                  f"whole w8a8 path); w8a16 bf16 {100 * got['w8a16_share']:.4f}% differ, "
                  f"{got['w8a16_beyond']} by more than one ulp; w8a16 fp32 "
                  f"{got['w8a16_fp32']:.3e} of the largest output")
            for key, v in got.items():
                worst[key] = max(worst[key], v)
        routes = set()
        for m, k in QUANTIZE_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                off, route = quantize_case(torch, quant, gen, m, k, dtype)
                routes.add(route)
                worst["quantize_rows"] = max(worst["quantize_rows"], off)
                print(f"quantization at {m} x {k}, {str(dtype)[6:]}, rows of halves, "
                      f"zeros and ties (route: threads a row, rows a block, pieces a "
                      f"thread, 0 read twice: {route}): {off} elements off")
        if {route[2] > 0 for route in routes} != {True, False}:
            raise AssertionError(f"the quantization's routes taken: {sorted(routes)}")
        off = sum(w8a8_linear_case(torch, quant, gen, m, k, n, x_dtype, dtype)
                  for m, k, n in QUANT_KERNEL_CASES
                  for x_dtype, dtype in ((torch.bfloat16, torch.bfloat16),
                                         (torch.bfloat16, torch.float32),
                                         (torch.float32, torch.float32)))
        print(f"the one-call w8a8 linear at {len(QUANT_KERNEL_CASES)} shapes x 3 "
              f"dtypes against the quantization and the GEMM apart: {off} elements "
              f"off, one launch of each a call")
        worst["w8a8_gemm"] = max(worst["w8a8_gemm"], off)
    if (worst["quantize_rows"] or worst["w8a8_gemm"] or worst["w8a16_beyond"]
            or worst["w8a16_share"] > QUANT_BF16_SHARE
            or worst["w8a16_fp32"] > QUANT_LINEAR_TOL["w8a16"]):
        raise AssertionError(f"int8 kernels disagree with their plain versions: {worst}")
    return worst


def quant_bounds(m, k, n):
    """{kernel: (bound ms, bound_by)} of one call: each input read once and
    the output written once; 2 m n k operations at the bf16 or int8 rate
    (w8a16's fp32 route: three bf16 products, x and y in fp32); the
    quantization's reduction and rounding as 6 fp32 operations an
    element."""
    weight = n * k + 8 * n
    return {"w8a16_gemm": bound_and_kind(2 * m * k + weight + 2 * m * n,
                                         2 * m * n * k, "bfloat16"),
            "w8a16_gemm_fp32": bound_and_kind(4 * m * k + weight + 4 * m * n,
                                              3 * 2 * m * n * k, "bfloat16"),
            "w8a8_gemm": bound_and_kind(m * k + 4 * m + weight + 2 * m * n,
                                        2 * m * n * k, "int8"),
            "quantize_rows": bound_and_kind(2 * m * k + m * k + 4 * m, 6 * m * k,
                                            "float32")}


def quant_calls(torch, quant, F, gen, m, k, n):
    """One linear's calls for :func:`time_quant_trunk`: per kernel its
    (kernel, plain version, library call or None), on inputs drawn here."""
    x, w8, sc, b = quant_inputs(torch, gen, m, k, n)
    xb, bb = x.bfloat16(), b.bfloat16()
    q, s_x = quant.quantize_rows(xb)
    wb = torch.randn((n, k), generator=gen, device="cuda", dtype=torch.bfloat16)
    wf = wb.float()
    return dict(
        shape=(m, k, n), bound=quant_bounds(m, k, n),
        w8a16_gemm=(lambda: quant.wo_dense_apply(xb, w8, sc, b),
                    lambda: quant.wo_dense_reference(xb, w8, sc, b),
                    lambda: F.linear(xb, wb, bb)),
        w8a16_gemm_fp32=(lambda: quant.wo_dense_apply(x, w8, sc, b),
                         lambda: quant.wo_dense_reference(x, w8, sc, b),
                         lambda: F.linear(x, wf, b)),
        w8a8_gemm=(lambda: quant.w8a8_gemm(q, s_x, w8, sc, b, torch.bfloat16),
                   lambda: quant.w8a8_gemm_reference(q, s_x[:, None], w8, sc, b),
                   lambda: torch._int_mm(q, w8.t())),
        quantize_rows=(lambda: quant.quantize_rows(xb),
                       lambda: quant.quantize_rows_reference(xb), None))


def host_ms(torch, fn, reps=200, rounds=5):
    """Host ms a call of ``fn``: the least over ``rounds`` of the host
    clock around ``reps`` back-to-back calls (each enqueues its launches
    and returns), so that a neighbour's burst on the host's shared cores
    does not count; the device is synchronised between rounds."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * best / reps


def w8a8_host_ms(torch, quant, gen):
    """Host ms a call of one w8a8 linear at XL_8's qkv with 1 and 16 rows:
    the one call (``quant_dense_apply``), the quantization and the GEMM
    called apart, and the GEMM alone."""
    out = {}
    with torch.no_grad():
        for rows in (1, 16):
            x, w8, sc, b = quant_inputs(torch, gen, rows, *XL_LINEARS[0])
            xb = x.bfloat16()
            q, s_x = quant.quantize_rows(xb)
            out[rows] = dict(
                one_call=host_ms(torch, lambda: quant.quant_dense_apply(xb, w8, sc, b)),
                two_calls=host_ms(torch, lambda: quant.w8a8_gemm(
                    *quant.quantize_rows(xb), w8, sc, b)),
                gemm_alone=host_ms(torch, lambda: quant.w8a8_gemm(q, s_x, w8, sc, b)))
            print(f"host ms of one w8a8 linear at {rows} x 1152 -> 3456: one call "
                  f"{out[rows]['one_call']:.4f}, the quantization and the GEMM apart "
                  f"{out[rows]['two_calls']:.4f}, the GEMM alone "
                  f"{out[rows]['gemm_alone']:.4f}")
    return out


def time_quant_trunk(torch, quant, F):
    """The XL_8 trunk's four linears at QUANT_TOKENS: each int8 kernel (in
    bf16, and w8a16's fp32 route), its plain version and the library's
    call (bf16 ``F.linear`` for w8a16, fp32 ``F.linear`` without TF32 for
    its fp32 route, ``torch._int_mm`` without its epilogue for w8a8, none
    for the quantization) by CUDA events, and the kernels' and the
    library's device ms by torch.profiler; summed over one forward's 28
    blocks. Then the host ms of one w8a8 linear (:func:`w8a8_host_ms`).
    Returns {tokens: {kernel: row}, "w8a8_host_ms": {rows: row}}."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    out = {}
    with no_tf32(torch), torch.no_grad():
        for tokens in QUANT_TOKENS:
            calls = [quant_calls(torch, quant, F, gen, tokens, k, n)
                     for k, n in XL_LINEARS]
            rows = {}
            for name in ("w8a16_gemm", "w8a16_gemm_fp32", "quantize_rows", "w8a8_gemm"):
                row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0 if
                           calls[0][name][2] else None, at_shapes={})
                for call in calls:
                    kernel, plain, library = call[name]
                    bound, row["bound_by"] = call["bound"][name]
                    shape_row = dict(ms=cuda_time_ms(kernel),
                                     plain_ms=cuda_time_ms(plain, reps=5, warmup=1),
                                     bound_ms=bound,
                                     library_ms=library and cuda_time_ms(library))
                    if name != "quantize_rows":
                        m, k, n = call["shape"]
                        shape_row["gemm_route"] = quant.gemm_route(
                            m, n, k, name.replace("_gemm", ""))
                    else:
                        shape_row["route"] = quant.quantize_route(*call["shape"][:2])
                    row["at_shapes"][str(call["shape"])] = shape_row
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                        if row[key] is not None:
                            row[key] += 28 * shape_row[key]
                run = lambda i: [call[name][i]() for call in calls]
                row["device_ms"] = device_ms(torch, lambda: run(0))
                row["library_device_ms"] = (device_ms(torch, lambda: run(2))
                                            if row["library_ms"] is not None else None)
                for key in ("device_ms", "library_device_ms"):
                    if row[key] is not None:
                        row[key] *= 28
                rows[name] = row
            for name, row in rows.items():
                for shape, r in row["at_shapes"].items():
                    print(f"  {name} {shape}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
                          f"bound {r['bound_ms']:.4f}, library "
                          f"{fmt_ms(r['library_ms'])}"
                          + (f", route (BN, split) {r['gemm_route']}"
                             if "gemm_route" in r else
                             f", route (threads a row, rows a block, pieces a thread) "
                             f"{r['route']}"))
            w16, q8, g8 = rows["w8a16_gemm"], rows["quantize_rows"], rows["w8a8_gemm"]
            f32 = rows["w8a16_gemm_fp32"]
            print(f"XL_8 trunk linears per forward at {tokens} tokens (28 blocks x 4; "
                  f"CUDA events, device ms by torch.profiler in brackets): bf16 "
                  f"F.linear {w16['library_ms']:.2f} ({fmt_ms(w16['library_device_ms'])}); "
                  f"w8a16 kernel {w16['ms']:.2f} ({fmt_ms(w16['device_ms'])}), bound "
                  f"{w16['bound_ms']:.3f} ({w16['bound_by']}); w8a8 quantization "
                  f"{q8['ms']:.2f} ({fmt_ms(q8['device_ms'])}) + GEMM {g8['ms']:.2f} "
                  f"({fmt_ms(g8['device_ms'])}), bounds {q8['bound_ms']:.3f} + "
                  f"{g8['bound_ms']:.3f} ({g8['bound_by']}); torch._int_mm "
                  f"{g8['library_ms']:.2f} ({fmt_ms(g8['library_device_ms'])}); w8a16's "
                  f"fp32 route {f32['ms']:.2f} ({fmt_ms(f32['device_ms'])}), bound "
                  f"{f32['bound_ms']:.3f} ({f32['bound_by']}), fp32 F.linear "
                  f"{f32['library_ms']:.2f} ({fmt_ms(f32['library_device_ms'])})")
            out[tokens] = rows
    out["w8a8_host_ms"] = w8a8_host_ms(torch, quant, gen)
    return out


def quant_path(torch, port, m, qdits):
    """The main path's SCG chain (scg.yml, k=16, B=2, 10 steps) with the
    fp XL_8 trunk and with each int8 trunk, in one call: ms per guided
    step, peak, launches (the int8 kernels' too); then the trunk's calls
    at B=2 and k*B=32 and its four linears (:func:`time_quant_trunk`)."""
    from torch.nn import functional as F

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
    return launches, steps_ms, time_quant_trunk(torch, quant, F)


def quant_cli_path(torch, port, mode, tmp, dtype="bfloat16"):
    """``sample_rule.main --quant <mode> --dtype <dtype>`` on scg.yml (as
    JSON) at full width: XL_8 at its initialisation, quantized, and the
    production decoder, k=16, B=2, a 10-step chain: launches as the fp
    trunk's, results.csv, summary.csv and the MIDI files."""
    from rule_guided_music_tpu_torch import sample_rule

    config = os.path.join(tmp, "scg.json")
    with open(config, "w") as f:
        json.dump(YAML_TREES["cond_table/all/scg.yml"], f)
    out = os.path.join(tmp, f"quant_{mode}_{dtype}")
    argv = ["--config_path", config, "--batch_size", "2", "--num_samples", "2",
            "--class_cond", "True", "--timestep_respacing", "10", "--quant", mode,
            "--dtype", dtype, "--out_dir", out]
    # no warm-up: the int8 chain has just run every shape of this path
    rows, wall, launches, peak = measured_chain(
        torch, port, lambda: sample_rule.main(argv), lambda: None)
    print(f"sample_rule.main --quant {mode} --dtype {dtype} on scg.yml: {wall:.3f} s "
          f"for one batch of 2 (models built and quantized inside), peak {peak:.2f} GiB")
    # a GEMM per trunk linear a DiT call: 4 x 28 x (10 trajectory + 9 rollout)
    gemms = 4 * 28 * (10 + 9)
    fp32 = dtype == "float32"
    w8a16 = "w8a16_gemm_fp32" if fp32 else "w8a16_gemm"
    check_launches(launches, {"flash_attention": 0 if fp32 else 28 * (10 + 9),
                              "flash_attention_fp32": 28 * (10 + 9) if fp32 else 0,
                              "groupnorm_swish": 29 * (9 + 1),
                              "w8a16_gemm": 0, "w8a16_gemm_fp32": 0,
                              w8a16: gemms if mode == "w8a16" else 0,
                              "w8a8_gemm": gemms if mode == "w8a8" else 0,
                              "quantize_rows": gemms if mode == "w8a8" else 0})
    midis = [x for x in os.listdir(out) if x.endswith(".midi")]
    if len(rows) != 2 or len(midis) != 2 or not os.path.exists(
            os.path.join(out, "summary.csv")):
        raise AssertionError(f"--quant {mode}: results, summary or MIDI missing")
    return launches


def check_quant_linear(torch):
    """QuantLinear on the card (the int8 kernels) against the port's CPU
    QuantLinear (the plain versions) on the same fp32 inputs and buffers,
    both modes, at XL_8's qkv (512 tokens) and XS_8's qkv at 16 tokens;
    fp32 without TF32: the output within QUANT_LINEAR_TOL and the gradient
    with respect to the input (the kernels' autograd Functions against
    autograd through the plain versions) within QUANT_GRAD_TOL, each of
    its largest. Returns the worst errors per mode."""
    from rule_guided_music_tpu_torch.ops.quant import QuantLinear

    gen = torch.Generator().manual_seed(41)
    worst = {mode: dict(out=0.0, grad=0.0) for mode in QUANT_MODES}
    rel = lambda got, want: ((got.cpu() - want).abs().max() / want.abs().max()).item()
    with no_tf32(torch):
        for (k_in, n_out), tokens in (((1152, 3456), 512), ((64, 192), 16)):
            for mode in QUANT_MODES:
                lin = QuantLinear(k_in, n_out, mode=mode)
                lin.weight.copy_(torch.randint(-127, 128, (n_out, k_in),
                                               generator=gen, dtype=torch.int8))
                lin.scale.copy_(torch.rand(n_out, generator=gen) / 127)
                lin.bias.copy_(0.1 * torch.randn(n_out, generator=gen))
                x = torch.randn((1, tokens, k_in), generator=gen)
                r = torch.randn((1, tokens, n_out), generator=gen)
                got, want = {}, {}
                for dev, out in (("cpu", want), ("cuda", got)):
                    x_in = x.to(dev).requires_grad_()
                    y = lin.to(dev)(x_in)
                    out["y"] = y.detach()
                    out["grad"] = torch.autograd.grad((y * r.to(dev)).sum(), x_in)[0]
                err = dict(out=rel(got["y"], want["y"]),
                           grad=rel(got["grad"], want["grad"]))
                for key in err:
                    worst[mode][key] = max(worst[mode][key], err[key])
                print(f"QuantLinear {mode} {k_in}->{n_out} at {tokens} tokens, "
                      f"card vs CPU (fp32), error over the largest: output "
                      f"{err['out']:.3e} (tol {QUANT_LINEAR_TOL[mode]:.0e}), "
                      f"input gradient {err['grad']:.3e} (tol "
                      f"{QUANT_GRAD_TOL:.0e})")
                if err["out"] > QUANT_LINEAR_TOL[mode] or err["grad"] > QUANT_GRAD_TOL:
                    raise AssertionError(f"QuantLinear {mode}: card vs CPU {err}")
    return worst


def quant_envelope_on_card(torch, port):
    """quality_tiny's XS_8 with its trunk quantized, on the card in fp32
    without TF32: eps against the fp trunk's within JAX's envelope at four
    steps of a 16-step chain (tests/test_quant.py's inputs drawn by numpy),
    and against the CPU's quantized model; so too, at step 7, the gradient
    of <eps, r> with respect to x_t, the one DPS takes through the
    denoiser."""
    import numpy as np

    pipeline = port["pipeline"]
    fixture = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (4, 4, 128, 16)).astype(np.float32))
    r = torch.as_tensor(np.random.default_rng(8).standard_normal(
        x.shape).astype(np.float32))
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
            grads = {}
            with torch.enable_grad():
                for dev, model in models.items():
                    x_in = x.to(dev).requires_grad_()
                    eps = model(x_in, torch.full((4,), 7, device=dev))
                    grads[dev] = torch.autograd.grad((eps * r.to(dev)).sum(), x_in)[0]
            grad = rel(grads["cuda"].cpu(), grads["cpu"])
            print(f"quality_tiny XS_8 {mode} on the card: eps against the fp "
                  f"trunk {env:.4e} (JAX's envelope {QUANT_ENVELOPE[mode]}), "
                  f"against the CPU's {mode} model {agree:.3e}, its gradient "
                  f"with respect to x_t {grad:.3e} (tol {QUANT_AGREE_TOL[mode]:.0e})")
            if (env >= QUANT_ENVELOPE[mode] or agree > QUANT_AGREE_TOL[mode]
                    or grad > QUANT_AGREE_TOL[mode]):
                raise AssertionError(f"{mode}: envelope {env}, card vs CPU {agree}, "
                                     f"gradient {grad}")
            out[mode] = dict(envelope=env, card_vs_cpu=agree, grad_card_vs_cpu=grad)
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
    return write_roll_manifest(f"{prefix}_train", n, length, seed)


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
    gn_row = check_gn_backward_calls(
        torch, gn, calls, f"train_vae's {len(calls)} call shapes "
        f"({TRAIN_VAE_CHUNKS} chunks, bf16)")
    gn_row["shape"] = (f"train_vae's {len(calls)} calls (encoder "
                       f"{norm_calls(vae.encoder)}, decoder {norm_calls(vae.decoder)}) "
                       f"on {TRAIN_VAE_CHUNKS} chunks, bf16, backward alone with "
                       f"dw/dbias")
    del calls, vae
    torch.cuda.empty_cache()
    return attn, gn_row


def check_gn_backward_calls(torch, gn, calls, label):
    """Kernel 2's backward with the weight and bias gradients on every
    captured (input, module) call, at the module's eps: each call against
    autograd through the plain forward and the plain backward, each called
    twice bit-equal, then the calls' backward timed beside
    F.group_norm+F.silu autograd, the plain backward and the bound, and the
    kernel's dx alone (no reduction)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    worst = 0.0
    leaves = []
    for x, mod in calls:
        w, b = mod.weight.detach().to(x.dtype), mod.bias.detach().to(x.dtype)
        cot = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        ins = [t.detach().requires_grad_() for t in (x, w, b)]
        before = (gn.backward_launches, gn.param_grad_launches)
        got = torch.autograd.grad(gn.groupnorm_swish(*ins, mod.num_groups, mod.eps),
                                  ins, cot)
        if (gn.backward_launches, gn.param_grad_launches) != (before[0] + 1,
                                                              before[1] + 1):
            raise AssertionError("groupnorm_swish backward with dw/dbias: "
                                 "launches did not move by one each")
        fp32 = [t.detach().float().requires_grad_() for t in (x, w, b)]
        autograd = torch.autograd.grad(gn.groupnorm_swish_reference(
            *fp32, mod.num_groups, mod.eps), fp32, cot.float())
        del fp32
        plain = gn.groupnorm_swish_backward_reference(x, w, b, cot, mod.num_groups,
                                                      mod.eps)
        worst = max(worst, *(max(rel_err(g, a), rel_err(g, p))
                             for g, a, p in zip(got, autograd, plain)))
        del got, autograd, plain
        leaves.append((ins, mod.num_groups, mod.eps, cot))
    # a repeat of every call on the same inputs: bit-equal gradients
    same = True
    for ins, g, eps, cot in leaves:
        first, second = (torch.autograd.grad(gn.groupnorm_swish(*ins, g, eps),
                                             ins, cot) for _ in range(2))
        same = same and all(torch.equal(a, b) for a, b in zip(first, second))
        del first, second
    print(f"groupnorm_swish backward kernel with dw/dbias at {label}, each called "
          f"twice on the same inputs: dx, dw and dbias bit-equal {same}")
    if not same:
        raise AssertionError("groupnorm_swish backward: a repeat call differs")
    ok = worst <= GRAD_TOL["bfloat16"]
    print(f"groupnorm_swish backward kernel with dw/dbias at {label}, eps "
          f"{sorted({e for _, _, e, _ in leaves})}, against autograd through the "
          f"plain forward and the plain backward: max abs error over the largest "
          f"gradient {worst:.2e} (tol {GRAD_TOL['bfloat16']:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"groupnorm_swish backward kernel disagrees at {label}")

    def bwd(fn):
        outs = [(fn(*ins, g, eps), ins, cot) for ins, g, eps, cot in leaves]
        return lambda: [torch.autograd.grad(out, ins, cot, retain_graph=True)
                        for out, ins, cot in outs]

    before = gn.param_grad_launches
    ms = cuda_time_ms(bwd(gn.groupnorm_swish), reps=3, warmup=1)
    if gn.param_grad_launches - before != 4 * len(leaves):
        raise AssertionError("the timed backward calls did not each reduce dw/dbias")
    # the same calls with x alone wanting a gradient: no dw/dbias reduction
    outs = [(gn.groupnorm_swish(ins[0], ins[1].detach(), ins[2].detach(), g, eps),
             ins[0], cot) for ins, g, eps, cot in leaves]
    dx_ms = cuda_time_ms(lambda: [torch.autograd.grad(out, x, cot, retain_graph=True)
                                  for out, x, cot in outs], reps=3, warmup=1)
    del outs
    lib = cuda_time_ms(bwd(library_gn), reps=3, warmup=1)
    plain = cuda_time_ms(lambda: [gn.groupnorm_swish_backward_reference(
        *(t.detach() for t in ins), cot, g, eps) for ins, g, eps, cot in leaves],
        reps=3, warmup=1)
    # device time alone (torch.profiler): where the calls are small, the
    # events above time the host's autograd and wrapper work (late in a long
    # process the profiler loses kernel events: device_ms then gives None)
    dev, lib_dev = (device_ms(torch, bwd(fn)) for fn in (gn.groupnorm_swish,
                                                          library_gn))
    elems = sum(ins[0].numel() for ins, _, _, _ in leaves)
    # x and dy read, dx written (bf16); dw and dbias are C-sized
    bnd, by = bound_and_kind(3 * elems * 2, 20 * elems, "float32")
    print(f"groupnorm_swish backward with dw/dbias, {label}: {len(leaves)} calls, "
          f"{elems / 1e9:.3f} G elements: kernel {ms:.4f} ms, F.group_norm+F.silu "
          f"{lib:.4f} ms, plain backward {plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"{100 * bnd / ms:.1f}% of the bound; the kernel's dx alone (no "
          f"reduction) {dx_ms:.4f} ms; device time (torch.profiler) kernel "
          f"{fmt_ms(dev)}, F.group_norm+F.silu {fmt_ms(lib_dev)}")
    del leaves
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, dx_alone_ms=dx_ms, bit_equal=same,
                device_ms=dev, library_device_ms=lib_dev,
                shape=f"{label}, backward alone with dw/dbias")


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


def train_step_breakdown(torch, loop, label="train_dit"):
    """One more train step of ``loop`` cut by CUDA events: the batch
    (loading, encode and get_kl_input, the draws), the forward with the
    loss, the backward, the optimizer's step (AdamW or Adafactor) and the
    EMA."""
    from rule_guided_music_tpu_torch.diffusion import gaussian as gd
    from rule_guided_music_tpu_torch.training import train_loop as ttl

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
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
    ev[4].record()
    ttl._ema_update(loop.state, cfg.ema_rate)
    ev[5].record()
    torch.cuda.synchronize()
    loop.state.optimizer.zero_grad(set_to_none=True)
    names = ("batch: load, encode + get_kl_input, draws", "forward + loss",
             "backward", f"optimizer step ({type(loop.state.optimizer).__name__})",
             "EMA")
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    for n, v in parts.items():
        print(f"breakdown {label} {n}: {v:.2f} ms")
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


def update_agrees(torch, label, cpu_named, card_named, grads, lr, extra=(),
                     ema=None):
    """One optimizer step (Adam, or Adafactor whose first update of an
    unfactored element is also +-lr times a scale <= 1), card against CPU:
    ``grads`` maps each name to the
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
    return update_agrees(
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
    return update_agrees(
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


# classifier and pixel training: each trainer through its main at the JAX
# script's default widths and batch for SLICE13_STEPS steps (the first a
# warm-up: ms a step is the median of the rest); kernel 1 at the shapes they
# differentiate, bf16, forward and backward against the plain versions, N =
# 4097 (DiT-S/2-cls: 64 x 64 patches and a CLS row) compared at batch 2 (the
# plain backward at batch 32 would hold ~40 GB of fp32 logits) and timed at
# batch 32 beside SDPA and the bound; kernel 2's backward with dw/dbias on
# every call of one UNet forward at batch 16 (eps 1e-5); train_dit
# --optimizer adafactor at XL_8 batch 32 beside AdamW's peak; the synthetic
# data: seeded make_rolls rolls written as uint8 .npy (32 of them, a batch)
SLICE13_STEPS = 4
SLICE13_ATTN_SHAPES = [(32, 257, 6, 64), (16, 1024, 4, 64), (16, 256, 4, 96),
                       (16, 64, 4, 128), (16, 256, 12, 64), (2, 4097, 6, 64)]
CLS_PIXEL_ATTN_SHAPE = (32, 4097, 6, 64)
SLICE13_ROLLS = 32
PIXEL_UNET_BATCH = 16
ADAFACTOR_STEPS = 4
ADAMW_PEAK_GIB = 24.63      # train_dit's AdamW peak at XL_8 batch 32 (this script's
                            # train_dit phase, PERF.md)
# Adafactor card vs CPU: its second moments are means of g^2 (the first
# update's are g^2 itself), and a square's error relative to its largest is
# twice its root's, so they are held to twice the gradients' tolerance
ADAFACTOR_MOMENT_TOL = 2 * TRAIN_GRAD_TOL


def write_roll_manifest(prefix, n, length, seed):
    """``<prefix>.csv`` listing ``n`` seeded uint8 rolls of ``length``
    columns with labels 0, 1, 2, ..."""
    import csv

    import numpy as np

    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    rows = []
    for i, roll in enumerate(make_rolls(n, length=length, seed=seed)):
        path = f"{prefix}{i}.npy"
        np.save(path, np.round((roll + 1.0) * 63.5).astype(np.uint8))
        rows.append([path, i % 3])
    with open(f"{prefix}.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        writer.writerows(rows)
    return f"{prefix}.csv"


def time_attention_large(torch, fa, F, gen, shape, label):
    """Kernel 1 bf16 at a shape too large for the plain version: the
    forward and the backward alone beside SDPA and the bounds."""
    b, n, h, d = shape
    leaves = [torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: fa.flash_attention(*leaves), reps=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in leaves)
        lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                               reps=5, warmup=1)
    out = fa.flash_attention(*leaves)
    lib_out = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in leaves)).transpose(1, 2)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                   retain_graph=True), reps=5, warmup=1)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(lib_out, leaves, cot,
                                                       retain_graph=True),
                           reps=5, warmup=1)
    bnd, by = bound_and_kind(4 * b * n * h * d * 2, 4 * b * h * n * n * d, "bfloat16")
    bnd_bwd, by_bwd = attention_bwd_bound(shape)
    print(f"attention {shape} bf16, {label}: forward kernel {fwd:.4f} ms, SDPA "
          f"{lib_fwd:.4f} ms, bound {bnd:.4f} ms ({by}), {100 * bnd / fwd:.1f}% of "
          f"the bound; backward alone kernel {bwd:.4f} ms, SDPA {lib_bwd:.4f} ms, "
          f"bound {bnd_bwd:.4f} ms ({by_bwd}), {100 * bnd_bwd / bwd:.1f}% of the "
          f"bound; the plain versions: not run (fp32 logits of "
          f"{4 * b * h * n * n / 2 ** 30:.1f} GiB)")
    del leaves, out, lib_out
    torch.cuda.empty_cache()
    return dict(ms=fwd, library_ms=lib_fwd, bound_ms=bnd, bound_by=by, plain_ms=None,
                bwd_ms=bwd, library_bwd_ms=lib_bwd, bwd_bound_ms=bnd_bwd,
                bwd_bound_by=by_bwd, plain_bwd_ms=None,
                shape=f"{shape} bf16, one launch each way")


def pixel_unet_train_model(torch):
    """train_unet_pixel's UNet at its defaults (128 channels, mult
    (1,1,2,3,4), 2 res blocks, attention at 128 // (32, 16, 8), 3 labels),
    fp32 masters on the card, seeded random weights."""
    from rule_guided_music_tpu_torch import pipeline

    return pipeline.randomize_(pipeline.create_unet(
        dtype=torch.float32, device="cuda", attention_resolutions=(4, 8, 16),
        num_classes=3), seed=4)


def encoder_unet_card_vs_cpu(torch, port):
    """EncoderUNetModel (64 channels, mult (1, 2, 2), attention at 16 x 16 and
    in the middle with heads of 64, resblock_updown, attention pooling),
    fp32 without TF32, on a (2, 3, 64, 64) batch from the same weights:
    the logits, and every parameter's gradient of a seeded cotangent, card
    against CPU within TOL (logits, of the largest) and TRAIN_GRAD_TOL (each
    gradient, of the model's largest); on the card both kernels forward and
    backward (kernel 2 with dw/dbias)."""
    from rule_guided_music_tpu_torch.models.unet import AttentionBlock, EncoderUNetModel
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    fa, gn = port["fa"], port["gn"]
    torch.manual_seed(13)
    ref = EncoderUNetModel(model_channels=64, channel_mult=(1, 2, 2),
                           attention_resolutions=(4,), out_channels=16)
    port["pipeline"].randomize_(ref, seed=13)
    gen = torch.Generator().manual_seed(14)
    x = torch.randn((2, 3, 64, 64), generator=gen)
    t = torch.tensor([17.0, 640.0])
    cot = torch.randn((2, 16), generator=gen)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            model = copy.deepcopy(ref).to(device)
            reset_counts(fa, gn)
            logits = model(x.to(device), t.to(device))
            logits.backward(cot.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_counts(fa, gn)
            out[device] = (logits.detach().cpu(),
                           {n: p.grad.cpu() for n, p in model.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    attn, norms = (sum(isinstance(m, cls) for m in ref.modules())
                   for cls in (AttentionBlock, FusedNormSwish))
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": attn,
                              "flash_attention_bwd_fp32": attn,
                              "groupnorm_swish": norms, "groupnorm_swish_bwd": norms,
                              "groupnorm_swish_param_grad": norms})
    err = rel_err(lg, lc)
    gmax = max(g.abs().max().item() for g in gc.values())
    grad_err = max((gg[n] - g).abs().max().item() for n, g in gc.items()) / gmax
    ok = err <= TOL["float32"] and grad_err <= TRAIN_GRAD_TOL
    print(f"EncoderUNetModel forward and backward, card vs CPU (fp32, {attn} "
          f"attention blocks, {norms} fused norms): logits max abs error over the "
          f"largest {err:.2e} (tol {TOL['float32']:.0e}), gradients {grad_err:.2e} "
          f"(tol {TRAIN_GRAD_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("EncoderUNetModel: the card disagrees with the CPU")
    return max(err, grad_err)


def check_slice13_kernels(torch, fa, gn, F):
    """Kernel 1 bf16 at the classifier and pixel trainers' shapes: forward
    (contiguous and on qkv views) and backward against the plain versions,
    timed beside them, SDPA and the bounds; at CLS_PIXEL_ATTN_SHAPE timed
    without the plain versions. Kernel 2's backward with dw/dbias on every
    call of one forward of train_unet_pixel's UNet at batch 16 under
    autocast (eps 1e-5)."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    rows, worst = {}, 0.0
    for i, shape in enumerate(SLICE13_ATTN_SHAPES):
        label = f"training at {shape}"
        row = check_attention_at(torch, fa, F, shape, label, (torch.bfloat16,),
                                 seed=50 + i)
        worst = max(worst, check_attention_grad_at(torch, fa, gen, shape,
                                                   ("bfloat16",))["bfloat16"])
        row.update(time_attention_fwd_bwd(torch, fa, F, gen, shape, label))
        rows[str(shape)] = row
        torch.cuda.empty_cache()
    rows[str(CLS_PIXEL_ATTN_SHAPE)] = time_attention_large(
        torch, fa, F, gen, CLS_PIXEL_ATTN_SHAPE, "train_classifier_pixel's DiT-S/2-cls")
    unet = pixel_unet_train_model(torch)
    x = torch.rand((PIXEL_UNET_BATCH, 3, 128, 128), generator=gen, device="cuda") * 2 - 1
    t = torch.full((PIXEL_UNET_BATCH,), 400.0, device="cuda")
    y = torch.arange(PIXEL_UNET_BATCH, device="cuda") % 3
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, launches = capture_norm_inputs(torch, gn, unet, lambda: unet(x, t, y))
    if (len(calls), launches) != (UNET_GN_PER_FORWARD, UNET_GN_PER_FORWARD) or any(
            mod.eps != 1e-5 for _, mod in calls):
        raise AssertionError(f"UNet forward at batch {PIXEL_UNET_BATCH}: "
                             f"{len(calls)} calls, {launches} launches")
    gn_row = check_gn_backward_calls(
        torch, gn, calls, f"one UNet forward's {len(calls)} calls at batch "
        f"{PIXEL_UNET_BATCH} (bf16, eps 1e-5)")
    del calls, unet, x
    torch.cuda.empty_cache()
    return rows, worst, gn_row


def logged_losses(run_dir):
    """The ``loss`` column of a run's progress.csv."""
    import csv

    with open(os.path.join(run_dir, "progress.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def median_after_first(values):
    import statistics

    return statistics.median(values[1:])


def run_trainer(torch, port, label, run, expected, batch, unit, n_steps=None):
    """``run()`` a trainer's main from zeroed counts and a reset peak; the
    launches checked against ``expected``; ms a step (median of the steps
    after the first), ``batch`` ``unit``/s and the peak printed. ``run``
    returns (step ms list, losses, extra dict)."""
    import numpy as np

    fa, gn = port["fa"], port["gn"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    steps, losses, extra = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches(launches, expected)
    if len(losses) != (n_steps or SLICE13_STEPS) or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    ms = median_after_first(steps)
    print(f"{label}: steps {', '.join(f'{v:.1f}' for v in steps)} ms (warm-up "
          f"first); {ms:.2f} ms a step (median of steps 1-{len(steps) - 1}), "
          f"{1e3 * batch / ms:.1f} {unit}/s; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; peak {peak:.2f} GiB; main "
          f"{wall:.1f} s")
    torch.cuda.empty_cache()
    return launches, dict(ms_per_step=ms, steps_ms=steps, peak_gib=peak,
                          losses=losses, **extra)


def classifier_train_path(torch, port, tmp, rule, manifest):
    """``classifier_train_aug.main`` at the JAX script's defaults
    (DiTRotary-S/8-cls, or DiTRotary-S/8-chord-cls with 8 chord classes for
    a chord rule; batch 32 rolls of 1024 columns, the production VAE
    encoder under no_grad, bf16) for SLICE13_STEPS steps: 12 forward and
    12 backward calls of kernel 1 a step at (32,257,6,64), 21 of kernel 2
    (the encoder of 256 chunks) and no backward of it."""
    from rule_guided_music_tpu_torch import classifier_train_aug

    chord = "chord" in rule
    flags = ["--data_dir", manifest, "--rule", rule, "--dir",
             os.path.join(tmp, f"cls_{rule}"), "--iterations", str(SLICE13_STEPS),
             "--log_interval", "1"]
    if chord:
        flags += ["--classifier_name", "DiTRotary-S/8-chord-cls", "--num_classes", "8"]
    box = {}

    def run():
        model, history = classifier_train_aug.main(flags)
        box["blocks"] = len(model.blocks)
        return history["ms"], history["loss"], {}

    n = SLICE13_STEPS
    vae_norms = 21
    launches, row = run_trainer(
        torch, port, f"classifier_train_aug {rule} "
        f"({'DiTRotary-S/8-chord-cls' if chord else 'DiTRotary-S/8-cls'}), batch 32 "
        f"latents, bf16", run, {"flash_attention": 12 * n, "flash_attention_fp32": 0,
                                "flash_attention_bwd": 12 * n,
                                "groupnorm_swish": vae_norms * n}, 32, "latents")
    if box["blocks"] != 12:
        raise AssertionError(f"classifier of {box['blocks']} blocks")
    return launches, row


def pixel_trainer_path(torch, port, tmp, name, manifest):
    """``pixel.train_unet_pixel.main`` or ``pixel.train_dit_pixel.main`` at
    the JAX script's defaults (batch 16 rolls of (3, 128, 128), bf16,
    AdamW, EMA) for SLICE13_STEPS steps, then its save (deleted): the
    UNet's 16 attention blocks forward and backward and its 28 fused norms
    forward, backward and dw/dbias a step; DiT-B/8's 12 blocks forward and
    backward."""
    from rule_guided_music_tpu_torch.pixel import train_dit_pixel, train_unet_pixel

    module = {"unet": train_unet_pixel, "dit": train_dit_pixel}[name]
    run_dir = os.path.join(tmp, f"pixel_{name}")
    n = SLICE13_STEPS

    def run():
        loop = module.main(["--data_dir", manifest, "--dir", run_dir, "--max_steps",
                            str(n), "--log_interval", "1"])
        losses = logged_losses(run_dir)
        if loop.state.updates != n:
            raise AssertionError(f"{name}: {n - loop.state.updates} steps skipped")
        shutil.rmtree(os.path.join(run_dir, "checkpoints"))
        return loop.step_ms, losses, {}

    if name == "unet":
        expected = {"flash_attention": UNET_ATTN_PER_FORWARD * n,
                    "flash_attention_fp32": 0,
                    "flash_attention_bwd": UNET_ATTN_PER_FORWARD * n,
                    "groupnorm_swish": UNET_GN_PER_FORWARD * n,
                    "groupnorm_swish_bwd": UNET_GN_PER_FORWARD * n,
                    "groupnorm_swish_param_grad": UNET_GN_PER_FORWARD * n}
        label = "train_unet_pixel (UNet ch 128), batch 16, bf16"
    else:
        expected = {"flash_attention": 12 * n, "flash_attention_fp32": 0,
                    "flash_attention_bwd": 12 * n, "groupnorm_swish": 0}
        label = "train_dit_pixel (DiT-B/8), batch 16, bf16"
    return run_trainer(torch, port, label, run, expected, PIXEL_UNET_BATCH, "rolls")


def classifier_pixel_path(torch, port, tmp, manifest):
    """``pixel.train_classifier_pixel.main`` at the JAX script's defaults
    (DiT-S/2-cls, N = 4097, batch 32 rolls of (3, 128, 128),
    note_density_pixel, bf16) for SLICE13_STEPS steps: 12 forward and 12
    backward calls of kernel 1 a step at (32,4097,6,64)."""
    from rule_guided_music_tpu_torch.pixel import train_classifier_pixel

    n = SLICE13_STEPS

    def run():
        _, history = train_classifier_pixel.main([
            "--data_dir", manifest, "--dir", os.path.join(tmp, "pixel_cls"),
            "--iterations", str(n), "--log_interval", "1"])
        return history["ms"], history["loss"], {}

    return run_trainer(torch, port, "train_classifier_pixel (DiT-S/2-cls, N = 4097), "
                       "batch 32, bf16", run,
                       {"flash_attention": 12 * n, "flash_attention_fp32": 0,
                        "flash_attention_bwd": 12 * n, "groupnorm_swish": 0},
                       32, "rolls")


def train_dit_adafactor_path(torch, port, tmp, manifest):
    """``train_dit.main --optimizer adafactor`` at the JAX script's other
    defaults (XL_8, batch 32, bf16, EMA, the production VAE encoder) for
    ADAFACTOR_STEPS steps, its save deleted; then one step more cut by CUDA
    events (the optimizer step's ms); the peak beside AdamW's."""
    from rule_guided_music_tpu_torch import train_dit
    from rule_guided_music_tpu_torch.training.adafactor import Adafactor

    n = ADAFACTOR_STEPS
    box = {}

    def run():
        run_dir = os.path.join(tmp, "train_dit_adafactor")
        loop = train_dit.main(["--data_dir", manifest, "--dir", run_dir,
                               "--optimizer", "adafactor", "--max_steps", str(n),
                               "--log_interval", "1"])
        if not isinstance(loop.state.optimizer, Adafactor) or loop.state.updates != n:
            raise AssertionError("train_dit --optimizer adafactor: wrong optimizer "
                                 "or a skipped step")
        shutil.rmtree(os.path.join(run_dir, "checkpoints"))
        box["loop"] = loop
        return loop.step_ms, logged_losses(run_dir), {}

    blocks = 28
    launches, row = run_trainer(
        torch, port, "train_dit --optimizer adafactor (XL_8), batch 32 latents, bf16",
        run, {"flash_attention": blocks * n, "flash_attention_fp32": 0,
              "flash_attention_bwd": blocks * n, "groupnorm_swish": 21 * n}, 32,
        "latents")
    loop = box.pop("loop")
    state_gib = sum(v.numel() * v.element_size() for st in loop.state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v)) / 2 ** 30
    row.update(train_step_breakdown(torch, loop, "train_dit adafactor"))
    opt_ms = next(v for k, v in row["breakdown_ms"].items() if k.startswith("optimizer"))
    print(f"train_dit adafactor: peak {row['peak_gib']:.2f} GiB against AdamW's "
          f"{ADAMW_PEAK_GIB} GiB; optimizer state {state_gib:.3f} GiB; the "
          f"optimizer step {opt_ms:.2f} ms")
    row.update(state_gib=state_gib, optimizer_step_ms=opt_ms)
    del loop
    torch.cuda.empty_cache()
    return launches, row


def adafactor_card_vs_cpu(torch, port):
    """One fp32 train step with Adafactor (weight decay 0.01) of a 2-block
    rotary DiT 256 wide (its linears factored) on the card and on the CPU
    from the same weights, batch, t, noise and drop mask, TF32 off: the
    loss, the updated parameters (update_agrees: elementwise where the
    gradient is settled; elsewhere within 2 lr, as Adafactor's first update
    of an unfactored element is lr rms(p) g / |g|) and the factored and
    unfactored second moments, each within ADAFACTOR_MOMENT_TOL of its
    tensor's largest."""
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.models.dit import DiTRotary, init_weights_
    from rule_guided_music_tpu_torch.training import train_loop as ttl
    from rule_guided_music_tpu_torch.training.adafactor import factored_dims

    config = ttl.TrainConfig(lr=1e-3, optimizer="adafactor", weight_decay=0.01,
                             ema_rate=0.9999)
    gen = torch.Generator().manual_seed(15)
    ref = init_weights_(DiTRotary(depth=2, hidden_size=256, num_heads=4,
                                  num_classes=3), gen)
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    inputs = _train_inputs(torch, 16)
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            model = copy.deepcopy(ref).to(device)
            state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                                   optimizer=ttl.make_optimizer(config,
                                                                model.parameters()))
            grads = {}
            step = state.optimizer.step

            def record_then_step(step=step, model=model, grads=grads):
                grads.update({n: p.grad.detach().float().cpu().clone()
                              for n, p in model.named_parameters()})
                return step()

            state.optimizer.step = record_then_step
            metrics = ttl.make_train_step(model, make_schedule("linear", 1000).tables(
                device), config)(state, *(a.to(device) for a in inputs))
            out[device] = (metrics, state, grads)
    (mc, sc, gc), (mg, sg, gg) = out["cpu"], out["cuda"]
    factored = sum(factored_dims(tuple(p.shape)) is not None for p in ref.parameters())
    moments = 0.0
    for (n, pc), pg in zip(sc.model.named_parameters(), sg.model.parameters()):
        a, b = sc.optimizer.state[pc], sg.optimizer.state[pg]
        for key in set(a) - {"count"}:
            moments = max(moments, rel_err(b[key].cpu(), a[key]))
    worst = update_agrees(
        torch, f"Adafactor fp32 train step (2-block rotary DiT 256 wide, {factored} "
        f"factored tensors)", {n: p.detach() for n, p in sc.model.named_parameters()},
        dict(sg.model.named_parameters()), {n: (gc[n], gg[n]) for n in gc},
        config.lr, [(k, mg[k], mc[k]) for k in ("loss", "per_example_loss")])
    ok = moments <= ADAFACTOR_MOMENT_TOL and factored > 0
    print(f"Adafactor second moments (v_row, v_col, v), card vs CPU: max abs error "
          f"over each tensor's largest {moments:.2e} (tol {ADAFACTOR_MOMENT_TOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Adafactor: the card's state disagrees with the CPU's")
    return worst


# the backward kernels' counters: a path that differentiates names its
# backward launches; every other path must take none
BWD_COUNTS = ("flash_attention_bwd", "flash_attention_bwd_fp32",
              "groupnorm_swish_bwd", "groupnorm_swish_param_grad")


# parallelism (slice 14): one rank, NCCL, on the card machine's one GPU
MESH_STEPS = 3
MESH_EXTRA_STEPS = 10       # each loop's, in turn, loading included
PIPE_MICRO = 4
MESH_AGREE_TOL = 1e-5       # step 1's loss and grad_norm, mesh vs plain (relative)
# killed between two saves, so the resume replays from the save before
SOAK_ARGS = ["--total_steps", "40", "--kill_at_step", "25", "--save_interval", "10",
             "--log_interval", "2", "--eval_interval", "20"]


def init_world(torch, tmp):
    """The default process group: one rank, NCCL, a file store in ``tmp``."""
    import torch.distributed as dist

    from rule_guided_music_tpu_torch.parallel.mesh import maybe_init_distributed

    os.environ["RGM_DIST_STORE"] = os.path.join(tmp, "dist_store")
    maybe_init_distributed("cuda", force=True)
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        raise AssertionError(f"world {dist.get_world_size()}, {dist.get_backend()}")
    print(f"process group: world 1, {dist.get_backend()}, "
          f"{os.environ['RGM_DIST_STORE']}")


def mesh_train_path(torch, port, tmp, manifest):
    """``train_dit.main`` at the JAX defaults (XL_8, batch 32, bf16, AdamW,
    the production VAE encoder) for MESH_STEPS steps plain, then with
    ``--dp 1 --fsdp 1 --tp 1`` through the mesh code (DTensor parameters,
    each block gathered in its forward, the mesh's save) while the plain
    loop is kept: kernel 1's launches, 28 forward and 28 backward a step;
    step 1's loss and grad_norm against the plain run's (same seed, same
    batch); then MESH_EXTRA_STEPS steps of each loop in turn (plain, mesh,
    plain, ...: the host's drift between two windows falls on both alike),
    timed, the ratio of their medians, and one step more of each cut by
    CUDA events (``train_step_breakdown``). The mesh run's peak is also
    printed less the plain loop's memory, which stays allocated through
    it."""
    from rule_guided_music_tpu_torch import train_dit
    from rule_guided_music_tpu_torch.parallel import mesh as pm

    n, rows, loops = MESH_STEPS, {}, {}
    for label, flags in (("plain", []), ("mesh", ["--dp", "1", "--fsdp", "1",
                                                   "--tp", "1"])):
        box = {}

        def run():
            run_dir = os.path.join(tmp, f"train_dit_{label}")
            # the VAE without --vae_path takes torch's default init: seed it
            # alike for both runs, so they see one batch of latents
            torch.manual_seed(0)
            loop = train_dit.main(["--data_dir", manifest, "--dir", run_dir,
                                   "--max_steps", str(n), "--log_interval", "1",
                                   *flags])
            if pm.is_sharded(loop.model) != (label == "mesh") or loop.state.updates != n:
                raise AssertionError(f"train_dit {label}: sharded "
                                     f"{pm.is_sharded(loop.model)}, {loop.state.updates} "
                                     f"updates")
            with open(os.path.join(run_dir, "progress.csv")) as f:
                box["grad_norm"] = [float(r["grad_norm"]) for r in csv.DictReader(f)]
            shutil.rmtree(os.path.join(run_dir, "checkpoints"))
            box["loop"] = loop
            return loop.step_ms, logged_losses(run_dir), {}

        held = torch.cuda.memory_allocated()
        launches, rows[label] = run_trainer(
            torch, port, f"train_dit {label} (XL_8), batch 32 latents, bf16", run,
            {"flash_attention": 28 * n, "flash_attention_fp32": 0,
             "flash_attention_bwd": 28 * n, "groupnorm_swish": 21 * n}, 32, "latents",
            n_steps=n)
        rows[label]["grad_norm"] = box["grad_norm"]
        rows[label]["peak_gib_own"] = rows[label]["peak_gib"] - held / 2 ** 30
        loops[label] = box.pop("loop")
    print(f"train_dit mesh peak less the plain loop's {held / 2 ** 30:.2f} GiB: "
          f"{rows['mesh']['peak_gib_own']:.2f} GiB")
    extra = {label: [] for label in loops}
    for _ in range(MESH_EXTRA_STEPS):
        for label, loop in loops.items():
            t0 = time.perf_counter()
            loop.run_step(*next(loop.data))
            torch.cuda.synchronize()
            extra[label].append(1e3 * (time.perf_counter() - t0))
    for label, loop in loops.items():
        rows[label]["extra_steps_ms"] = extra[label]
        rows[label]["extra_median_ms"] = statistics.median(extra[label])
        rows[label].update(train_step_breakdown(torch, loop, f"train_dit {label}"))
    del loop
    loops.clear()
    torch.cuda.empty_cache()
    for key in ("losses", "grad_norm"):
        a, b = rows["mesh"][key][0], rows["plain"][key][0]
        if abs(a - b) > MESH_AGREE_TOL * abs(b):
            raise AssertionError(f"mesh step 1 {key} {a} against plain {b}")
    ratio = rows["mesh"]["extra_median_ms"] / rows["plain"]["extra_median_ms"]
    print(f"train_dit mesh (1, 1, 1) against plain: step 1 loss "
          f"{rows['mesh']['losses'][0]:.6f} / {rows['plain']['losses'][0]:.6f}, "
          f"grad_norm {rows['mesh']['grad_norm'][0]:.6f} / "
          f"{rows['plain']['grad_norm'][0]:.6f}; {MESH_EXTRA_STEPS} steps each in turn: "
          f"{', '.join(f'{v:.1f}' for v in rows['mesh']['extra_steps_ms'])} / "
          f"{', '.join(f'{v:.1f}' for v in rows['plain']['extra_steps_ms'])} ms, "
          f"median {rows['mesh']['extra_median_ms']:.2f} / "
          f"{rows['plain']['extra_median_ms']:.2f} ms a step (x{ratio:.3f})")
    return launches, dict(rows, ratio=ratio)


def pipeline_path(torch, port):
    """``pipelined_dit_rotary_apply`` on XL_8 (bf16, seeded random weights)
    at batch 32 over a 1-rank stage mesh: GPipe with PIPE_MICRO
    microbatches (28 x 4 attention launches) and the circular schedule (M
    = S = 1: 28); each against ``model(x, t, y)`` within ATTN_TOL, ms
    beside the plain forward's."""
    from torch.distributed.device_mesh import DeviceMesh

    from rule_guided_music_tpu_torch.parallel.pipeline import (
        DroppedBlock, keep_stage_blocks_, pipelined_dit_rotary_apply)

    fa, gn, pipeline = port["fa"], port["gn"], port["pipeline"]
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("stage",))
    dit = pipeline.create_denoiser("DiTRotary_XL_8", dtype=torch.bfloat16, device="cuda")
    # a stage keeps the blocks it runs: the one stage here all 28, under
    # either schedule
    for schedule in ("gpipe", "circular"):
        keep_stage_blocks_(dit, mesh, schedule=schedule)
    held = sum(not isinstance(b, DroppedBlock) for b in dit.blocks)
    if held != len(dit.blocks):
        raise AssertionError(f"a 1-stage mesh kept {held} of {len(dit.blocks)} blocks")
    dit = pipeline.randomize_(dit, 41).eval()
    gen = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randn((32, 4, 128, 16), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (32,), generator=gen, device="cuda").float()
    y = torch.randint(0, 3, (32,), generator=gen, device="cuda")
    out = {}
    with torch.no_grad():
        ref = dit(x, t, y)
        out["plain_ms"] = cuda_time_ms(lambda: dit(x, t, y), reps=5, warmup=1)
        for schedule, launches in (("gpipe", 28 * PIPE_MICRO), ("circular", 28)):
            fn = lambda: pipelined_dit_rotary_apply(dit, x, t, y, mesh=mesh,
                                                    n_micro=PIPE_MICRO,
                                                    schedule=schedule)
            reset_counts(fa, gn)
            got = fn()
            torch.cuda.synchronize()
            counts = read_counts(fa, gn)
            check_launches(counts, {"flash_attention": launches,
                                    "flash_attention_fp32": 0, "groupnorm_swish": 0})
            err = rel_err(got, ref)
            if not torch.isfinite(got).all() or err > ATTN_TOL["bfloat16"]:
                raise AssertionError(f"pipelined {schedule}: error {err}")
            ms = cuda_time_ms(fn, reps=5, warmup=1)
            out[schedule] = dict(ms=ms, rel_err=err, launches=counts)
            print(f"pipelined_dit_rotary_apply {schedule}: {ms:.2f} ms against the "
                  f"plain forward's {out['plain_ms']:.2f} ms; error {err:.2e} "
                  f"(tolerance {ATTN_TOL['bfloat16']})")
    del dit
    torch.cuda.empty_cache()
    return out["gpipe"]["launches"], out["circular"]["launches"], out


def sample_mesh_path(torch, port, tmp):
    """``sample_rule.main`` on scg.yml (as JSON) at full width (XL_8 and the
    production decoder, bf16, k=16, B=2, 10 steps) without ``--mesh``, with
    ``--mesh 1`` and without again: the same results and byte-equal MIDI
    (the same draws), the same launches, and the wall time of each."""
    from rule_guided_music_tpu_torch import sample_rule

    config = os.path.join(tmp, "scg.json")
    with open(config, "w") as f:
        json.dump(YAML_TREES["cond_table/all/scg.yml"], f)
    runs = {}
    # plain, mesh, plain again: the first run also pays the first launches
    for label, flags in (("plain", []), ("mesh", ["--mesh", "1"]), ("plain2", [])):
        out = os.path.join(tmp, f"sample_{label}")
        argv = ["--config_path", config, "--batch_size", "2", "--num_samples", "2",
                "--class_cond", "True", "--timestep_respacing", "10",
                "--out_dir", out, *flags]
        # the models without a path take torch's default init: seed it alike
        torch.manual_seed(0)
        rows, wall, launches, peak = measured_chain(
            torch, port, lambda: sample_rule.main(argv), lambda: None)
        midis = sorted(x for x in os.listdir(out) if x.endswith(".midi"))
        runs[label] = dict(rows=rows, wall_s=wall, launches=launches, peak_gib=peak,
                           midi=[open(os.path.join(out, m), "rb").read() for m in midis])
        print(f"sample_rule.main {' '.join(flags) or '(no mesh)'} on scg.yml: "
              f"{wall:.3f} s for one batch of 2, peak {peak:.2f} GiB")
    a = runs["mesh"]
    for b in (runs["plain"], runs["plain2"]):
        if a["rows"] != b["rows"] or a["midi"] != b["midi"] or len(a["midi"]) != 2:
            raise AssertionError("sample_rule --mesh 1 differs from the plain run")
        check_launches(a["launches"], b["launches"])
    print("sample_rule --mesh 1: results and MIDI equal to the plain run's")
    return a["launches"], {k: {f: v[f] for f in ("wall_s", "peak_gib")}
                           for k, v in runs.items()}


def train_probe_path(torch):
    """``train_probe.main`` at its full geometry: every configuration ran."""
    from rule_guided_music_tpu_torch import train_probe

    res = train_probe.main(["--device", "cuda"])
    if res["failed"] or len(res["steps"]) != 4:
        raise AssertionError(f"train_probe: failed {res['failed']}")
    return res


def train_soak_path(torch, tmp):
    """``train_soak.main`` at the JAX soak's geometry (DiTRotary_XS_8, the
    fixture's small VAE, fp32, the loss-second-moment sampler, eval loss
    and eval sampling), 40 steps SIGKILLed past 25 (saves every 10), resumed:
    every check, the loss's last decile below 0.8 of its first."""
    from rule_guided_music_tpu_torch import train_soak

    res = train_soak.main(["--workdir", os.path.join(tmp, "soak"), "--device", "cuda",
                           *SOAK_ARGS])
    if not res["ok"]:
        raise AssertionError(f"train_soak: {res['checks']}")
    return res


# distillation and study scripts (slice 15): the distill CLIs at their
# published widths and batches, seeded random teachers, bf16 under autocast
DISTILL_DECODER_CHUNKS = 32          # distill_scoring_decoder's --batch 32
DISTILL_TEACHER_CHUNKS = 128         # distill_scoring_features' batch 16 x 8 chunks
DISTILL_TEACHER_ATTN = (16, 256, 16, 72)    # XL_8 teacher at --batch 16
DISTILL_STUDENT_ATTN = (16, 256, 12, 64)    # B_8 student at --batch 16
# the rollout distill's cut: its 2000 steps at 0.1-0.15 s would take 3-5
# minutes; 200 steps log two losses (it logs every 100)
DISTILL_ROLLOUT_STEPS, DISTILL_ROLLOUT_GROUPS = 200, 8
DISTILL_ROLLOUT_ARGS = ["--steps", str(DISTILL_ROLLOUT_STEPS), "--agree_groups",
                        str(DISTILL_ROLLOUT_GROUPS)]
DATA_MIDIS, DATA_SECONDS = 4, 60.0    # 46 chunks a piece
DATA_PREP_ARGS = ["--seq_chunks", "8", "--gap", "4", "--label", "1"]
COMPUTE_STD_CHUNKS = 16 * 8           # --batch_size 16 rolls of 1024 columns
GATE_VARIANTS = ("plain", "feat_pre4_light")
GATE_AGREE_TOL = 1e-3                 # seed 0's weighted loss, card vs CPU (relative)


@contextlib.contextmanager
def module_calls(torch):
    """Counts of the calls of every ``Attention`` and ``FusedNormSwish``
    module while the block runs (a global forward hook): one kernel launch
    each where the kernels run."""
    from rule_guided_music_tpu_torch.models.layers import Attention
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    counts = {"attention": 0, "groupnorm_swish": 0}

    def hook(mod, args, out):
        if isinstance(mod, Attention):
            counts["attention"] += 1
        elif isinstance(mod, FusedNormSwish):
            counts["groupnorm_swish"] += 1

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def check_distill_kernels(torch, fa, gn, F):
    """The slice's new kernel shapes, each against its plain version and
    timed beside the library and the bound: kernel 2's backward with
    dw/dbias on the ch=64 ScoringDecoder's 29 calls at 32 chunks (the
    decoder distill's student, fp32 masters under bf16 autocast); kernel 2
    forward on every call of the ch=128 teacher's decode of 128 chunks (the
    feature distill's) and of the production encoder's encode of 128
    chunks (compute_std's batch); kernel 1 forward at the XL_8 teacher's
    (16,256,16,72), and forward + backward at the B_8 student's
    (16,256,12,64)."""
    from rule_guided_music_tpu_torch.models.vae import AutoencoderKL, ScoringDecoder
    from rule_guided_music_tpu_torch.training.distill import flax_init_
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls
    from rule_guided_music_tpu_torch.diffusion.latent import pixels_to_chunks

    gen = torch.Generator(device="cuda").manual_seed(29)
    rows = {}
    student = flax_init_(ScoringDecoder(ch=64), 3).cuda()
    z = torch.randn((DISTILL_DECODER_CHUNKS, 4, 16, 16), generator=gen,
                    device="cuda") / 1.2465
    with torch.autocast("cuda", dtype=torch.bfloat16):
        calls, launches = capture_norm_inputs(torch, gn, student,
                                              lambda: student.decode(z))
    if len(calls) != norm_calls(student.decoder) or launches != len(calls):
        raise AssertionError(f"student: {len(calls)} calls, {launches} launches")
    rows["student_bwd"] = check_gn_backward_calls(
        torch, gn, calls, f"the ch=64 ScoringDecoder student's {len(calls)} call "
        f"shapes ({DISTILL_DECODER_CHUNKS} chunks, bf16)")
    del calls, student
    teacher = flax_init_(AutoencoderKL(ch=128), 1).cuda().to(torch.bfloat16)
    z = torch.randn((DISTILL_TEACHER_CHUNKS, 4, 16, 16), generator=gen,
                    device="cuda") / 1.2465
    calls, launches = capture_norm_inputs(torch, gn, teacher.decoder,
                                          lambda: teacher.decode(z))
    rows["teacher_decode"] = check_norm_calls(
        torch, gn, calls, "one ch=128 teacher decode", launches)
    del calls, teacher
    torch.cuda.empty_cache()
    vae = flax_init_(AutoencoderKL(encoder=True), 1).cuda().to(torch.bfloat16)
    chunks = pixels_to_chunks(torch.as_tensor(
        make_rolls(COMPUTE_STD_CHUNKS // 8, seed=13), device="cuda"))
    calls, launches = capture_norm_inputs(torch, gn, vae.encoder,
                                          lambda: vae.encode_moments(chunks))
    rows["compute_std_encode"] = check_norm_calls(
        torch, gn, calls, "one production-encoder encode (compute_std's batch)",
        launches)
    del calls, vae, chunks
    torch.cuda.empty_cache()
    rows["teacher_attention"] = check_attention_at(
        torch, fa, F, DISTILL_TEACHER_ATTN, "XL_8 teacher at the rollout "
        "distill's batch 16", (torch.bfloat16,), 31)
    rows["student_attention_grad_err"] = check_attention_grad_at(
        torch, fa, gen, DISTILL_STUDENT_ATTN, ("bfloat16",))["bfloat16"]
    rows["student_attention"] = time_attention_fwd_bwd(
        torch, fa, F, gen, DISTILL_STUDENT_ATTN, "B_8 student at the rollout "
        "distill's batch 16")
    torch.cuda.empty_cache()
    return rows


def run_distill(torch, port, label, module, argv, expected):
    """``module.main(argv)`` on the card from zeroed counts and a reset peak:
    the launches against ``expected(result)``, the last logged loss below
    the first, and seconds, ms a step (the median after the first), peak,
    the logged losses and the agreement printed. Then the written npz
    loaded through ``pipeline.ScoringBundle.create`` in float32 gives the
    trained module's outputs, bit for bit, under the same autocast."""
    fa, gn = port["fa"], port["gn"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    res = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches(launches, expected(res))
    (s0, first), (s1, last) = res["losses"][0], res["losses"][-1]
    ms = median_after_first(res["step_ms"])
    print(f"{label}: {wall:.1f} s, {len(res['step_ms'])} steps, {ms:.2f} ms a step "
          f"(median of steps 1-{len(res['step_ms']) - 1}), peak {peak:.2f} GiB; "
          f"loss at step {s0} {first:.5f}, at step {s1} {last:.5f}; agreement "
          f"{res['agreement']:.3f}")
    if not last < first:
        raise AssertionError(f"{label}: the loss did not fall ({res['losses']})")
    res.update(seconds=wall, ms_per_step=ms, peak_gib=peak)
    return launches, res


def loaded_agrees(torch, pipeline, label, res, kind, example):
    """The npz of ``res`` through ``ScoringBundle.create`` (float32, the
    trained module's dtype) against the trained module, bit for bit."""
    bundle = pipeline.ScoringBundle.create(**{
        "decoder": dict(decoder_path=res["out"]),
        "features": dict(features_path=res["out"]),
        "rollout": dict(rollout="DiTRotary_B_8", rollout_path=res["out"],
                        num_classes=3)}[kind], dtype=torch.float32, device="cuda")
    loaded = {"decoder": bundle.decoder, "features": bundle.feature_head,
              "rollout": bundle.rollout}[kind]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got, want = example(loaded), example(res["student"])
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"{label}: {res['out']} through ScoringBundle.create, float32, under "
          f"the same autocast: outputs bit-equal to the trained module's {same}")
    if not same:
        raise AssertionError(f"{label}: the loaded model's output differs")


def distill_decoder_path(torch, port, tmp):
    """``distill_scoring_decoder`` at its defaults, uncut: the ch=128 random
    teacher, the ch=64 student, batch 32, 400 steps, 32 groups of k=16."""
    from rule_guided_music_tpu_torch import distill_scoring_decoder as mod

    def expected(res):
        t, s = norm_calls(res["teacher"].decoder), norm_calls(res["student"].decoder)
        steps = len(res["step_ms"])
        return {"flash_attention": 0, "flash_attention_fp32": 0,
                "groupnorm_swish": steps * (t + s) + 32 * (t + s),
                "groupnorm_swish_bwd": steps * s, "groupnorm_swish_param_grad": steps * s}

    launches, res = run_distill(torch, port, "distill_scoring_decoder", mod, [
        "--out", os.path.join(tmp, "decoder_ch{ch}.npz")], expected)
    gen = torch.Generator(device="cuda").manual_seed(41)
    z = torch.randn((8, 4, 16, 16), generator=gen, device="cuda")
    loaded_agrees(torch, port["pipeline"], "distill_scoring_decoder", res, "decoder",
                  lambda m: [m.decode(z)])
    return launches, res


def distill_features_path(torch, port, tmp):
    """``distill_scoring_features`` at its defaults, uncut: batch 16 of
    latent_t 128, 600 steps, the ch=128 teacher's decode of 128 chunks a
    step, 32 groups of k=16."""
    from rule_guided_music_tpu_torch import distill_scoring_features as mod

    def expected(res):
        t = norm_calls(res["teacher"].decoder)
        return {"flash_attention": 0, "flash_attention_fp32": 0,
                "groupnorm_swish": (len(res["step_ms"]) + 32) * t}

    launches, res = run_distill(torch, port, "distill_scoring_features", mod, [
        "--out", os.path.join(tmp, "features_ch{ch}.npz")], expected)
    gen = torch.Generator(device="cuda").manual_seed(42)
    z = torch.randn((4, 4, 128, 16), generator=gen, device="cuda")
    loaded_agrees(torch, port["pipeline"], "distill_scoring_features", res,
                  "features", lambda m: list(m(z).values()))
    return launches, res


def distill_rollout_path(torch, port, tmp):
    """``distill_scoring_rollout`` at its widths and batch (the perturbed
    random XL_8 teacher, the B_8 student, batch 16, k=16, the ch=128 gate
    VAE), cut to DISTILL_ROLLOUT_ARGS."""
    from rule_guided_music_tpu_torch import distill_scoring_rollout as mod
    from rule_guided_music_tpu_torch.models.vae import AutoencoderKL

    with torch.device("meta"):
        gate_decoder = norm_calls(AutoencoderKL(ch=128).decoder)

    def expected(res):
        steps, groups = len(res["step_ms"]), DISTILL_ROLLOUT_GROUPS
        t, s = len(res["teacher"].blocks), len(res["student"].blocks)
        return {"flash_attention": (steps + groups) * (t + s),
                "flash_attention_fp32": 0, "flash_attention_bwd": steps * s,
                "groupnorm_swish": groups * 2 * gate_decoder}

    launches, res = run_distill(torch, port, "distill_scoring_rollout", mod, [
        *DISTILL_ROLLOUT_ARGS, "--out", os.path.join(tmp, "{student}.npz")], expected)
    print(f"distill_scoring_rollout: {res['valid_groups']} of {DISTILL_ROLLOUT_GROUPS} "
          f"gate groups not tied")
    gen = torch.Generator(device="cuda").manual_seed(43)
    x = torch.randn((4, 4, 128, 16), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (4,), generator=gen, device="cuda").float()
    y = torch.randint(0, 3, (4,), generator=gen, device="cuda")
    loaded_agrees(torch, port["pipeline"], "distill_scoring_rollout", res, "rollout",
                  lambda m: [m(x, t, y)])
    return launches, res


def distill_step_card_vs_cpu(torch, port):
    """One fp32 step of distill_scoring_decoder's update (a ch=32 teacher, a
    ch=16 student, batch 2, Flax-initialised from the CLI's seeds), card
    against CPU from the same weights and latents, TF32 off: the loss, the
    gradients and the updated parameters (``update_agrees``)."""
    from rule_guided_music_tpu_torch import distill_scoring_decoder as mod
    from rule_guided_music_tpu_torch.models.vae import AutoencoderKL, ScoringDecoder
    from rule_guided_music_tpu_torch.training.distill import flax_init_

    lr = 2e-3
    z = torch.randn((2, 4, 16, 16), generator=torch.Generator().manual_seed(47))
    out = {}
    with no_tf32(torch):
        for device in ("cpu", "cuda"):
            teacher = flax_init_(AutoencoderKL(ch=32), 1).to(device).eval()
            student = flax_init_(ScoringDecoder(ch=16), 3).to(device)
            with torch.no_grad():
                target = teacher.decode(z.to(device))
            step = mod.make_step(student, torch.optim.Adam(student.parameters(), lr=lr),
                                 bf16=False)
            loss = step(z.to(device), target).float().cpu()
            named = dict(student.named_parameters())
            out[device] = (loss, {n: p.detach().float().cpu() for n, p in named.items()},
                           {n: p.grad.detach().float().cpu() for n, p in named.items()})
    cpu, card = out["cpu"], out["cuda"]
    return update_agrees(torch, "decoder distill step (ch=16 student, fp32)", cpu[1],
                         card[1], {n: (g, card[2][n]) for n, g in cpu[2].items()}, lr,
                         extra=(("loss", card[0], cpu[0]),))


def write_midi_set(root, n=DATA_MIDIS, seconds=DATA_SECONDS, seed=61):
    """``n`` seeded piano MIDI files of ``seconds`` (notes and sustain pedal),
    written by the port's ``data/midi_io``."""
    import numpy as np

    from rule_guided_music_tpu_torch.data.midi_io import (ControlChange, MidiData,
                                                          Note, write_midi)

    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        notes, t = [], 0.0
        while t < seconds:
            for _ in range(int(rng.integers(1, 4))):
                notes.append(Note(velocity=int(rng.integers(30, 110)),
                                  pitch=int(rng.integers(36, 96)), start=t,
                                  end=t + float(rng.uniform(0.1, 1.2))))
            t += float(rng.uniform(0.1, 0.6))
        ccs = [ControlChange(64, 127 if j % 2 == 0 else 0, float(c))
               for j, c in enumerate(np.arange(0.0, seconds, 2.5))]
        write_midi(os.path.join(root, f"piece{i}.mid"),
                   MidiData(notes=notes, control_changes=ccs))
    return root


def data_chain_path(torch, port, tmp):
    """MIDI -> ``prepare_data chunks`` -> ``rearrange`` -> ``compute_std``
    at its defaults (16 batches of 16 rolls of 1024 columns) on the train
    manifest, through the production encoder (Flax-initialised, bf16): 21
    GroupNorm+swish launches a batch, a finite scale_factor."""
    import math

    from rule_guided_music_tpu_torch import compute_std, prepare_data

    fa, gn = port["fa"], port["gn"]
    midi = write_midi_set(os.path.join(tmp, "midi"))
    t0 = time.perf_counter()
    chunks = prepare_data.main(["chunks", "--midi_dir", midi, "--chunk_dir",
                                os.path.join(tmp, "chunks")])
    prefix = os.path.join(tmp, "data")
    prepare_data.main(["rearrange", "--chunk_dir", os.path.join(tmp, "chunks"),
                       "--out_dir", os.path.join(tmp, "sequences"), "--csv_prefix",
                       prefix, *DATA_PREP_ARGS])
    host = time.perf_counter() - t0
    with open(f"{prefix}_train.csv") as f:
        n_train = sum(1 for _ in f) - 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    std, scale = compute_std.main(["--data_dir", f"{prefix}_train.csv"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": 0,
                              "groupnorm_swish": 21 * 16})
    print(f"data chain: {len(chunks)} chunks of {DATA_MIDIS} MIDI files, "
          f"{n_train} train sequences, prepare_data {host:.2f} s; compute_std "
          f"{wall:.2f} s (16 batches of 16 rolls), peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB: latent std "
          f"{std:.4f}, scale_factor {scale:.4f}")
    if not math.isfinite(scale) or n_train < 16:
        raise AssertionError(f"data chain: scale_factor {scale}, {n_train} sequences")
    return launches, dict(std=std, scale_factor=scale, chunks=len(chunks),
                          train_sequences=n_train, compute_std_s=wall,
                          prepare_data_s=host)


def chord_study_path(torch, port):
    """``chord_divergence_study`` on the card and on the CPU: every tag
    array equal off exact ties (``chord_tags_agree``), every key index
    equal, and no kernel launched."""
    import numpy as np

    from rule_guided_music_tpu_torch import chord_divergence_study as study

    fa, gn = port["fa"], port["gn"]
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    card = study.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fa, gn)
    check_launches(launches, {"flash_attention": 0, "flash_attention_fp32": 0,
                              "groupnorm_swish": 0})
    cpu = study.study(torch.device("cpu"))
    ties = 0
    for name, tags in card["tags"].items():
        if name.startswith("keys_"):
            if not np.array_equal(tags, cpu["tags"][name]):
                raise AssertionError(f"chord study: {name} differs on the card")
            continue
        ties += chord_tags_agree(torch, torch.as_tensor(card["rolls"][name]), tags,
                                 cpu["tags"][name])
    print(f"chord_divergence_study: {wall:.2f} s on the card; {len(card['tags'])} "
          f"tag arrays equal to the CPU's, {ties} windows differing at an exact tie")
    return launches, dict(seconds=wall, tie_windows=ties)


def gate_study_path(torch, port, tmp):
    """``allrules_gate_study --variants plain,feat_pre4_light --skip_regret``
    on the fixtures (fp32, TF32 off) on the card, seeds 0-3, its JSON
    written to ``tmp``: the committed record's keys, the launches equal to
    the module calls, and seed 0 of each row equal to the CPU run's within
    GATE_AGREE_TOL under the same noise (``replay_noise``)."""
    from rule_guided_music_tpu_torch import allrules_gate_study as study

    fa, gn = port["fa"], port["gn"]
    noise = {seed: replay_noise(torch, 500 + seed) for seed in study.SEEDS}
    argv = ["--variants", ",".join(GATE_VARIANTS), "--skip_regret"]
    study.OUT_PATH = os.path.join(tmp, "allrules_gate_study.json")
    with no_tf32(torch):
        reset_counts(fa, gn)
        t0 = time.perf_counter()
        with module_calls(torch) as calls:
            card = study.main([*argv, "--device", "cuda"],
                              noise_fn_for=lambda seed: noise[seed]("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(fa, gn)
        check_launches(launches, {"flash_attention": 0,
                                  "flash_attention_fp32": calls["attention"],
                                  "groupnorm_swish": calls["groupnorm_swish"]})
        cpu = study.main([*argv, "--device", "cpu"], seeds=(0,),
                         noise_fn_for=lambda seed: noise[seed]("cpu"))
    with open(os.path.join(REPO, "docs", "allrules_gate_study.json")) as f:
        record = json.load(f)
    if set(card) != set(record):
        raise AssertionError(f"gate study keys {sorted(card)} vs {sorted(record)}")
    worst = 0.0
    for row in GATE_VARIANTS:
        a = card["per_seed"][row]["0"]["weighted"]
        b = cpu["per_seed"][row]["0"]["weighted"]
        worst = max(worst, abs(a - b) / abs(b))
        print(f"allrules_gate_study {row}: weighted {card['final_losses'][row]['weighted']:.4f} "
              f"over seeds 0-3 on the card; seed 0 card {a:.6f}, CPU {b:.6f}")
    print(f"allrules_gate_study: {wall:.2f} s on the card; seed 0 card vs CPU: "
          f"largest relative difference {worst:.2e} (tol {GATE_AGREE_TOL:.0e})")
    if worst > GATE_AGREE_TOL:
        raise AssertionError("gate study: the card's rows differ from the CPU's")
    return launches, dict(seconds=wall, card_vs_cpu=worst,
                          weighted={row: card["final_losses"][row]["weighted"]
                                    for row in GATE_VARIANTS})


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
    from rule_guided_music_tpu_torch.ops import quant

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
        # libraries, kernel 2's and the int8 GEMMs'
        jobs = [(name, fa, name) for name in fa.LIBRARIES] + [
            ("groupnorm_swish", gn, None), ("quant_gemm", quant, None)]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = [pool.submit(mod._load, *([arg] if arg else []))
                       for _, mod, arg in jobs]
            for job in futures:
                job.result()
        results = {**fa.build_results, "groupnorm_swish": gn.build_result,
                   "quant_gemm": quant.build_result}
        for label, _, _ in jobs:
            print(f"nvcc {label}.cu: {results[label].seconds:.2f} s")
            entry = ""
            for line in results[label].log.splitlines():
                # the kernel and its template arguments, as mangled
                found = re.search(r"(?<=\d)((?:flash|gn|w8a\d+|quantize)_\w+?_kernel)"
                                  r"(?:I(\w+?)EEv|E)", line)
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
        # w8a16's bf16 wgmma (its fp32 route's too) is HGMMA, w8a8's s8
        # wgmma IGMMA
        tensor_ops = {op: count_sass(results["quant_gemm"].path, f" {op}.")
                      for op in ("HGMMA", "IGMMA")}
        print("cuobjdump -sass quant_gemm: " + ", ".join(
            f"{n} {op}" for op, n in tensor_ops.items()) + " (tensor-core) instructions")
        if not all(tensor_ops.values()):
            raise AssertionError(f"quant_gemm: tensor-core instructions {tensor_ops}")

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
        with phase("int8 kernel checks: the quantization, w8a8 and w8a16 (bf16 and "
                   "fp32) against their plain versions at XL_8's linears at 512 and "
                   "8192 tokens, 1 and 16 rows, XS_8's 64 -> 192, ragged shapes, "
                   "every GEMM route forced"):
            quant_worst = check_quant_kernels(torch, quant)
        with phase("int8 models: DiTRotary_XL_8 in fp32, a copy per mode "
                   "quantized, + KL-VAE"):
            models = build_main_models(torch, pipeline, QUANT_MODES)
            qdits = models.pop("qdits")
        with phase("int8: the scg.yml chain (DiTRotary_XL_8 + KL-VAE, k=16, "
                   "B=2, 10 steps) with the fp, w8a16 and w8a8 trunks"):
            q_launches, _, quant_trunk = quant_path(torch, port, models, qdits)
        slice7_launches.update({f"int8_{k}": v for k, v in q_launches.items()
                                if k != "fp"})
        del models, qdits
        torch.cuda.empty_cache()
        for mode in QUANT_MODES:
            with phase(f"sample_rule.main --quant {mode} on scg.yml: "
                       f"DiTRotary_XL_8 + KL-VAE, k=16, 10 steps, B=2"):
                slice7_launches[f"sample_rule_scg_{mode}"] = quant_cli_path(
                    torch, port, mode, tmp)
        with phase("sample_rule.main --quant w8a16 --dtype float32 on scg.yml: "
                   "DiTRotary_XL_8 + KL-VAE, k=16, 10 steps, B=2"):
            slice7_launches["sample_rule_scg_w8a16_float32"] = quant_cli_path(
                torch, port, "w8a16", tmp, "float32")
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

    # classifier and pixel training, and Adafactor, after the latent trainers
    with phase("classifier and pixel training kernel checks: attention at "
               f"{', '.join(map(str, SLICE13_ATTN_SHAPES))} forward and backward, "
               f"timed at {CLS_PIXEL_ATTN_SHAPE}; GroupNorm+swish's backward with "
               f"dw/dbias on one UNet forward at batch {PIXEL_UNET_BATCH}"):
        slice13_attn, slice13_grad_err, slice13_gn = check_slice13_kernels(
            torch, fa, gn, F)
    slice13_launches = {}
    slice13_rows = {}
    with kept_dir(root, "classifier_pixel_training") as tmp:
        latent_rolls = write_roll_manifest(os.path.join(tmp, "cls_rolls"),
                                           SLICE13_ROLLS, 1100, seed=71)
        pixel_rolls = write_roll_manifest(os.path.join(tmp, "pixel_rolls"),
                                          SLICE13_ROLLS, 160, seed=72)
        for rule in ("note_density", "chord_progression"):
            with phase(f"classifier_train_aug.main --rule {rule}: batch 32, the "
                       f"production VAE encoder, bf16, {SLICE13_STEPS} steps"):
                slice13_launches[f"classifier_train_aug_{rule}"], \
                    slice13_rows[f"classifier_train_aug_{rule}"] = \
                    classifier_train_path(torch, port, tmp, rule, latent_rolls)
        for name, what in (("unet", "the UNet (ch 128)"), ("dit", "DiT-B/8")):
            with phase(f"pixel.train_{name}_pixel.main: {what} on (3, 128, 128), "
                       f"batch 16, bf16, {SLICE13_STEPS} steps"):
                slice13_launches[f"train_{name}_pixel"], \
                    slice13_rows[f"train_{name}_pixel"] = pixel_trainer_path(
                        torch, port, tmp, name, pixel_rolls)
        with phase("pixel.train_classifier_pixel.main: DiT-S/2-cls (N = 4097), "
                   f"batch 32, bf16, {SLICE13_STEPS} steps"):
            slice13_launches["train_classifier_pixel"], \
                slice13_rows["train_classifier_pixel"] = classifier_pixel_path(
                    torch, port, tmp, pixel_rolls)
        with phase("train_dit.main --optimizer adafactor: DiTRotary_XL_8, batch 32, "
                   f"bf16, {ADAFACTOR_STEPS} steps"):
            slice13_launches["train_dit_adafactor"], \
                slice13_rows["train_dit_adafactor"] = train_dit_adafactor_path(
                    torch, port, tmp, write_train_manifest(os.path.join(tmp, "rolls")))
        with phase("classifier and pixel training agreement: EncoderUNetModel and "
                   "an Adafactor step, card vs CPU"):
            encoder_unet_card_vs_cpu(torch, port)
            adafactor_card_vs_cpu(torch, port)

    # each kernel's launches are those of the path that takes it, counted
    # from 0 just before it: the bf16 kernels' the flagship path's (and each
    # path's too), kernel 2's backward DPS-rule's, the fp32 attention
    # kernels' those of the fp32 card-vs-CPU runs
    slice14_launches, slice14 = {}, {}
    with kept_dir(root, "parallel") as tmp:
        with phase("parallel: a process group of one rank (NCCL, a file store in "
                   "the run's temp directory)"):
            init_world(torch, tmp)
        with phase(f"train_dit.main plain and --dp 1 --fsdp 1 --tp 1: XL_8, batch "
                   f"32, bf16, AdamW, {MESH_STEPS} steps each"):
            slice14_launches["train_dit_mesh"], slice14["train_dit_mesh"] = \
                mesh_train_path(torch, port, tmp,
                                write_train_manifest(os.path.join(tmp, "rolls")))
        with phase(f"pipelined_dit_rotary_apply: XL_8, batch 32, bf16, 1 stage, "
                   f"gpipe (n_micro {PIPE_MICRO}) and circular"):
            slice14_launches["pipeline_gpipe"], slice14_launches["pipeline_circular"], \
                slice14["pipeline"] = pipeline_path(torch, port)
        with phase("sample_rule.main --mesh 1 on scg.yml against the plain run: "
                   "XL_8 + KL-VAE, k=16, B=2, 10 steps"):
            slice14_launches["sample_rule_mesh"], slice14["sample_rule_mesh"] = \
                sample_mesh_path(torch, port, tmp)
        torch.cuda.empty_cache()
        with phase("train_probe: get_kl_input, then XL_8 at 32 latents, bf16, "
                   "adafactor/adamw with and without remat"):
            slice14["train_probe"] = train_probe_path(torch)
        torch.cuda.empty_cache()
        with phase("train_soak: DiTRotary_XS_8 + the fixture's VAE, fp32, 40 steps "
                   "killed past 25, resumed"):
            slice14["train_soak"] = train_soak_path(torch, tmp)
        # before its store's directory goes: NCCL's watchdog reads the store
        torch.distributed.destroy_process_group()
    print(json.dumps({"parallel": slice14}, default=str))

    # the distillation and study scripts, after every earlier path
    with phase("distillation kernel checks: GroupNorm+swish's backward with dw/dbias "
               f"on the ch=64 student's calls at {DISTILL_DECODER_CHUNKS} chunks, its "
               f"forward on the ch=128 teacher's decode and the production encoder "
               f"at {DISTILL_TEACHER_CHUNKS} chunks; attention at "
               f"{DISTILL_TEACHER_ATTN} and with a gradient at {DISTILL_STUDENT_ATTN}"):
        distill_rows = check_distill_kernels(torch, fa, gn, F)
    slice15_launches, slice15 = {}, {}
    with kept_dir(root, "distill") as tmp:
        with phase("distill_scoring_decoder: ch=128 teacher, ch=64 student, batch 32, "
                   "400 steps, 32 groups of k=16, bf16"):
            slice15_launches["distill_scoring_decoder"], slice15["decoder"] = \
                distill_decoder_path(torch, port, tmp)
        with phase("distill_scoring_features: ch=128 teacher, ch=64 head, batch 16, "
                   "latent_t 128, 600 steps, 32 groups of k=16, bf16"):
            slice15_launches["distill_scoring_features"], slice15["features"] = \
                distill_features_path(torch, port, tmp)
        with phase("distill_scoring_rollout: XL_8 teacher, B_8 student, batch 16, "
                   f"{' '.join(DISTILL_ROLLOUT_ARGS)}, k=16, gate VAE ch=128, bf16"):
            slice15_launches["distill_scoring_rollout"], slice15["rollout"] = \
                distill_rollout_path(torch, port, tmp)
        with phase("distillation agreement: a decoder-distill step card vs CPU"):
            slice15["step_card_vs_cpu"] = dict(
                max_err=distill_step_card_vs_cpu(torch, port))
        with phase("data chain: MIDI -> prepare_data chunks -> rearrange -> "
                   "compute_std (production encoder, 16 batches of 16 rolls)"):
            slice15_launches["data_chain"], slice15["data_chain"] = \
                data_chain_path(torch, port, tmp)
        with phase("chord_divergence_study: card vs CPU"):
            slice15_launches["chord_divergence_study"], slice15["chord_study"] = \
                chord_study_path(torch, port)
        with phase(f"allrules_gate_study --variants {','.join(GATE_VARIANTS)} "
                   "--skip_regret: fixtures, fp32, seeds 0-3, card vs CPU"):
            slice15_launches["allrules_gate_study"], slice15["gate_study"] = \
                gate_study_path(torch, port, tmp)
    print(json.dumps({"distill": {k: {f: v for f, v in row.items()
                                      if f not in ("student", "teacher")}
                                  for k, row in slice15.items()}}, default=str))

    # the int8 kernels: the trunk's 112 linears of one XL_8 forward at 8192
    # tokens (the k*B=32 rollout call), and at 512 (the B=2 call)
    quant_src = dict(route="cuda", source="rule_guided_music_tpu_torch/csrc/quant_gemm.cu",
                     replaces="rule_guided_music_tpu/ops/quant.py:82-124",
                     replaces_kind="XLA's int8 dot_general and its fused "
                                   "dequantization, not a Pallas kernel")
    quant_err = {"w8a16_gemm": quant_worst["w8a16_beyond"],
                 "w8a16_gemm_fp32": quant_worst["w8a16_fp32"],
                 "quantize_rows": quant_worst["quantize_rows"],
                 "w8a8_gemm": quant_worst["w8a8_gemm"]}
    # the CUDA kernels behind each wrapper (the GEMMs fed by TMA from a
    # producer warp, split across a cluster where the tiles are few)
    quant_cuda = {"w8a16_gemm": "w8a16_tma_kernel",
                  "w8a16_gemm_fp32": "w8a16_fp32_tma_kernel",
                  "quantize_rows": "quantize_rows_kernel",
                  "w8a8_gemm": "w8a8_tma_kernel"}
    quant_err_is = {
        "w8a16_gemm": "outputs more than one bf16 ulp off the plain version (0)",
        "w8a16_gemm_fp32": "fp32, over the largest output"}
    for name in ("w8a16_gemm", "w8a16_gemm_fp32", "quantize_rows", "w8a8_gemm"):
        row = quant_trunk[8192][name]
        kernels.append(dict(
            name=name, cuda_kernel=quant_cuda[name], **quant_src,
            max_abs_err=quant_err[name],
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms",
                                         "library_device_ms", "at_shapes")},
            shape=("XL_8 trunk, 112 linears of one forward at 8192 tokens, "
                   + ("fp32" if name.endswith("fp32") else "bf16")),
            at_512_tokens=quant_trunk[512][name],
            max_abs_err_is=quant_err_is.get(
                name, "elements off the plain version (bit-equal: 0)"),
            **({"bf16_share_differing": quant_worst["w8a16_share"]}
               if name == "w8a16_gemm" else {}),
            **({"w8a8_linear_host_ms": quant_trunk["w8a8_host_ms"]}
               if name == "w8a8_gemm" else {})))
    main_run = {
        "w8a16_gemm": (slice7_launches["sample_rule_scg_w8a16"],
                       "sample_rule.main --quant w8a16 on scg.yml, bf16"),
        "w8a16_gemm_fp32": (slice7_launches["sample_rule_scg_w8a16_float32"],
                            "sample_rule.main --quant w8a16 --dtype float32 on scg.yml"),
        "w8a8_gemm": (slice7_launches["sample_rule_scg_w8a8"],
                      "sample_rule.main --quant w8a8 on scg.yml, bf16"),
        "quantize_rows": (slice7_launches["sample_rule_scg_w8a8"],
                          "sample_rule.main --quant w8a8 on scg.yml, bf16"),
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
            k["at_classifier_pixel_training"] = slice13_attn
            k["at_distill_teacher"] = distill_rows["teacher_attention"]
        elif name == "flash_attention_bwd":
            k["at_edm_ring"] = long_kernels["at_edm_ring"]
            k["at_training"] = train_attn
            k["at_classifier_pixel_training"] = {
                key: {f: v for f, v in row.items() if "bwd" in f or f == "shape"}
                for key, row in slice13_attn.items()}
            k["max_abs_err_classifier_pixel_training"] = slice13_grad_err
            k["at_distill_student"] = dict(
                distill_rows["student_attention"],
                max_abs_err=distill_rows["student_attention_grad_err"])
        elif name == "groupnorm_swish_bwd":
            k["at_training"] = train_gn
            k["at_unet_training"] = slice13_gn
            k["at_scoring_decoder_distill"] = distill_rows["student_bwd"]
        elif name == "groupnorm_swish":
            k["at_long_decode"] = long_kernels["at_long_decode"]
            k["at_unet_forward"] = pixel_kernels["at_unet_forward"]
            k["at_distill_teacher_decode"] = distill_rows["teacher_decode"]
            k["at_compute_std_encode"] = distill_rows["compute_std_encode"]
        run, k["launched_in"] = main_run.get(
            name, (cls_launches, "main path with classifier guidance, bf16"))
        k["launches"] = run[name]
        if not name.endswith("fp32"):
            k["launches_by_path"] = {"scg": scg_launches[name],
                                     "classifier_guidance": cls_launches[name],
                                     **{n: v[name] for launches in (
                                         serving_launches, slice5_launches,
                                         slice6_launches, slice7_launches,
                                         slice10_launches, slice13_launches,
                                         slice14_launches, slice15_launches)
                                        for n, v in launches.items()}}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launched_in"]
    print(json.dumps({"trainers": slice13_rows}))
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
