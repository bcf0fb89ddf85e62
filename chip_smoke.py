#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds both hand-written kernels from the sources in this checkout, checks
each against its plain PyTorch version at the main path's shapes, drives
the port's SCG generation at full width (DiTRotary_XL_8 + the production
KL-VAE decoder, bf16, seeded random weights, k=16, weights 40/1/1 as in
scripts/configs/cond_table/all/scg.yml, on a 10-step respaced DDPM chain,
B=2), asserts that the run launched each kernel as often as its shapes say,
writes and reads back one MIDI file, and checks the port's card path
against its CPU path on the committed tiny fixture.

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

ATTN_SHAPES = [(32, 256, 16, 72), (2, 256, 16, 72), (2, 257, 6, 64)]
# decoder GroupNorm+swish geometries (C, H=W) and their calls per decode
GN_GEOMETRIES = [(512, 16, 9), (512, 32, 1), (256, 32, 5), (256, 64, 6),
                 (256, 128, 1), (128, 128, 7)]
GN_CHUNKS = 32
# stated tolerances (max abs error against the plain version run in fp32 on
# the same values): fp32 allows summation-order differences; bf16 allows
# the final rounding of outputs below 8 to bf16 (half an ulp is <= 2^-7)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

SCG_WEIGHTS = (("pitch_hist", 40.0), ("note_density", 1.0),
               ("chord_progression", 1.0))


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


def bound_ms(nbytes, ops, dtype_name):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name])


def check_attention(torch, fa, F):
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = fa.flash_attention(q, k, v)
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ok = err <= TOL[dname]
            print(f"attention {shape} {dname}: max_abs_err {err:.3e} "
                  f"(tol {TOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {shape} {dname}: {err}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    b, n, h, d = ATTN_SHAPES[0]
    q, k, v = (torch.randn(ATTN_SHAPES[0], generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v))
    plain = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    nbytes = 4 * b * n * h * d * 2
    ops = 4 * b * h * n * n * d
    bnd = bound_ms(nbytes, ops, "bfloat16")
    print(f"attention {ATTN_SHAPES[0]} bf16: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bnd:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["bfloat16"] else "operations",
                library_ms=lib, shape=f"{ATTN_SHAPES[0]} bf16, one launch")


def check_groupnorm(torch, gn):
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = {}
    for c, hw, _ in GN_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = (torch.randn((GN_CHUNKS, c, hw, hw), generator=gen, device="cuda")
                 * 2.0 + 0.5).to(dtype)
            w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            out = gn.groupnorm_swish(x, w, b, 32)
            ref = gn.groupnorm_swish_reference(x.float(), w.float(), b.float(), 32)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ok = err <= TOL[dname]
            print(f"groupnorm_swish ({GN_CHUNKS},{c},{hw},{hw}) {dname}: "
                  f"max_abs_err {err:.3e} (tol {TOL[dname]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"groupnorm_swish {c}x{hw}^2 {dname}: {err}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                inputs[(c, hw)] = (x, w, b)

    def run(fn):
        def all_calls():
            for c, hw, count in GN_GEOMETRIES:
                x, w, b = inputs[(c, hw)]
                for _ in range(count):
                    fn(x, w, b, 32)
        return all_calls

    ms = cuda_time_ms(run(gn.groupnorm_swish), reps=5, warmup=1)
    plain = cuda_time_ms(run(gn.groupnorm_swish_reference), reps=5, warmup=1)
    lib = cuda_time_ms(run(lambda x, w, b, g: torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, g, w, b, 1e-6))), reps=5, warmup=1)
    elems = sum(GN_CHUNKS * c * hw * hw * count for c, hw, count in GN_GEOMETRIES)
    nbytes = 2 * elems * 2
    ops = 10 * elems
    bnd = bound_ms(nbytes, ops, "float32")
    print(f"groupnorm_swish, one decode of {GN_CHUNKS} chunks (29 calls) bf16: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, F.group_norm+F.silu "
          f"{lib:.4f} ms, bound {bnd:.4f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S["float32"] else "operations",
                library_ms=lib,
                shape=f"one decode of {GN_CHUNKS} chunks (29 calls), bf16")


def main_path(torch, port):
    pipeline, fa, gn = port["pipeline"], port["fa"], port["gn"]
    from rule_guided_music_tpu_torch.config import (GuidanceConfig, SCGConfig,
                                                    SamplerConfig)
    from rule_guided_music_tpu_torch.data.midi_io import read_midi
    from rule_guided_music_tpu_torch.data.pianoroll import (
        finalize_decoded_sample, roll_to_midi, save_piano_roll_midi)
    from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT, LOSS_DICT
    from rule_guided_music_tpu_torch.diffusion.sampling import guide_schedule_mask
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish
    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

    batch = 2
    dit = pipeline.create_denoiser("DiTRotary_XL_8", dtype=torch.float32)
    pipeline.randomize_(dit, seed=0)
    dit = dit.to(torch.bfloat16)
    vae = pipeline.create_vae(dtype=torch.float32)
    pipeline.randomize_(vae, seed=1)
    vae = vae.to(torch.bfloat16)
    tables = make_schedule("linear", 1000, timestep_respacing="10").tables("cuda")
    config = SamplerConfig(
        sampler="ddpm",
        guidance=GuidanceConfig(schedule=True, t_start=750, t_end=0, interval=1),
        scg=SCGConfig(num_samples=16, weights=SCG_WEIGHTS),
        record=True)
    rolls = torch.as_tensor(make_rolls(batch, seed=7), device="cuda")
    rules = pipeline.extract_targets_from_rolls([n for n, _ in SCG_WEIGHTS], rolls)
    y = torch.full((batch,), 1, dtype=torch.long, device="cuda")
    shape = (batch, 4, 128, 16)
    t0 = time.perf_counter()
    pipeline.generate(dit, vae, tables, config, shape, rules, y=y,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    print(f"warm-up chain (first launches, cuDNN plans): "
          f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0
    gn.launches = 0
    t0 = time.perf_counter()
    latents, records = pipeline.generate(dit, vae, tables, config, shape, rules,
                                         y=y, generator=gen)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    rolls_out = pipeline.decode_rolls(vae, latents)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches, "groupnorm_swish": gn.launches}

    steps = tables.num_timesteps
    # the SCG search runs where the schedule says, except at t == t_end
    g = config.guidance
    n_guided = sum(guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
                   and t > config.t_end for t in range(steps))
    norm_calls = sum(isinstance(m, FusedNormSwish) for m in vae.modules())
    # one trajectory DiT call per step, one rollout per guided step; one
    # decode per guided step and the final decode
    expected = {"flash_attention": len(dit.blocks) * (steps + n_guided),
                "groupnorm_swish": norm_calls * (n_guided + 1)}
    print(f"steps {steps}, guided {n_guided}, chain {chain_s:.3f} s, "
          f"{1e3 * chain_s / max(n_guided, 1):.1f} ms per guided step "
          f"(chain wall time / guided steps)")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    for name in launches:
        print(f"launches {name}: {launches[name]} (expected {expected[name]})")
        if launches[name] != expected[name] or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {expected[name]}")
    for k, v in records.items():
        if k.startswith("loss/"):
            print(f"{k} per step (best candidate): "
                  + " ".join(f"{x:.4g}" for x in v.float().cpu().tolist()))

    if tuple(latents.shape) != (batch, 4, 128, 16) or not torch.isfinite(latents).all():
        raise AssertionError("latents: wrong shape or not finite")
    if tuple(rolls_out.shape) != (batch, 3, 128, 1024) or not torch.isfinite(rolls_out).all():
        raise AssertionError("decoded rolls: wrong shape or not finite")
    with tempfile.TemporaryDirectory() as tmp:
        # the generated excerpt, and a target excerpt, which has notes for
        # certain (random weights give rolls the export may read as empty)
        for label, roll in (("generated", rolls_out[:1].cpu().numpy()),
                            ("target", rolls[:1].cpu().numpy())):
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
    return launches


def small_input_agreement(torch, port):
    """The card path (kernels) against the CPU path (plain versions) on the
    committed tiny fixture, with the same noise, in fp32 without TF32."""
    pipeline = port["pipeline"]
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
            lat, rec = pipeline.generate(dit, vae, tables, config, shape, rules,
                                         noise_fn=noise_fn_for(device),
                                         num_classes=0, scale_factor=1.0)
            out[device] = (lat.cpu(), rec["candidate_log_prob"].argmax(1).cpu())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    same = torch.equal(out["cpu"][1], out["cuda"][1])
    print(f"tiny fixture, 6 steps, k=4: selected indices equal {same}; "
          f"final latents max_abs_err {err:.3e} (tol 1e-3)")
    if not same or err > 1e-3:
        raise AssertionError("card path disagrees with the CPU path")


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
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as pool:
            nvcc = pool.submit(fa._load)
            x = torch.randn((2, 64, 8, 8), device="cuda")
            gn.groupnorm_swish(x, torch.ones(64, device="cuda"),
                               torch.zeros(64, device="cuda"), 32)
            torch.cuda.synchronize()
            triton_s = time.perf_counter() - t0
            nvcc.result()
        print(f"nvcc flash_attention.cu: {fa.build_result.seconds:.2f} s")
        for line in fa.build_result.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        print(f"triton groupnorm_swish first compile+launch: {triton_s:.2f} s")

    with phase("kernel checks"):
        kernels = [
            dict(name="flash_attention", route="cuda",
                 source="rule_guided_music_tpu_torch/csrc/flash_attention.cu",
                 replaces="rule_guided_music_tpu/ops/pallas_attention.py:90",
                 **check_attention(torch, fa, F)),
            dict(name="groupnorm_swish", route="triton",
                 source="rule_guided_music_tpu_torch/ops/groupnorm_swish.py",
                 replaces="rule_guided_music_tpu/ops/pallas_groupnorm.py:117",
                 **check_groupnorm(torch, gn)),
        ]

    with phase("main path: DiTRotary_XL_8 + KL-VAE SCG, 10 steps, k=16, B=2"):
        launches = main_path(torch, port)

    with phase("small-input agreement: card vs CPU"):
        small_input_agreement(torch, port)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape"]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
