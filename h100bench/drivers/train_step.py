"""Window driver: train_dit's steps back to back.

Set-up builds the loop that ``train_dit``'s own construction builds
(DiTRotary with label dropout, the frozen KL-VAE encoder for
``get_kl_input``, AdamW, EMA, bf16 autocast over fp32 masters, the
prefetching loader over seeded synthetic rolls written to ``TMPDIR``),
with the benchmark's weights, and drives it through its first steps with
``TrainLoop.run_step`` on ``next(loop.data)``: those steps are the
warm-up, and the reference follows them after the window from the same
weights. The window is ``run_loop``'s body without its save and eval
intervals; the rate is all latents trained over all the window's time.
The window's first step is judged too: the loop's state (parameters,
AdamW's moments and step, EMA) is copied to the host before the window,
and after that step, with the clock stopped for the copy; the reference
takes the same step from the state before it. A traced run times
the judged step, then ``untraced_steps`` steps untraced, then traces
``trace_steps`` steps.
"""

from __future__ import annotations

import csv
import gc
import os
import resource
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from harness import build as prebuild, common, dev, trace, weights
from harness.data import make_rolls, to_uint8
from reference import models as RM
from reference import train_check
from work import dit as W_dit
from work import kl_vae as W_vae


def write_data(cell, seed: int) -> str:
    """Seeded uint8 rolls and their manifest under TMPDIR; returns the
    manifest's path."""
    tr = cell.traffic
    root = Path(tempfile.gettempdir()) / "h100bench_train"
    root.mkdir(parents=True, exist_ok=True)
    r = common.rng(seed, 2)
    rolls = to_uint8(make_rolls(tr["rolls"], tr["roll_columns"], r))
    labels = r.integers(0, cell.config["denoiser"]["num_classes"], size=tr["rolls"])
    manifest = root / "train.csv"
    with open(manifest, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["midi_filename", "classes"])
        for i, (roll, y) in enumerate(zip(rolls, labels)):
            path = root / f"roll{i:04d}.npy"
            np.save(path, roll)
            w.writerow([str(path), int(y)])
    return str(manifest)


def seeds_of(seed: int) -> dict:
    return {"dit": common.sub_seed(seed, 1, 0), "vae": common.sub_seed(seed, 1, 1),
            "loop": common.sub_seed(seed, 6) % 2 ** 32, "data": common.sub_seed(seed, 7) % 2 ** 32}


class Session:
    """train_dit's loop for one cell and seed."""

    def __init__(self, cell, seed: int, device, trace_on=False):
        from rule_guided_music_tpu_torch import pipeline
        from rule_guided_music_tpu_torch.data.datasets import load_data
        from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
        from rule_guided_music_tpu_torch.models.dit import DiT_models
        from rule_guided_music_tpu_torch.training.resample import create_named_schedule_sampler
        from rule_guided_music_tpu_torch.training.train_loop import TrainConfig, TrainLoop
        from rule_guided_music_tpu_torch.utils import logger

        cfg = cell.config
        prebuild.prebuild(cell.traffic.get("libraries", []), device)
        self.cell, self.device, self.seed = cell, device, seed
        self.seeds = seeds_of(seed)
        arch, v = cfg["denoiser"], cfg["vae"]
        with torch.device(device):
            model = DiT_models[arch["model"]](
                input_size=tuple(arch["input_size"]), in_channels=arch["in_channels"],
                num_classes=arch["num_classes"], learn_sigma=arch.get("learn_sigma", False),
                class_dropout_prob=arch["class_dropout_prob"], remat=False)
        weights.init_(model, self.seeds["dit"]).train()
        tables = make_schedule(cfg["noise_schedule"], cfg["diffusion_steps"]).tables(device)
        vae = pipeline.create_vae(arch={"ch": v["ch"], "ch_mult": v["ch_mult"],
                                        "num_res_blocks": v["num_res_blocks"]},
                                  encoder=True, dtype=getattr(torch, cfg["dtype"]), device=device)
        weights.init_(vae, self.seeds["vae"])
        rep = cfg["encode_rep"]
        data = load_data(data_dir=write_data(cell, seed), batch_size=cfg["batch_size"] // rep,
                         class_cond=cfg["class_cond"], image_size=cfg["pr_image_size"],
                         seed=self.seeds["data"])
        config = TrainConfig(lr=cfg["lr"], optimizer=cfg["optimizer"],
                             weight_decay=cfg["weight_decay"], ema_rate=cfg["ema_rate"],
                             encode_rep=rep, shift_size=cfg["shift_size"],
                             scale_factor=cfg["scale_factor"], log_interval=cfg["log_interval"])
        logger.configure(dir=str(Path(tempfile.gettempdir()) / "h100bench_train" / "log"),
                         format_strs=["log", "csv"])
        compute = None if cfg["dtype"] == "float32" else getattr(torch, cfg["dtype"])
        self.loop = TrainLoop(model=model, tables=tables, data=data, config=config,
                              vae_encode=vae.encode_moments,
                              schedule_sampler=create_named_schedule_sampler(
                                  "uniform", tables.num_timesteps),
                              seed=self.seeds["loop"], compute_dtype=compute)
        self.vae, self.logger = vae, logger
        self.rec = trace.Recorder()
        if trace_on:
            self._attach(model, vae, itemsize=torch.finfo(getattr(torch, cfg["dtype"])).bits // 8)
        self.steps = 0
        self.waits = []
        self.keep_next = None     # a step's record to fill, for the next step
        self.paused = 0.0         # seconds the clock stood still for the host copies

    def _attach(self, model, vae, itemsize):
        from rule_guided_music_tpu_torch.models.layers import Attention
        from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

        cfg = self.cell.config
        self.rec.attach([model], lambda m, a: "train_dit",
                        lambda m, a: W_dit.train_step(cfg["denoiser"], a[0].shape[0]))
        self.rec.attach([vae.encoder], lambda m, a: "encoder",
                        lambda m, a: W_vae.encoder(cfg["vae"], a[0].shape[0], itemsize))
        self.rec.attach([m for m in model.modules() if isinstance(m, Attention)],
                        lambda m, a: "attention")
        self.rec.attach([m for m in vae.modules() if isinstance(m, FusedNormSwish)],
                        lambda m, a: "groupnorm_swish")

    def _keep(self, got: dict):
        """Wrap the loop's noise draw, timestep sampler and encoder so that
        what the next steps receive lands in ``got``: the timesteps and
        weights, the noise and dropout mask, and the encoder's moments.
        Returns the function that unwraps them."""
        loop = self.loop
        draw, sample, encode = loop.draw, loop.schedule_sampler.sample, loop.vae_encode

        def draw_kept(latents, y):
            noise, drop = draw(latents, y)
            got["steps"][-1].update(noise=noise, drop=drop, y=y)
            return noise, drop

        def sample_kept(n_, rng):
            t, w = sample(n_, rng)
            got["steps"][-1].update(t=torch.as_tensor(t, dtype=torch.long),
                                    w=torch.as_tensor(w))
            return t, w

        def encode_kept(chunks):
            moments = encode(chunks)
            got["moments"].append(moments)
            return moments

        loop.draw, loop.schedule_sampler.sample, loop.vae_encode = (
            draw_kept, sample_kept, encode_kept)

        def undo():
            del loop.draw, loop.schedule_sampler.sample
            loop.vae_encode = encode
        return undo

    @staticmethod
    def record() -> dict:
        return {"steps": [], "loss": [], "moments": []}

    def checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, through the window's own call and feed,
        with what each step received kept for the reference, then the first
        gradient, the parameters' and the EMA's change, by leaf."""
        loop = self.loop
        width = self.cell.config["denoiser"]["hidden_size"]
        got = self.record()
        undo = self._keep(got)
        try:
            for i in range(n):
                batch, cond = next(loop.data)
                got["steps"].append({"rolls": torch.as_tensor(np.array(batch))})
                metrics = loop.run_step(batch, cond)
                got["loss"].append(float(metrics["loss"]))
                self.steps += 1
                if i == 0:
                    opt = loop.state.optimizer
                    b1 = opt.param_groups[0]["betas"][0]
                    # an optimizer that took no step holds no moment: a zero gradient
                    got["grad"] = train_check.norms(
                        {name: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - b1)
                         for name, p in loop.model.named_parameters()}, width)
        finally:
            undo()
        # the change of each parameter and of its EMA, kept on the host: the
        # reference's gradient, after the window, says which elements count
        params = dict(loop.model.named_parameters())
        got["update"], got["ema"] = {}, {}
        with torch.no_grad():
            for name, p0 in weights.values([(n_, p.shape) for n_, p in params.items()],
                                           self.seeds["dit"], self.device):
                got["update"][name] = (params[name] - p0).cpu()
                got["ema"][name] = (loop.state.ema_params[name] - p0).cpu()
        return got

    def snapshot(self, kinds=("params", "m", "v", "ema")) -> dict:
        """Host copies, in float32 and by name, of the loop's parameters,
        AdamW's moments and the EMA, with AdamW's step count and b1."""
        loop = self.loop
        opt = loop.state.optimizer
        named = dict(loop.model.named_parameters())
        state = lambda p, key: opt.state[p][key] if key in opt.state[p] else torch.zeros_like(p)
        get = {"params": lambda n, p: p, "m": lambda n, p: state(p, "exp_avg"),
               "v": lambda n, p: state(p, "exp_avg_sq"),
               "ema": lambda n, p: loop.state.ema_params[n]}
        first = next(iter(named.values()))
        out = {"step": int(opt.state[first].get("step", 0)),
               "b1": opt.param_groups[0]["betas"][0]}
        with torch.no_grad():
            for kind in kinds:
                out[kind] = {n: get[kind](n, p).detach().to("cpu", torch.float32, copy=True)
                             for n, p in named.items()}
        return out

    def one_step(self) -> int:
        """``run_loop``'s body without its save and eval intervals. Where
        ``keep_next`` holds a record, the step's inputs, loss and moments go
        into it, and the state after the step is copied to the host with
        the clock stopped (``paused``)."""
        loop, cfg = self.loop, self.loop.config
        kept, self.keep_next = self.keep_next, None
        if kept is not None:
            undo = self._keep(kept)
            kept["steps"].append({})
        with self.rec.span("data"):
            t0 = time.perf_counter()
            batch, cond = next(loop.data)
            self.waits.append(1e3 * (time.perf_counter() - t0))
        with self.rec.span("train_step"):
            metrics = loop.run_step(batch, cond)   # ends reading its metrics: the step is done
        if kept is not None:
            t0 = time.perf_counter()
            undo()
            kept["steps"][-1]["rolls"] = torch.as_tensor(np.array(batch))
            kept["loss"].append(float(metrics["loss"]))
            kept["after"] = self.snapshot(("params", "m", "ema"))
            self.paused += time.perf_counter() - t0
        self.steps += 1
        if self.steps % cfg.log_interval == 0:
            self.logger.logkv("step", self.steps)
            self.logger.dumpkvs()
        return self.cell.config["batch_size"]

    def free(self):
        self.rec.detach()
        self.loop = self.vae = None
        dev.empty_cache(self.device)

    def reference(self, got, fp8=False, half=False, start=None):
        """The reference's run over the kept steps, from the benchmark's
        weights or, given ``start``, from the program's state before them."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cell.config
        dit = weights.init_(RM.build("dit", cfg["denoiser"], self.device), self.seeds["dit"])
        vae = weights.init_(RM.build("vae", dict(cfg["vae"], encoder=True, decoder=True),
                                     self.device), self.seeds["vae"], getattr(torch, cfg["dtype"]))
        out = train_check.run(cfg, dit, vae, got["steps"], fp8=fp8, half=half, start=start)
        del dit, vae
        dev.empty_cache(self.device)
        return out


def program_view(got):
    return {k: got[k] for k in ("loss", "moments", "grad", "update", "ema")}


def window_view(start: dict, kept: dict, width: int) -> dict:
    """The judged window step as the reference reads it: its loss and
    moments, the gradient AdamW received (from its first moment before and
    after: m1 = b1 m0 + (1 - b1) g), and the parameters' and the EMA's
    change."""
    after, b1 = kept["after"], start["b1"]
    grad = {n: (m - b1 * start["m"][n]) / (1 - b1) for n, m in after["m"].items()}
    return {"loss": kept["loss"], "moments": kept["moments"],
            "grad": train_check.norms(grad, width),
            "update": {n: p - start["params"][n] for n, p in after["params"].items()},
            "ema": {n: e - start["ema"][n] for n, e in after["ema"].items()}}


def merged(*readings) -> dict:
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


class HostUse:
    """The process's host use over the window, for the log: CPU seconds of
    the main thread and of the process, context switches, page faults,
    the Python objects the collector tracks, and the load average."""

    def __init__(self):
        self.objects = len(gc.get_objects())
        self.t0, self.ru0 = time.thread_time(), resource.getrusage(resource.RUSAGE_SELF)
        self.p0 = time.process_time()

    def report(self, times) -> str:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        q = max(len(times) // 4, 1)
        quarters = [round(1e3 * statistics.median(times[i:i + q]), 1)
                    for i in range(0, q * 4, q) if times[i:i + q]]
        return (f"host: main thread cpu {time.thread_time() - self.t0:.2f} s, process cpu "
                f"{time.process_time() - self.p0:.2f} s, switches voluntary "
                f"{ru.ru_nvcsw - self.ru0.ru_nvcsw} involuntary {ru.ru_nivcsw - self.ru0.ru_nivcsw}, "
                f"minor faults {ru.ru_minflt - self.ru0.ru_minflt}, objects {self.objects} -> "
                f"{len(gc.get_objects())}, max rss {ru.ru_maxrss} kB, load {os.getloadavg()}, "
                f"step ms median by quarter {quarters}")


def run(ctx):
    cell, device = ctx.cell, ctx.device
    tr = cell.traffic
    s = Session(cell, ctx.seed, device, ctx.trace)
    got = s.checked_steps(tr["checked_steps"])
    dev.sync(device)
    setup_s = ctx.clock() - ctx.t_start
    # the state before the window's first step, which is judged: off the
    # clock, and counted in no metric
    start, s.keep_next = s.snapshot(), Session.record()
    kept = s.keep_next
    dev.reset_peak(device)
    s.waits.clear()
    clock = lambda: ctx.clock() - s.paused
    host = HostUse()
    if ctx.trace:
        # the judged step, then ``untraced_steps`` timed as the window times
        # them: their mean step is the traced steps' untraced wall time
        s.one_step()
        m = tr["untraced_steps"]
        _, untraced, _ = common.timed_loop(s.one_step, 0.0, clock, m)
        n = tr["trace_steps"]
        s.rec.on = True
        s.waits.clear()
        prof = trace.profile()
        prof.__enter__()
        t0 = clock()
        units = sum(s.one_step() for _ in range(n))
        elapsed = clock() - t0
        prof.__exit__(None, None, None)
        s.rec.on = False
    else:
        units, elapsed, times = common.timed_loop(s.one_step, ctx.seconds, clock)
        q = np.percentile(times, [10, 50, 90]) * 1e3
        ctx.log(f"step ms p10/p50/p90: {q[0]:.2f} / {q[1]:.2f} / {q[2]:.2f}, first "
                f"{[round(1e3 * x, 1) for x in times[:5]]}")
        ctx.log(host.report(times))
    device_rec = dev.record(device)
    peak_gib = device_rec["memory_peak_bytes"] / 2 ** 30
    result = {"attempted": units, "failed": 0, "device": device_rec}
    if ctx.trace:
        summary = trace.summarize(prof, elapsed)
        del prof
        ctx.log(f"trace: {summary.kernels} device operations, {summary.unmatched} without a "
                f"matched launch; device s by layer {summary.layer_device_s}; untraced "
                f"{untraced:.3f} s for {m} steps")
        result["metrics"] = ctx.read_metrics(summary=summary, calls=list(s.rec.calls),
                                             dtype=cell.config["dtype"], units=n,
                                             unit_s=untraced / m, data_wait_ms=list(s.waits))
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    else:
        result["metrics"] = {
            "train_latents_per_s": {"value": units / elapsed, "unit": "latents/s"},
            "peak_mem_gib": {"value": peak_gib, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    ctx.log(f"window {elapsed:.3f} s, {units} latents, set-up {setup_s:.3f} s, peak "
            f"{peak_gib:.3f} GiB, data wait ms median "
            f"{statistics.median(s.waits) if s.waits else float('nan'):.3f}, host copies "
            f"{s.paused:.3f} s off the clock")
    s.free()
    width = cell.config["denoiser"]["hidden_size"]
    first = train_check.readings(program_view(got), s.reference(got))
    window = train_check.readings(window_view(start, kept, width),
                                  s.reference(kept, start=start))
    ctx.log(f"readings: set-up steps {first}; window's first step {window}; losses "
            f"{got['loss']} {kept['loss']}")
    check = common.Check(cell.limits)
    for k, v in merged(first, window).items():
        check.add(k, v)
    return result, check


def calibrate(cell, device, seeds, log):
    """Per seed: the program's kept steps (the set-up steps and the first
    step after them) judged by the reference (the lower readings), and in
    the program's place the reference in float8 (the control) and the
    reference on half of each batch (a planted fault)."""
    out = []
    width = cell.config["denoiser"]["hidden_size"]
    for seed in seeds:
        s = Session(cell, seed, device)
        got = s.checked_steps(cell.traffic["checked_steps"])
        start, s.keep_next = s.snapshot(), Session.record()
        kept = s.keep_next
        s.one_step()
        win = window_view(start, kept, width)
        s.free()
        ref, ref_w = s.reference(got), s.reference(kept, start=start)
        judged = lambda **kw: merged(
            train_check.readings(s.reference(got, **kw), ref),
            train_check.readings(s.reference(kept, start=start, **kw), ref_w))
        window = train_check.readings(win, ref_w)
        row = {"seed": seed,
               "program": merged(train_check.readings(program_view(got), ref), window),
               "window": window, "control": judged(fp8=True),
               "faults": {"half_batch": judged(half=True)}}
        log(row)
        out.append(row)
        del s, got, ref, ref_w, start, kept, win
        dev.empty_cache(device)
    return out
