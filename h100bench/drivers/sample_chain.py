"""Window driver: whole sampling chains back to back, one closed-loop
client, as a user who generates an evaluation set.

Each chain is ``pipeline.generate`` (SCG, guidance, the sampler) and then
``pipeline.decode_rolls`` (the final decode) on a batch of the traffic's
size, with the benchmark's noise through ``noise_fn``. The window closes
at the end of the first chain that ends after ``--seconds``; the rate is
the excerpts of all finished chains over that time, reported under the
traffic's ``rate_metric``. One chain, drawn from the seed among the first
``check.chains``, is captured at a few steps drawn from the seed and
judged by the reference after the window. A traced run times
``check.chains`` chains untraced, then traces as many.
"""

from __future__ import annotations

from typing import Dict

import torch

from harness import build as prebuild, common, dev, trace, weights
from harness.data import make_rolls
from reference import diffusion as RD
from reference import rules as RR
from reference import sample_check
from work import dit as W_dit
from work import dit_classifier as W_cls
from work import kl_vae as W_vae

KINDS = {"init": 1, "step": 2, "scg": 3}


def noise_fn(seed: int, chain: int, device):
    """Standard-normal draws for (kind, step, shape), each from its own
    generator seeded by the run's seed, the chain, the kind and the step:
    the reference draws the same numbers for any step alone."""
    def noise(kind, step, shape):
        g = torch.Generator(device=device).manual_seed(
            common.sub_seed(seed, 5, chain + 1, KINDS[kind], step + 1))
        return torch.randn(tuple(shape), generator=g, device=device)
    return noise


def weight_seeds(seed: int, n_cls: int) -> Dict[str, int]:
    out = {"dit": common.sub_seed(seed, 1, 0), "vae": common.sub_seed(seed, 1, 1)}
    out.update({f"cls{i}": common.sub_seed(seed, 1, 2 + i) for i in range(n_cls)})
    return out


def build(cell, seed: int, device, dtype):
    """The program's models with the benchmark's weights: the denoiser,
    the VAE's decode half and, where the traffic guides with them, the
    classifiers."""
    from rule_guided_music_tpu_torch import pipeline
    from rule_guided_music_tpu_torch.models.dit import DiT_models

    cfg, tr = cell.config, cell.traffic
    arch = cfg["denoiser"]
    used = cfg["classifiers"] if tr.get("cond_fns") else []
    seeds = weight_seeds(seed, len(used))
    dit = pipeline.create_denoiser(arch["model"], input_size=arch["input_size"],
                                   in_channels=arch["in_channels"],
                                   num_classes=arch["num_classes"],
                                   learn_sigma=arch.get("learn_sigma", False),
                                   dtype=dtype, device=device)
    weights.init_(dit, seeds["dit"])
    v = cfg["vae"]
    vae = pipeline.create_vae(arch={"ch": v["ch"], "ch_mult": v["ch_mult"],
                                    "num_res_blocks": v["num_res_blocks"]},
                              dtype=dtype, device=device)
    weights.init_(vae, seeds["vae"])
    classifiers = []
    for i, c in enumerate(used):
        with torch.device(device):
            m = DiT_models[c["model"]](input_size=tuple(arch["input_size"]),
                                      in_channels=arch["in_channels"],
                                      num_classes=c["num_classes"])
        m = m.to(dtype).eval().requires_grad_(False)
        classifiers.append(weights.init_(m, seeds[f"cls{i}"]))
    return dit, vae, classifiers, seeds, used


def sampler_config(tr, respacing_steps: int, warm: bool = False):
    from rule_guided_music_tpu_torch.config import GuidanceConfig, SCGConfig, SamplerConfig

    guidance, scg = None, None
    if tr.get("guidance"):
        g = tr["guidance"]
        guidance = GuidanceConfig(method=g["method"], schedule=g["schedule"],
                                  t_start=respacing_steps if warm else g["t_start"],
                                  t_end=g["t_end"], interval=g["interval"])
    if tr.get("scg"):
        s = tr["scg"]
        scg = SCGConfig(num_samples=s["num_samples"], weights=tuple(s["weights"].items()),
                        decode_chunks=s.get("decode_chunks", 1))
    return SamplerConfig(sampler=tr["sampler"], eta=tr.get("eta", 1.0), t_end=tr.get("t_end", 0),
                         guidance=guidance, scg=scg, record=False)


class Capture:
    """Forward hooks on the denoiser, the decoder and the classifiers that
    keep, during the checked chain and at its checked steps, references to
    what the program computed; the candidate decode (tens of MB) goes to
    pinned host buffers by an asynchronous copy, so that the device's
    memory is not held."""

    def __init__(self, dit, decoder, classifiers, batch, steps, host):
        self.batch, self.steps, self.host = batch, set(steps), host
        self.active, self.pos = False, -1
        self.data = {"traj_in": {}, "traj_out": {}, "roll_in": {}, "roll_out": {},
                     "dec_in": {}, "dec_out": {}, "grad": {}}
        self.want = set(steps) | {s + 1 for s in steps}
        self.handles = [
            dit.register_forward_pre_hook(self._dit_pre),
            dit.register_forward_hook(self._dit_post),
            decoder.register_forward_hook(self._dec_post)]
        self.handles += [c.register_forward_pre_hook(self._cls_pre) for c in classifiers]
        self._hooked = set()

    def start(self):
        self.active, self.pos = True, -1

    def _dit_pre(self, mod, args):
        if not self.active:
            return
        x = args[0]
        if x.shape[0] == self.batch:
            self.pos += 1
            if self.pos in self.want:
                self.data["traj_in"][self.pos] = x
        elif self.pos in self.steps:
            self.data["roll_in"][self.pos] = x

    def _dit_post(self, mod, args, out):
        if not self.active or self.pos not in self.steps:
            return
        key = "traj_out" if args[0].shape[0] == self.batch else "roll_out"
        self.data[key][self.pos] = out

    def _dec_post(self, mod, args, out):
        if self.active and self.pos in self.host and self.pos not in self.data["dec_in"]:
            self.data["dec_in"][self.pos] = args[0]
            self.data["dec_out"][self.pos] = self.host[self.pos].copy_(out, non_blocking=True)

    def _cls_pre(self, mod, args):
        # the cond_fn's gradient with respect to x_t, as autograd hands it
        # back to the x_t the classifiers share
        x = args[0]
        if (self.active and self.pos in self.steps and x.requires_grad
                and self.pos not in self._hooked):
            self._hooked.add(self.pos)
            pos = self.pos
            x.register_hook(lambda g: self.data["grad"].__setitem__(pos, g))

    def remove(self):
        for h in self.handles:
            h.remove()


def _name_dit(batch):
    return lambda mod, args: "dit.trajectory" if args[0].shape[0] == batch else "dit.rollout"


def _cls_work(carch, batch, itemsize):
    """A classifier's forward, and under grad mode the backward to its
    input that the cond_fn takes."""
    f = W_cls.forward(carch, batch, itemsize)
    if torch.is_grad_enabled():
        f = {"flops": f["flops"] + W_cls.input_grad(carch, batch, itemsize)["flops"],
             "bytes": f["bytes"]}
    return f


def attach_layers(rec: trace.Recorder, cell, dit, vae, classifiers, batch, itemsize):
    from rule_guided_music_tpu_torch.models.layers import Attention
    from rule_guided_music_tpu_torch.models.vae import FusedNormSwish

    arch, v = cell.config["denoiser"], cell.config["vae"]
    rec.attach([dit], _name_dit(batch), lambda m, a: W_dit.forward(arch, a[0].shape[0], itemsize))
    rec.attach([vae.decoder], lambda m, a: "decoder",
               lambda m, a: W_vae.decoder(v, a[0].shape[0], itemsize, a[0].shape[-1]))
    for c, spec in zip(classifiers, cell.config["classifiers"]):
        carch = dict(spec, input_size=arch["input_size"], in_channels=arch["in_channels"])
        rec.attach([c], lambda m, a: "classifier",
                   lambda m, a, carch=carch: _cls_work(carch, a[0].shape[0], itemsize))
    attn = [m for root in (dit, *classifiers) for m in root.modules() if isinstance(m, Attention)]
    rec.attach(attn, lambda m, a: "attention",
               lambda m, a: W_dit.attention(a[0].shape[0], a[0].shape[1], a[0].shape[2], itemsize))
    norms = [m for m in vae.modules() if isinstance(m, FusedNormSwish)]
    rec.attach(norms, lambda m, a: "groupnorm_swish",
               lambda m, a: W_vae.groupnorm_swish(a[0].numel(), a[0].shape[1], itemsize))


def plan_checks(cell, seed, steps: int, guided_steps):
    """The checked chain and steps, drawn from the seed."""
    ck, tr = cell.traffic["check"], cell.traffic
    r = common.rng(seed, 3)
    chain = int(r.integers(0, ck["chains"]))
    guided = sorted(guided_steps)
    plain = sorted(set(range(steps)) - set(guided))
    pick = lambda pool, n: sorted(int(i) for i in r.choice(pool, size=min(n, len(pool)), replace=False))
    chosen = (pick(guided, ck.get("guided", 0)) if guided else []) + pick(plain, ck["plain"])
    return chain, sorted(chosen)


class Session:
    """The program's models and the chain of one cell, reseedable: the
    window's driver, and the calibration's (which reads a dozen seeds in
    one process)."""

    def __init__(self, cell, device, trace_on=False):
        from rule_guided_music_tpu_torch.diffusion.guidance import guide_schedule_mask
        from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule

        self.cell, self.device = cell, device
        cfg, tr = cell.config, cell.traffic
        self.dtype = getattr(torch, cfg["dtype"])
        self.itemsize = torch.finfo(self.dtype).bits // 8
        self.batch = tr["batch"]
        arch = cfg["denoiser"]
        self.shape = (self.batch, arch["in_channels"], *arch["input_size"])
        self.respacing = tr.get("timestep_respacing", cfg.get("timestep_respacing", ""))
        if tr.get("guidance") and "t_start" not in tr["guidance"]:
            tr["guidance"]["t_start"] = cfg["t_start"]
        sched = lambda r: make_schedule(cfg["noise_schedule"], cfg["diffusion_steps"],
                                        timestep_respacing=r).tables(device)
        self.tables = sched(self.respacing)
        self.steps = self.tables.num_timesteps
        self.config = sampler_config(tr, self.steps)
        # warm-up: a two-step chain of the same shapes (one guided step and
        # one plain step where the traffic guides)
        self.warm_tables, self.warm_config = sched("2"), sampler_config(tr, 2, warm=True)
        g = self.config.guidance
        self.guided = [self.steps - 1 - t for t in range(self.steps)
                       if self.config.scg is not None and g is not None
                       and guide_schedule_mask(t, g.t_start, g.t_end, g.interval)
                       and t > self.config.t_end]
        self.trace_on = trace_on
        self.rec = trace.Recorder()
        self.models = None
        self.cap = None

    def prepare(self, seed: int):
        """The benchmark's weights, targets and checks for ``seed``."""
        from rule_guided_music_tpu_torch import pipeline

        cell, tr = self.cell, self.cell.traffic
        if self.models is None:
            prebuild.prebuild(tr.get("libraries", []), self.device)
            self.models = build(cell, seed, self.device, self.dtype)
            if self.trace_on:
                dit, vae, classifiers = self.models[:3]
                attach_layers(self.rec, cell, dit, vae, classifiers, self.batch, self.itemsize)
        else:
            dit, vae, classifiers, _, used = self.models
            seeds = weight_seeds(seed, len(used))
            for m, key in [(dit, "dit"), (vae, "vae")] + [
                    (c, f"cls{i}") for i, c in enumerate(classifiers)]:
                weights.init_(m, seeds[key])
            self.models = (dit, vae, classifiers, seeds, used)
        dit, vae, classifiers, self.seeds, _ = self.models
        self.seed = seed
        rolls = torch.as_tensor(make_rolls(self.batch, 1024, common.rng(seed, 2)),
                                device=self.device)
        self.targets = {n: RR.RULES[n](rolls) for n in tr.get("targets", [])}
        self.metas = [pipeline.ClassifierSpecMeta(fn=fn, rule_name=rule, scale=scale, model=m)
                      for (fn, rule, scale), m in zip(tr.get("cond_fns", []), classifiers)]
        self.chain_c, self.checked = plan_checks(cell, seed, self.steps, self.guided)
        if self.cap is not None:
            self.cap.remove()
        v = cell.config["vae"]
        side = cell.config["denoiser"]["input_size"][1] * 2 ** (len(v["ch_mult"]) - 1)
        k = tr["scg"]["num_samples"] if tr.get("scg") else 1
        shape = (k * self.batch * 8, v.get("out_ch", 3), side, side)
        host = {p: torch.empty(shape, dtype=self.dtype, pin_memory=self.device.type == "cuda")
                for p in self.checked if p in self.guided}
        self.cap = Capture(dit, vae.decoder, classifiers, self.batch, self.checked, host)
        self.done, self.kept = {"chains": 0, "excerpts": 0}, {}

    def _generate(self, c, tables, config):
        from rule_guided_music_tpu_torch import pipeline

        dit, vae = self.models[:2]
        latents, _ = pipeline.generate(
            dit, vae, tables, config, self.shape, self.targets,
            noise_fn=noise_fn(self.seed, c, self.device), classifier_metas=self.metas,
            class_cond=self.cell.traffic.get("class_cond", False),
            scale_factor=self.cell.config["scale_factor"])
        return latents

    def warm(self):
        from rule_guided_music_tpu_torch import pipeline

        pipeline.decode_rolls(self.models[1], self._generate(-1, self.warm_tables,
                                                             self.warm_config),
                              self.cell.config["scale_factor"])
        dev.sync(self.device)

    def one_chain(self) -> int:
        """One whole chain and its final decode; captures the checked one."""
        from rule_guided_music_tpu_torch import pipeline

        c = self.done["chains"]
        if c == self.chain_c:
            self.cap.start()
        with self.rec.span("chain"):
            latents = self._generate(c, self.tables, self.config)
        self.cap.active = False
        with self.rec.span("final_decode"):
            out = pipeline.decode_rolls(self.models[1], latents, self.cell.config["scale_factor"])
        dev.sync(self.device)
        if c == self.chain_c:
            self.kept.update(latents=latents, rolls=out)
        self.done["chains"] += 1
        self.done["excerpts"] += self.batch
        return self.batch

    def captured(self) -> dict:
        return dict(self.cap.data, latents=self.kept["latents"], rolls=self.kept["rolls"],
                    chain_index=self.chain_c)

    def free(self):
        """Drop the program's state (hooks, models) before the reference."""
        self.cap.remove()
        self.rec.detach()
        self.models = self.metas = self.cap = None
        dev.empty_cache(self.device)

    def reference_models(self):
        cfg = dict(self.cell.config)
        if self.cell.traffic.get("cond_fns"):
            cfg["classifiers_used"] = cfg["classifiers"]
        return sample_check.Models(cfg, self.seeds, self.device, weights.init_)

    def judge(self, data, fp8=False, models=None) -> dict:
        """The reference's readings of the captured chain (with ``fp8``,
        the control's)."""
        sample_check.no_tf32()
        models = models or self.reference_models()
        sched = RD.Schedule(self.cell.config["diffusion_steps"], self.respacing, self.device)
        plan = plan_for(self.cell, self.targets, self.checked, self.guided,
                        bool(self.cell.traffic.get("scg")))
        return sample_check.readings(data, models, sched, plan,
                                     noise_fn(self.seed, data["chain_index"], self.device),
                                     fp8=fp8)


def run(ctx):
    cell, device = ctx.cell, ctx.device
    s = Session(cell, device, ctx.trace)
    s.prepare(ctx.seed)
    s.warm()
    setup_s = ctx.clock() - ctx.t_start
    dev.reset_peak(device)
    if ctx.trace:
        n = cell.traffic["check"]["chains"]
        _, untraced, _ = common.timed_loop(s.one_chain, 0.0, ctx.clock, n)
        s.rec.on = True
        prof = trace.profile()
        prof.__enter__()
        t0 = ctx.clock()
        for _ in range(n):
            s.one_chain()
        elapsed = ctx.clock() - t0
        prof.__exit__(None, None, None)
        s.rec.on = False
    else:
        _, elapsed, times = common.timed_loop(s.one_chain, ctx.seconds, ctx.clock, s.chain_c + 1)
        ctx.log(f"chain s: {[round(x, 4) for x in times]}")
    device_rec = dev.record(device)
    peak_gib = device_rec["memory_peak_bytes"] / 2 ** 30
    result = {"attempted": s.done["excerpts"], "failed": 0, "device": device_rec}
    if ctx.trace:
        summary = trace.summarize(prof, elapsed)
        del prof
        ctx.log(f"trace: {summary.kernels} device operations, {summary.unmatched} without a "
                f"matched launch; device s by layer {summary.layer_device_s}")
        ctx.log(f"untraced {untraced:.3f} s for {n} chains")
        metrics = ctx.read_metrics(summary=summary, calls=list(s.rec.calls),
                                   dtype=cell.config["dtype"], units=n, unit_s=untraced / n)
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    else:
        rate = cell.traffic.get("rate_metric", "excerpts_per_min")
        metrics = {rate: {"value": 60.0 * s.done["excerpts"] / elapsed,
                          "unit": "excerpts/min"},
                   "peak_mem_gib": {"value": peak_gib, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result["metrics"] = metrics
    ctx.log(f"window {elapsed:.3f} s, {s.done['chains']} chains of {s.batch}, set-up "
            f"{setup_s:.3f} s, peak {peak_gib:.3f} GiB; checked chain {s.chain_c}, "
            f"steps {s.checked}")
    data = s.captured()
    s.free()
    check = common.Check(cell.limits)
    numbers = s.judge(data)
    ctx.log(f"readings {numbers}")
    for k, v in numbers.items():
        check.add(k, v)
    return result, check


def plan_for(cell, targets, checked, guided, scg):
    tr, cfg = cell.traffic, cell.config
    return {"steps": checked, "guided": set(guided), "sampler": tr["sampler"],
            "eta": tr.get("eta", 1.0), "k": tr["scg"]["num_samples"] if scg else 1,
            "scg": scg, "targets": targets,
            "weights": tr["scg"]["weights"] if scg else {},
            "specs": [tuple(s) for s in tr.get("cond_fns", [])],
            "num_classes": cfg["denoiser"]["num_classes"],
            "scale_factor": cfg["scale_factor"], "t_end": tr.get("t_end", 0)}


def calibrate(cell, device, seeds, log):
    """Readings of sound runs and of the control on each seed, in one
    process: per seed, the chains up to the checked one, the reference's
    readings of the program, and the control's (the reference in float8
    in the program's place) at the same captured states."""
    s = Session(cell, device)
    out = []
    for i, seed in enumerate(seeds):
        s.prepare(seed)
        if i == 0:
            s.warm()
        while s.done["chains"] <= s.chain_c:
            s.one_chain()
        data = s.captured()
        models = s.reference_models()
        row = {"seed": seed, "program": s.judge(data, models=models),
               "control": s.judge(data, fp8=True, models=models)}
        del models, data
        dev.empty_cache(device)
        log(row)
        out.append(row)
    return out
