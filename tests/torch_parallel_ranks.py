"""Rank programs of the port's multi-rank tests (gloo on the CPU).

``launch(program, world, workdir)`` starts ``world`` processes of this file,
each ``python torch_parallel_ranks.py <program> <world> <rank> <workdir>``;
they join one gloo group through a file store in ``workdir``, read their
inputs from ``workdir/inputs.npz`` (written by the test with numpy and the
JAX package) and write their results as ``workdir/<name>.npz``. The ranks
import torch and the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'


def launch(program: str, world: int, workdir: str, timeout: int = 600) -> None:
    """Run ``program`` on ``world`` ranks; raise with every rank's output
    tail where one fails."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), program,
                               str(world), str(r), workdir], env=env, cwd=workdir,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = "\n".join(f"--- rank {r} rc {rc}\n"
                          + open(os.path.join(workdir, f"rank{r}.log")).read()[-3000:]
                          for r, rc in enumerate(rcs))
        raise RuntimeError(f"{program} ranks failed: {rcs}\n{tails}")


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _init(world, rank, workdir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)


def _inputs(workdir):
    return dict(np.load(os.path.join(workdir, "inputs.npz")))


def _dit(flat, num_classes=3):
    import torch

    from rule_guided_music_tpu_torch import convert
    from rule_guided_music_tpu_torch.models.dit import DiT_models

    model = DiT_models["DiTRotary_XS_8"](num_classes=num_classes)
    model.load_state_dict(convert.dit_state_dict(flat), strict=True)
    return model.to(torch.float32)


def _params(inp, prefix="p/"):
    return {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}


def _save(workdir, name, **arrays):
    np.savez(os.path.join(workdir, f"{name}.npz"), **arrays)


def _np(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# train: mesh train steps, the loop's save and restore
# ---------------------------------------------------------------------------

TRAIN_CASES = [("2,2,1", "adamw"), ("2,2,1", "adafactor"),
               ("1,2,2", "adamw"), ("1,2,2", "adafactor"),
               # each block under torch.utils.checkpoint (--remat True)
               ("1,2,2", "adamw+remat")]


def train_program(world, rank, workdir):
    import torch
    import torch.distributed as dist

    from rule_guided_music_tpu_torch.diffusion.schedule import make_schedule
    from rule_guided_music_tpu_torch.parallel import mesh as pm
    from rule_guided_music_tpu_torch.training import train_loop as ttl
    from rule_guided_music_tpu_torch.training.resample import create_named_schedule_sampler

    inp = _inputs(workdir)
    tables = make_schedule("linear", 1000).tables("cpu")
    T = torch.as_tensor
    for shape, case in TRAIN_CASES:
        opt, _, remat = case.partition("+")
        mesh = pm.make_mesh(*map(int, shape.split(",")), device="cpu")
        model = _dit(_params(inp))
        model.remat = remat == "remat"
        pm.shard_params(model, mesh)
        cfg = ttl.TrainConfig(optimizer=opt, ema_rate=0.9, lr=1e-3)
        state = ttl.TrainState(model=model, ema_params=ttl.init_ema(model),
                               optimizer=ttl.make_optimizer(cfg, list(model.parameters())))
        step = ttl.make_train_step(model, tables, cfg, None, mesh)
        out = {}
        for s in range(2):
            b = inp[f"lat{s}"].shape[0]
            mine = pm.rows(b, mesh)
            m = step(state, *(T(inp[f"{k}{s}"][mine]) for k in ("lat", "t", "w")),
                     T(inp[f"y{s}"][mine]).long(), T(inp[f"noise{s}"][mine]),
                     T(inp[f"drop{s}"][mine]))
            for k in ("loss", "grad_norm", "param_norm", "per_example_loss",
                      "per_example_mse"):
                out[f"{k}{s}"] = _np(m[k])
        for k, v in model.named_parameters():
            out[f"param/{k}"] = _np(pm.full_tensor(v.detach()))
        for k, v in state.ema_params.items():
            out[f"ema/{k}"] = _np(pm.full_tensor(v))
        placements = {k: [str(q) for q in v.placements] for k, v in model.named_parameters()}
        if rank == 0:
            _save(workdir, f"train_{shape}_{case}", **out)
            with open(os.path.join(workdir, f"placements_{shape}.json"), "w") as f:
                json.dump(placements, f)

    # the loop: two steps with the loss-aware sampler, save, restore on a mesh
    mesh = pm.make_mesh(2, 2, 1, device="cpu")
    model = _dit(_params(inp))
    sampler = create_named_schedule_sampler("loss-second-moment", 1000)
    loop = ttl.TrainLoop(model=model, tables=tables, data=None,
                         config=ttl.TrainConfig(optimizer="adafactor", ema_rate=0.9),
                         schedule_sampler=sampler, seed=3, mesh=mesh,
                         checkpoint_dir=os.path.join(workdir, "ckpt"))
    assert pm.is_sharded(model)
    for s in range(2):
        rows = inp[f"lat{s}"][pm.rows(inp[f"lat{s}"].shape[0], mesh)]
        loop.run_step(rows, {"y": inp[f"y{s}"][pm.rows(len(inp[f"y{s}"]), mesh)]})
        loop.step += 1
    loop.save()
    dist.barrier()
    full = {f"param/{k}": _np(pm.full_tensor(v.detach()))
            for k, v in model.named_parameters()}
    if rank == 0:
        _save(workdir, "loop", history=np.asarray(sampler._loss_history),
              counts=np.asarray(sampler._loss_counts), **full)
    back = ttl.TrainLoop(model=_dit(_params(inp)), tables=tables, data=None,
                         config=ttl.TrainConfig(optimizer="adafactor", ema_rate=0.9),
                         mesh=mesh, seed=3)
    back.restore(ttl.TrainLoop.latest_checkpoint(os.path.join(workdir, "ckpt")))
    # lists, not generators: every rank makes every collective
    same = all([tuple(a.placements) == tuple(b.placements) and
                torch.equal(pm.full_tensor(a.detach()), pm.full_tensor(b.detach()))
                for a, b in zip(back.model.parameters(), model.parameters())])
    opt_same = all([
        torch.equal(pm.full_tensor(sa[k]), pm.full_tensor(sb[k]))
        for sa, sb in zip(back.state.optimizer.state.values(),
                          loop.state.optimizer.state.values())
        for k in sa if torch.is_tensor(sa[k])])
    if rank == 0:
        _save(workdir, "restored", same=np.array(same), opt_same=np.array(opt_same),
              resume_step=np.array(back.resume_step))


# ---------------------------------------------------------------------------
# pipeline: the schedules, the pipelined DiT, sequence parallelism
# ---------------------------------------------------------------------------

def pipeline_program(world, rank, workdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._pytree import tree_leaves, tree_map

    from rule_guided_music_tpu_torch.parallel import mesh as pm
    from rule_guided_music_tpu_torch.parallel import pipeline as pp
    from rule_guided_music_tpu_torch.parallel.comm import Axis

    inp = _inputs(workdir)
    T = torch.as_tensor
    meshes = {n: DeviceMesh("cpu", list(range(n)), mesh_dim_names=("stage",))
              for n in (2, 4)}
    out = {}

    def grads_sum(g):
        g = g.clone()
        dist.all_reduce(g)
        return _np(g)

    def mine(stack, stages, schedule):
        """This stage's blocks of a whole stack (JAX's ``P(axis)`` slice)."""
        n = tree_leaves(stack)[0].shape[0]
        index = pp.stage_blocks(n, stages, rank, schedule)
        return tree_map(lambda a: a[index], stack)

    # GPipe over 4 stages, 8 blocks, 4 microbatches; and its gradient
    tanh = lambda p, c: torch.tanh(c @ p)
    w = T(inp["g_w"]).requires_grad_()
    got = pp.gpipe_apply(tanh, mine(w, 4, "gpipe"), T(inp["g_x"]), mesh=meshes[4],
                         n_micro=4)
    out["gpipe"] = _np(got)
    wd = T(inp["d_w"]).requires_grad_()
    (pp.gpipe_apply(tanh, mine(wd, 4, "gpipe"), T(inp["d_x"]),
                    mesh=meshes[4]) ** 2).sum().backward()
    out["gpipe_grad"] = grads_sum(wd.grad)
    # circular over 4 stages, 12 blocks with a bias
    cw = {"w": T(inp["c_w"]), "b": T(inp["c_b"])}
    out["circular"] = _np(pp.circular_pipeline_apply(
        lambda p, c: torch.tanh(c @ p["w"] + p["b"]), mine(cw, 4, "circular"),
        T(inp["c_x"]), mesh=meshes[4]))
    if rank < 2:
        # a pytree carry and 6 microbatches over 2 stages
        pw = {"w": T(inp["t_w"])}
        o, c = pp.gpipe_apply(lambda p, cc: (torch.tanh(cc[0] @ p["w"]) + cc[1], cc[1]),
                              mine(pw, 2, "gpipe"), (T(inp["t_x"]), T(inp["t_c"])),
                              mesh=meshes[2], n_micro=6)
        out["tree"], out["tree_c"] = _np(o), _np(c)
        # the circular schedule's gradient over 2 stages
        cd = {"w": T(inp["cd_w"]).requires_grad_()}
        loss = (pp.circular_pipeline_apply(lambda p, cc: torch.tanh(cc @ p["w"]),
                                           mine(cd, 2, "circular"), T(inp["cd_x"]),
                                           mesh=meshes[2]) ** 2).mean()
        loss.backward()
        g = cd["w"].grad.clone()
        dist.all_reduce(g, group=meshes[2].get_group())
        out["circ_loss"], out["circ_grad"] = _np(loss), _np(g)
        # the pipelined DiT, both schedules, each stage holding only the
        # blocks it runs: every rank's kept blocks and parameter count
        x, t, y = T(inp["dit_x"]), T(inp["dit_t"]), T(inp["dit_y"]).long()
        for schedule, kw in (("gpipe", dict(n_micro=4)), ("circular", {})):
            model = pp.keep_stage_blocks_(_dit(_params(inp)), meshes[2],
                                          schedule=schedule).eval()
            held = [i for i, b in enumerate(model.blocks)
                    if not isinstance(b, pp.DroppedBlock)]
            every = [None, None]
            dist.all_gather_object(every, (held, sum(p.numel() for p in model.parameters())),
                                   group=meshes[2].get_group())
            out[f"held_{schedule}"] = np.array([h for h, _ in every])
            out[f"numel_{schedule}"] = np.array([n for _, n in every])
            with torch.no_grad():
                out[f"dit_{schedule}"] = _np(pp.pipelined_dit_rotary_apply(
                    model, x, t, y, mesh=meshes[2], schedule=schedule, **kw))
        model = _dit(_params(inp))
        stacked, rest = pp.stack_block_params(model.state_dict(), model.depth)
        back = pp.unstack_block_params(stacked, rest)
        out["roundtrip"] = np.array(all(torch.equal(back[k], v)
                                        for k, v in model.state_dict().items())
                                    and len(back) == len(model.state_dict()))
    dist.barrier()
    # sequence parallelism: the tokens over 4 ranks
    model = _dit(_params(inp)).eval()
    seq = Axis(dist.group.WORLD, world, rank)
    pm.sequence_parallel(model, seq)
    with torch.no_grad():
        out["sp"] = _np(model(T(inp["sp_x"]), T(inp["sp_t"]), T(inp["sp_y"]).long()))
    if rank == 0:
        _save(workdir, "pipeline", **out)


# ---------------------------------------------------------------------------
# mesh: the CLIs, build_mesh, the logger, generate(mesh=)
# ---------------------------------------------------------------------------

def mesh_program(world, rank, workdir):
    import torch
    import torch.distributed as dist

    from rule_guided_music_tpu_torch import config as tconfig
    from rule_guided_music_tpu_torch import pipeline, sample_rule, train_dit
    from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
    from rule_guided_music_tpu_torch.parallel import mesh as pm
    from rule_guided_music_tpu_torch.pixel import train_dit_pixel, train_unet_pixel
    from rule_guided_music_tpu_torch.utils import logger

    inp = _inputs(workdir)
    out = {}
    # the logger: rank 0 writes the run files, rank 1 its own log only
    logger.configure(dir=os.path.join(workdir, "logrun"))
    logger.logkv("x", 1.0)
    logger.dumpkvs()
    # build_mesh's auto mode and its assert
    args = lambda **kw: train_dit.create_argparser().parse_args(
        [f"--{k}={v}" for k, v in kw.items()])
    auto = train_dit.build_mesh(args(batch_size=4), "cpu")
    out["auto4"] = np.array([auto.size(0), auto.size(1), auto.size(2)])
    odd = train_dit.build_mesh(args(batch_size=3), "cpu")
    out["auto3_idle"] = np.array(train_dit.idle(odd))
    try:
        train_dit.build_mesh(args(batch_size=3, dp=2), "cpu")
        out["assert"] = np.array("")
    except AssertionError as e:
        out["assert"] = np.array(str(e))
    try:
        pm.make_mesh(dp=3, device="cpu")
        out["factor"] = np.array("")
    except ValueError as e:
        out["factor"] = np.array(str(e))
    # generate(mesh=) on quality_tiny with the JAX chain's draws
    mesh = pm.make_mesh(2, device="cpu")
    draws = {k: v for k, v in inp.items() if k.startswith("draw/")}

    def replay(kind, step, shape):
        key = f"draw/{kind}" if kind == "init" else f"draw/{kind}/{step}"
        a = torch.as_tensor(draws[key])
        assert tuple(a.shape) == tuple(shape), (key, a.shape, shape)
        return a

    tiny = json.loads(TINY_VAE)
    dit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0, model_path=FIXTURE,
                                   dtype=torch.float32, device="cpu")
    vae = pipeline.create_vae(FIXTURE, arch=tiny, dtype=torch.float32, device="cpu")
    steps = int(inp["chain_steps"])
    tables = tschedule.make_schedule("linear", 1000, str(steps)).tables("cpu")
    cfg = tconfig.SamplerConfig(
        guidance=tconfig.GuidanceConfig(schedule=True, t_start=750),
        scg=tconfig.SCGConfig(num_samples=int(inp["chain_k"]),
                              weights=(("pitch_hist", 40.0), ("note_density", 1.0))))
    rules = pipeline.extract_targets_from_rolls(
        ("pitch_hist", "note_density"), torch.as_tensor(inp["chain_rolls"]))
    lat, _ = pipeline.generate(dit, vae, tables, cfg, tuple(inp["chain_shape"]), rules,
                               noise_fn=replay, num_classes=0, scale_factor=1.0,
                               mesh=mesh)
    out["chain"] = _np(lat)
    # the CLIs on 2 ranks at fixture size
    ts = os.path.join(workdir, "ts")
    common = ["--device", "cpu", "--bf16", "False", "--max_steps", "1",
              "--log_interval", "1"]
    dit_flags = ["--data_dir", f"{ts}/data_test_cls_1.csv", "--model", "DiTRotary_XS_8",
                 "--vae_path", FIXTURE, "--vae_arch", TINY_VAE, "--pr_image_size",
                 "1024", "--batch_size", "4", "--encode_rep", "1"]
    for flag in ("--dp", "--fsdp", "--tp"):
        loop = train_dit.main(dit_flags + common + [flag, "2", "--dir",
                                                    f"{workdir}/td{flag[2:]}"])
        out[f"train_dit{flag[2:]}"] = np.array(
            [float(loop.step), pm.is_sharded(loop.model)])
    pix = ["--data_dir", f"{ts}/data_test_cls_1.csv", "--image_size", "128", "32",
           "--batch_size", "2"] + common
    loop = train_unet_pixel.main(pix + ["--num_channels", "8", "--num_res_blocks", "1",
                                        "--attention_resolutions", "8",
                                        "--dp", "2", "--dir", f"{workdir}/unet"])
    out["unet"] = np.array([float(loop.step), pm.is_sharded(loop.model)])
    loop = train_dit_pixel.main(pix + ["--model", "DiT-S/8", "--fsdp", "2",
                                       "--dir", f"{workdir}/ditpix"])
    out["ditpix"] = np.array([float(loop.step), pm.is_sharded(loop.model)])
    rows = sample_rule.main([
        "--config_path", os.path.join(REPO, "scripts/configs/cond_table/all/scg.yml"),
        "--model", "DiTRotary_XS_8", "--num_classes", "0", "--model_path", FIXTURE,
        "--vae_path", FIXTURE, "--vae_arch", TINY_VAE, "--batch_size", "2",
        "--num_samples", "2", "--timestep_respacing", "2", "--device", "cpu",
        "--dtype", "float32", "--out_dir", f"{workdir}/sample", "--mesh", "2"])
    out["sample_rows"] = np.array(len(rows))
    dist.barrier()
    _save(workdir, f"mesh_r{rank}", **out)


PROGRAMS = {"train": train_program, "pipeline": pipeline_program,
            "mesh": mesh_program}


if __name__ == "__main__":
    program, world, rank, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    sys.modules.pop("jax", None)
    sys.modules["jax"] = None          # the ranks must not import JAX
    try:
        _init(world, rank, workdir)
        PROGRAMS[program](world, rank, workdir)
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
