"""Training soak: train, crash mid-run, resume, validate.

    python -m rule_guided_music_tpu_torch.train_soak --workdir <dir> [--device cuda]

Counterpart of ``scripts/train_soak.py``. It drives the port's own CLI,
``python -m rule_guided_music_tpu_torch.train_dit``, as subprocesses, the
way a production job runs (reference train_util.py:150-317: resume, the
loop, the eval hooks):

  phase 1  train DiTRotary_XS_8 over the fixture's small KL-VAE, fp32,
           with the loss-second-moment sampler, the EMA eval loss and eval
           sampling, on a synthetic on-disk dataset (manifest CSVs and
           uint8 ``.npy`` rolls, the ``prepare_data`` layout, from
           ``utils.fixtures.make_rolls``), until a SIGKILL once
           ``progress.csv`` shows ``--kill_at_step``: no final save;
  phase 2  relaunch with ``--resume True`` to ``--total_steps``
           (``lr_anneal_steps``).

Both phases share one run directory; the checks read only what the runs
wrote:

  * continuity: the logged steps rise within each phase, and the resumed
    phase's first logged step is the restored checkpoint's: the newest one
    saved whole when the kill landed (the run may have logged, and saved,
    past the step that triggered the kill);
  * completion: the last logged step reaches total_steps - log_interval;
  * final_checkpoint: one at or past the kill step, with the port's SCHEMA;
  * loss_finite, and loss_decreasing: the last decile's mean below
    ``--loss_ratio`` times the first's;
  * no_skipped_steps; eval_loss_logged (``eval_loss`` and its quartile
    keys); eval_samples_written (MIDI under ``samples/iter_*``).

Prints one line ``SOAK_RESULT {json}`` and exits 1 where a check fails.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
VAE_ARCH = {"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}
SCHEMA = "rule-guided-music-tpu-torch/v1"


def build_dataset(workdir: str, n_train: int, n_eval: int, roll_len: int) -> dict:
    """Synthetic uint8 rolls and manifest CSVs in the prepare_data layout."""
    from .utils.fixtures import make_rolls

    os.makedirs(os.path.join(workdir, "rolls"), exist_ok=True)
    manifests = {}
    for split, n, seed in (("train", n_train, 0), ("eval", n_eval, 10_000)):
        rolls = make_rolls(n, length=roll_len, seed=seed)
        lines = ["midi_filename,classes"]
        for i in range(n):
            path = os.path.join(workdir, "rolls", f"{split}_{i}.npy")
            np.save(path, np.clip((rolls[i] + 1.0) * 63.5, 0, 127).astype(np.uint8))
            lines.append(f"{path},{i % 3}")          # 3 dataset-label classes
        manifests[split] = os.path.join(workdir, f"{split}.csv")
        with open(manifests[split], "w") as f:
            f.write("\n".join(lines) + "\n")
    return manifests


def train_cmd(a, manifests: dict, scale: float, resume: bool) -> list:
    cmd = [
        sys.executable, "-m", "rule_guided_music_tpu_torch.train_dit",
        "--dir", "soak", "--data_dir", manifests["train"],
        "--eval_data_dir", manifests["eval"], "--model", "DiTRotary_XS_8",
        "--image_size", "128", "16", "--in_channels", "4", "--num_classes", "3",
        "--class_cond", "True", "--vae_path", FIXTURE,
        "--vae_arch", json.dumps(VAE_ARCH), "--scale_factor", str(scale),
        "--pr_image_size", str(a.pr_image_size), "--encode_rep", str(a.encode_rep),
        "--shift_size", "4", "--batch_size", str(a.batch_size), "--lr", str(a.lr),
        "--lr_anneal_steps", str(a.total_steps),
        "--schedule_sampler", "loss-second-moment",
        "--log_interval", str(a.log_interval), "--save_interval", str(a.save_interval),
        "--eval_interval", str(a.eval_interval), "--eval_sample_batch_size", "2",
        "--diffusion_steps", str(a.diffusion_steps),
        "--bf16", "False", "--seed", "0", "--device", a.device,
    ]
    return cmd + (["--resume", "True"] if resume else [])


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def read_progress(path: str) -> dict:
    """progress.csv as {column: list of floats (nan where empty)}."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    cols = rows[0].keys() if rows else []
    return {c: [float(r[c]) if r.get(c) not in (None, "") else math.nan for r in rows]
            for c in cols}


def saved_steps(ckpt_dir: str) -> list:
    """The steps of the checkpoints whose save finished (``state.pt``
    written; a kill mid-save leaves none)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_")
                  and os.path.exists(os.path.join(ckpt_dir, d, "state.pt")))


def logged_steps(progress: str) -> list:
    return [int(s) for s in read_progress(progress).get("step", []) if not math.isnan(s)]


def run_phase1(a, cmd: list, log_path: str) -> tuple:
    """Run until progress.csv shows step >= kill_at_step, then SIGKILL.
    Returns the steps logged and the checkpoints saved whole when the kill
    landed, both read after it: the resume starts from the newest of them."""
    progress = os.path.join(a.workdir, "loggings", "soak", "progress.csv")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=a.workdir, env=cli_env(), stdout=log,
                                stderr=subprocess.STDOUT)
        deadline = time.time() + a.phase_timeout
        killed_at = None
        try:
            while time.time() < deadline:
                if proc.poll() is not None:
                    raise RuntimeError(f"phase 1 exited (rc={proc.returncode}) before "
                                       f"the kill step; see {log_path}")
                if os.path.exists(progress):
                    try:
                        steps = logged_steps(progress)
                        if steps and steps[-1] >= a.kill_at_step:
                            killed_at = steps[-1]
                            break
                    except (ValueError, IndexError, KeyError):
                        pass             # a CSV caught mid-write; read again
                time.sleep(0.05)
            if killed_at is None:
                raise RuntimeError(f"phase 1 never reached the kill step within "
                                   f"{a.phase_timeout}s")
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logged_steps(progress), saved_steps(os.path.join(a.workdir, "loggings",
                                                           "soak", "checkpoints"))


def validate(a, phase1_steps: list, saved_at_kill: list):
    root = os.path.join(a.workdir, "loggings", "soak")
    df = read_progress(os.path.join(root, "progress.csv"))
    checks, detail = {}, {}
    steps = np.array([s for s in df["step"] if not math.isnan(s)], dtype=int)
    # phase 1's rows as they stood after the kill, then the resumed run's
    n1 = len(phase1_steps)
    before, after = steps[:n1], steps[n1:]
    killed_at = int(before[-1])
    ckpt_dir = os.path.join(root, "checkpoints")
    ckpts = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    ckpt_steps = [int(d.split("_")[1]) for d in ckpts]
    # a save the kill cut short is redone by the resumed run: the resume
    # starts from the newest checkpoint saved whole when the kill landed
    resumed_from = max(saved_at_kill, default=0)
    detail.update(ckpt_steps=ckpt_steps, resumed_from=resumed_from,
                  killed_at=killed_at, final_step=int(steps.max()))
    checks["continuity"] = bool(
        list(before) == phase1_steps and len(after) > 0
        and (np.diff(before) > 0).all() and (np.diff(after) > 0).all()
        and int(after[0]) == resumed_from <= killed_at)
    checks["completion"] = int(steps.max()) >= a.total_steps - a.log_interval
    schema = open(os.path.join(ckpt_dir, ckpts[-1], "SCHEMA")).read().strip()
    checks["final_checkpoint"] = ckpt_steps[-1] >= killed_at and schema == SCHEMA
    loss = np.array([v for v in df["loss"] if not math.isnan(v)])
    dec = max(len(loss) // 10, 1)
    first, last = float(loss[:dec].mean()), float(loss[-dec:].mean())
    detail.update(loss_first_decile=first, loss_last_decile=last)
    checks["loss_finite"] = bool(np.isfinite(loss).all())
    checks["loss_decreasing"] = last < first * a.loss_ratio
    skipped = [v for v in df.get("skipped", []) if not math.isnan(v)]
    checks["no_skipped_steps"] = not any(skipped)
    eval_cols = [c for c in df if c.startswith("eval_")]
    eval_loss = np.array([v for v in df.get("eval_loss", []) if not math.isnan(v)])
    detail.update(eval_keys=eval_cols, n_eval_rows=int(len(eval_loss)))
    checks["eval_loss_logged"] = bool(
        len(eval_loss) >= 2 and np.isfinite(eval_loss).all()
        and any(c.startswith("eval_loss_q") for c in eval_cols))
    samples = os.path.join(root, "samples")
    dirs = sorted(os.listdir(samples)) if os.path.isdir(samples) else []
    midis = sum(len([f for f in os.listdir(os.path.join(samples, d))
                     if f.endswith(".midi")]) for d in dirs)
    checks["eval_samples_written"] = len(dirs) >= 1 and midis >= 1
    detail["sample_iters"] = dirs
    return checks, detail


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--total_steps", type=int, default=2000)
    p.add_argument("--kill_at_step", type=int, default=0,
                   help="0 = 55%% of total_steps")
    p.add_argument("--save_interval", type=int, default=400)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--eval_interval", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--encode_rep", type=int, default=2)
    p.add_argument("--pr_image_size", type=int, default=1536)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--n_train", type=int, default=24)
    p.add_argument("--n_eval", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--loss_ratio", type=float, default=0.8,
                   help="pass if last-decile mean < ratio * first-decile")
    p.add_argument("--phase_timeout", type=int, default=5400)
    return p


def main(argv=None) -> dict:
    a = create_argparser().parse_args(argv)
    a.workdir = os.path.abspath(a.workdir)
    if not a.kill_at_step:
        a.kill_at_step = int(a.total_steps * 0.55)
    os.makedirs(a.workdir, exist_ok=True)
    # the loader's stretch window needs raw length >= 1.05 * pr_image_size
    roll_len = int(math.ceil(a.pr_image_size * 1.05 / 128 + 1)) * 128
    manifests = build_dataset(a.workdir, a.n_train, a.n_eval, roll_len)
    scale = float(np.load(FIXTURE)["scale_factor"])
    t0 = time.time()
    print(f"[soak] phase 1: {a.total_steps} steps, SIGKILL at ~{a.kill_at_step}",
          flush=True)
    phase1_steps, saved_at_kill = run_phase1(a, train_cmd(a, manifests, scale, False),
                                             os.path.join(a.workdir, "phase1.log"))
    t1 = time.time()
    print(f"[soak] killed at step {phase1_steps[-1]} after {t1 - t0:.0f}s; resuming",
          flush=True)
    with open(os.path.join(a.workdir, "phase2.log"), "w") as log:
        rc = subprocess.run(train_cmd(a, manifests, scale, True), cwd=a.workdir,
                            env=cli_env(), stdout=log, stderr=subprocess.STDOUT,
                            timeout=a.phase_timeout).returncode
    if rc != 0:
        tail = open(os.path.join(a.workdir, "phase2.log")).read()[-3000:]
        raise RuntimeError(f"phase 2 (resume) failed rc={rc}:\n{tail}")
    t2 = time.time()
    checks, detail = validate(a, phase1_steps, saved_at_kill)
    result = {"ok": all(checks.values()), "checks": checks, "detail": detail,
              "total_steps": a.total_steps, "device": a.device,
              "phase1_s": round(t1 - t0, 1), "phase2_s": round(t2 - t1, 1)}
    print("SOAK_RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
