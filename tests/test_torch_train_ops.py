"""The port's training-operations scripts on the CPU: ``train_probe``
under ``TRAIN_PROBE_TINY=1`` (every stage prints, the four step
configurations report), a short ``train_soak`` through the port's
``train_dit`` CLI (kill, resume, every check), and the soak's checks on
a run directory made to order."""

import argparse
import json
import os

import pytest

from rule_guided_music_tpu_torch import train_probe, train_soak


def test_train_probe_tiny_prints_every_stage(monkeypatch, capsys):
    monkeypatch.setenv("TRAIN_PROBE_TINY", "1")
    res = train_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("model=DiTRotary_XS_8 loader_batch=2 -> train_batch=8 (encode_rep=4)",
                 "stage: get_kl_input", "get_kl_input:", "end-to-end step", "done"):
        assert line in out, line
    for opt, remat in train_probe.CONFIGS:
        label = f"{opt}{'+remat' if remat else ''}"
        assert f"stage: train step [{label}]" in out
        assert f"[{label}] step:" in out
    assert not res["failed"] and [s["config"] for s in res["steps"]] == [
        "adafactor+remat", "adamw+remat", "adafactor", "adamw"]
    assert res["encode"]["latents"] == [8, 4, 128, 16]
    assert all(s["peak_gib"] is None for s in res["steps"])      # no card here
    line = next(l for l in out.splitlines() if l.startswith("TRAIN_PROBE "))
    assert json.loads(line[len("TRAIN_PROBE "):])["train_batch"] == 8


def test_train_soak_kills_resumes_and_passes(tmp_path, capsys):
    """12 steps killed past 7 (saves every 3), resumed to the end: one
    drop-back onto the restored checkpoint, the final save with the port's
    SCHEMA, eval losses and samples; over so few steps the loss is held to
    decrease at all (ratio 1)."""
    res = train_soak.main([
        "--workdir", str(tmp_path), "--device", "cpu", "--total_steps", "12",
        "--kill_at_step", "7", "--save_interval", "3", "--log_interval", "1",
        "--eval_interval", "6", "--batch_size", "2", "--encode_rep", "1",
        "--pr_image_size", "1024", "--n_train", "4", "--n_eval", "2",
        "--diffusion_steps", "20", "--loss_ratio", "1.0"])
    assert res["ok"], res
    assert res["detail"]["resumed_from"] == 6
    assert "SOAK_RESULT " in capsys.readouterr().out


def _soak_run_dir(root, steps, ckpts):
    """A run directory as train_dit leaves it: progress.csv over ``steps``,
    whole checkpoints at ``ckpts``, one eval sample."""
    run = os.path.join(root, "loggings", "soak")
    for c in ckpts:
        os.makedirs(os.path.join(run, "checkpoints", f"step_{c:06d}"))
        with open(os.path.join(run, "checkpoints", f"step_{c:06d}", "SCHEMA"), "w") as f:
            f.write(train_soak.SCHEMA + "\n")
    os.makedirs(os.path.join(run, "samples", "iter_000000"))
    open(os.path.join(run, "samples", "iter_000000", "0.midi"), "w").close()
    rows = ["step,loss,eval_loss,eval_loss_q0,skipped"]
    for i, s in enumerate(steps):
        ev = "0.5,0.5" if s % 20 == 0 else ","
        rows.append(f"{s},{1.0 / (1 + i)},{ev},0")
    with open(os.path.join(run, "progress.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("resumed_at, ok", [(30, True), (20, False)])
def test_soak_continuity_follows_the_resume_past_the_trigger(tmp_path, resumed_at, ok):
    """The kill is triggered at a logged 26, but the run went on to log and
    save step 30 before it landed: the resume restores 30, with no drop
    of the logged step at the boundary. Resuming from 20 instead is a fault."""
    phase1 = list(range(0, 31, 2))
    _soak_run_dir(tmp_path, phase1 + list(range(resumed_at, 40, 2)), [10, 20, 30, 39])
    a = argparse.Namespace(workdir=str(tmp_path), total_steps=40, log_interval=2,
                           loss_ratio=0.8)
    checks, detail = train_soak.validate(a, phase1, [10, 20, 30])
    assert checks["continuity"] is ok, detail
    assert (detail["resumed_from"], detail["killed_at"]) == (30, 30)
    assert all(v for k, v in checks.items() if k != "continuity"), checks
