"""The port's entry points on the CPU: the import guard, the CLI, MIDI export,
the DDIM branch and the YAML-given targets, against the JAX package where it
has a counterpart."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.data.pianoroll import roll_to_midi as jroll_to_midi
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.models import DiT_models as JaxDiT
from rule_guided_music_tpu.pipeline import resolve_given_targets as jresolve
from rule_guided_music_tpu.utils.fixtures import load_fixture_npz, make_rolls
from rule_guided_music_tpu_torch import config as tconfig
from rule_guided_music_tpu_torch import pipeline, sample_rule
from rule_guided_music_tpu_torch.data.midi_io import read_midi
from rule_guided_music_tpu_torch.data.pianoroll import (
    finalize_decoded_sample,
    roll_to_midi,
    save_piano_roll_midi,
)
from rule_guided_music_tpu_torch.diffusion import schedule as tschedule
from rule_guided_music_tpu_torch.models.dit import DiT_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'

IMPORT_GUARD = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "yaml", "triton", "pretty_midi",
             "pandas", "matplotlib", "rule_guided_music_tpu"):
    sys.modules[name] = None          # any import of these now fails
import rule_guided_music_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for new in ("diffusion.guidance", "diffusion.memory", "models.scoring_head",
            "data.datasets", "edit", "diffusion.collage", "diffusion.edm",
            "utils.viz", "diffcollage_sample", "cfg_sample",
            "classifier_sample", "ops.quant", "models.unet", "pixel",
            "pixel.sample_pixel", "pixel.cfg_sample_pixel", "utils.tables",
            "eval.mgeval", "eval.remi", "eval.fad", "eval_results.compute_rule",
            "eval_results.eval_rule", "eval_results.eval_quality",
            "eval_results.eval_uncond", "eval_results.eval_uncond_summary",
            "eval_results.edit_create_bins", "eval_results.edit_accuracy",
            "eval_results.compute_fad", "training", "training.resample",
            "training.train_loop", "training.vae_train", "training.perceptual",
            "utils.logger", "train_dit", "train_vae"):
    assert "rule_guided_music_tpu_torch." + new in mods, mods
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "flax", "optax", "orbax", "yaml",
                                       "triton", "pandas")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_nothing_the_card_lacks():
    """Every port module and chip_smoke import with jax, flax, optax, orbax,
    yaml, triton, pretty_midi, pandas, matplotlib and the JAX package
    blocked, as on the card."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", IMPORT_GUARD], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device (here, or hidden) or no checkout around it: a non-zero
    exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.create_denoiser("DiTRotary_XS_8")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_rule.main(["--config_path", "unused.yml"])


def test_cli_writes_midi_and_results_on_cpu(tmp_path):
    cfg = os.path.join(REPO, "scripts", "configs", "cond_table", "all", "scg.yml")
    out = tmp_path / "out"
    rows = sample_rule.main([
        "--config_path", cfg, "--model", "DiTRotary_XS_8", "--num_classes", "0",
        "--class_cond", "True", "--model_path", FIXTURE, "--vae_path", FIXTURE,
        "--vae_arch", TINY_VAE_ARCH, "--batch_size", "1", "--num_samples", "1",
        "--timestep_respacing", "2", "--device", "cpu", "--dtype", "float32",
        "--out_dir", str(out)])
    assert len(rows) == 1
    assert {"pitch_hist.loss", "note_density.loss",
            "chord_progression.loss"} <= set(rows[0])
    assert (out / "results.csv").exists() and (out / "summary.csv").exists()
    midi = read_midi(str(out / "sample_0_y_1.midi"))
    assert midi.get_end_time() >= 0.0


def test_midi_export_matches_jax_package(tmp_path):
    rolls = make_rolls(2, seed=4)
    arr = finalize_decoded_sample(rolls)
    for i in range(2):
        ours = roll_to_midi(arr[i].astype(np.float32))
        ref = jroll_to_midi(arr[i].astype(np.float32), use_native=False)
        assert [(n.pitch, n.velocity, n.start, n.end) for n in ours.notes] == \
            [(n.pitch, n.velocity, n.start, n.end) for n in ref.notes]
        assert len(ours.notes) > 0
    paths = save_piano_roll_midi(arr, str(tmp_path), 100, y=[1, 2])
    assert [os.path.basename(p) for p in paths] == ["sample_0_y_1.midi",
                                                    "sample_1_y_2.midi"]
    back = read_midi(paths[0])
    # first-column onset fix applied before the export
    assert len(back.notes) >= len(roll_to_midi(arr[0].astype(np.float32)).notes)


def test_ddim_chain_matches_jax():
    """The DDIM branch (no SCG): same replayed noise, same trajectory."""
    from test_torch_scg_chain import jax_replay_noise

    fx = load_fixture_npz(FIXTURE)
    jdit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                   num_classes=0)
    jt = jschedule.make_schedule("linear", 1000, "ddim5").tables()
    jcfg = jsampling.SamplerConfig(sampler="ddim", eta=1.0)
    with jax.default_matmul_precision("highest"):
        jx, _ = jax.jit(lambda key: jsampling.sample_loop(
            key, lambda x, t, y=None: jdit.apply(fx["dit"], x, t),
            (2, 4, 128, 16), jt, jcfg))(jax.random.PRNGKey(2))
    tdit = pipeline.create_denoiser("DiTRotary_XS_8", num_classes=0,
                                    model_path=FIXTURE, dtype=torch.float32,
                                    device="cpu")
    tt = tschedule.make_schedule("linear", 1000, "ddim5").tables("cpu")
    tx, _ = pipeline.generate(tdit, None, tt,
                              tconfig.SamplerConfig(sampler="ddim", eta=1.0),
                              (2, 4, 128, 16), {}, num_classes=0,
                              noise_fn=jax_replay_noise(2, 5))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-4)


def test_given_targets_match_jax():
    given = {"pitch_hist": [4, 0, 2, 0, 3, 1, 0, 2, 0, 1, 0, 1],
             "vertical_nd": [3, 4, 5, 4, 3, 2, 3, 4],
             "horizontal_nd": [5, 10, 10, 5, 5, 10, 5, 5],
             "chord_progression": [1, 4, 5, 1, 1, 4, 5, 1]}
    ref = jresolve(given, 3)
    out = pipeline.resolve_given_targets(given, 3, device="cpu")
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
        assert out[k].dtype == (torch.int32 if "chord" in k else torch.float32)


def test_randomize_makes_every_block_a_function():
    """adaLN-Zero makes a fresh DiT the identity trunk with a zero head;
    seeded randomize_ gives a finite, non-zero, reproducible output."""
    x = torch.randn(2, 4, 128, 16, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([3.0, 900.0])
    outs = []
    for _ in range(2):
        model = DiT_models["DiTRotary_XS_8"](num_classes=3)
        with torch.no_grad():
            assert model(x, t).abs().max() == 0
            pipeline.randomize_(model, seed=4)
            outs.append(model(x, t, torch.tensor([0, 3])))
    assert torch.isfinite(outs[0]).all() and outs[0].abs().max() > 0
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
