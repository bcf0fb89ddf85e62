"""The port's sample_rule -> compute_rule -> eval_rule -> eval_quality chain
on the quality_tiny fixture, with tests/test_cli_eval_chain.py's settings
and asserts.

The port's CLI draws JAX's numbers (:func:`replay_cli_noise` replays the
key splits of ``scripts/sample_rule.py`` and ``sample_loop``), so it
generates the excerpts that JAX's chain test generates and holds its MIDI
round-trip envelopes on them: those envelopes were measured on JAX's draws
and do not hold for every draw (under the port's own generator, one of the
four samples loses notes in the roll -> MIDI export; ROADMAP 3.14).
"""

import ast
import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from rule_guided_music_tpu_torch import pipeline, sample_rule
from rule_guided_music_tpu_torch.constants import BACKGROUND_THRESHOLD
from rule_guided_music_tpu_torch.data.pianoroll import (finalize_decoded_sample,
                                                        save_piano_roll_midi)
from rule_guided_music_tpu_torch.eval_results import (compute_rule, eval_quality,
                                                      eval_rule)
from rule_guided_music_tpu_torch.rules.registry import LOSS_DICT
from rule_guided_music_tpu_torch.utils.fixtures import make_rolls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'
RULES = ("pitch_hist", "note_density", "chord_progression")
# tests/test_cli_eval_chain.py's CONFIG_YML, as JSON (the same tree)
CONFIG = {
    "target_rules": {
        "pitch_hist": [4., 0., 1., 0., 2., 1., 0., 3., 0., 2., 0., 1.],
        "vertical_nd": [3., 3., 2., 2., 3., 3., 2., 2.],
        "horizontal_nd": [8., 8., 6., 6., 8., 8., 6., 6.],
        "chord_progression": [0, 4, 5, 3, 0, 4, 5, 3]},
    "guidance": {"vae": True, "nn": False, "scg": True, "method": "no_guidance",
                 "cond_fn": None, "schedule": True, "t_start": 1000, "t_end": 0,
                 "interval": 1},
    "scg": {"num_samples": 4, "pitch_hist": 40., "note_density": 1.,
            "chord_progression": 1.},
    "sampling": {"use_ddim": False, "diff_collage": False, "t_end": 0},
}


def replay_cli_noise(seed, num_steps):
    """An iterator of noise_fns, one per batch, drawing what
    ``scripts/sample_rule.py --seed seed`` draws: its batch keys split off
    PRNGKey(seed), each split by ``sample_loop`` into x_T's key and a
    (step, scg) pair per step."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, sub = jax.random.split(rng)
        key, init_key = jax.random.split(sub)
        step_keys = []
        for _ in range(num_steps):
            key, noise_key, scg_key = jax.random.split(key, 3)
            step_keys.append({"step": noise_key, "scg": scg_key})

        def noise_fn(kind, step, shape, init_key=init_key, step_keys=step_keys):
            k = init_key if kind == "init" else step_keys[step][kind]
            return torch.as_tensor(np.array(jax.random.normal(k, shape)))

        yield noise_fn


@pytest.fixture
def jax_draws(monkeypatch):
    """Patch the port's generate to draw JAX's numbers, batch by batch;
    yields the latents each batch returned."""
    def use(seed, num_steps):
        draws, latents = replay_cli_noise(seed, num_steps), []
        real = pipeline.generate

        def generate(*args, **kw):
            out = real(*args, **dict(kw, noise_fn=next(draws)))
            latents.append(out[0])
            return out

        monkeypatch.setattr(pipeline, "generate", generate)
        return latents
    return use


def _parse_cell(cell):
    if isinstance(cell, str):
        return np.asarray(ast.literal_eval(cell), dtype=np.float64)
    return np.asarray(cell, dtype=np.float64)


def _loss(rule, gen, target):
    cast = torch.int32 if "chord" in rule else torch.float32
    return float(LOSS_DICT[rule](torch.as_tensor(gen[None]).to(cast),
                                 torch.as_tensor(target[None]).to(cast)))


def test_port_chain_sample_compute_eval_quality(tmp_path, jax_draws):
    scale = float(np.load(FIXTURE)["scale_factor"])
    cfg_path = tmp_path / "chain_tiny.json"
    cfg_path.write_text(json.dumps(CONFIG))
    run_dir = tmp_path / "loggings" / "cond_demo" / "chain_tiny_cls_1"
    jax_draws(0, 8)

    # --- stage 1: sample_rule ---------------------------------------------
    sample_rule.main([
        "--config_path", str(cfg_path), "--model", "DiTRotary_XS_8",
        "--model_path", FIXTURE, "--vae_path", FIXTURE,
        "--vae_arch", TINY_VAE_ARCH, "--scale_factor", str(scale),
        "--image_size", "128", "16", "--num_classes", "0", "--class_cond", "False",
        "--num_samples", "4", "--batch_size", "2", "--timestep_respacing", "8",
        "--seed", "0", "--device", "cpu", "--dtype", "float32",
        "--out_dir", str(run_dir)])
    midis = sorted(p.name for p in run_dir.glob("*.midi"))
    assert midis == [f"sample_{i}.midi" for i in range(4)], midis
    results = pd.read_csv(run_dir / "results.csv")
    assert len(results) == 4
    for rule in RULES:
        for suffix in (".target_rule", ".gen_rule", ".loss"):
            assert rule + suffix in results.columns, results.columns
    assert {"chord_progression.key_str", "chord_progression.key_corr"} \
        <= set(results.columns)
    assert np.isfinite(results[[r + ".loss" for r in RULES]].to_numpy()).all()
    summary = pd.read_csv(run_dir / "summary.csv", index_col=0)
    assert list(summary.columns) == ["Attr", "Mean", "Std"]
    assert set(summary["Attr"]) == {r + ".loss" for r in RULES}

    # --- stage 2: compute_rule reproduces the sampler's self-report --------
    computed_csv = tmp_path / "computed_rules.csv"
    compute_rule.main(["--midi_dir", str(run_dir), "--out", str(computed_csv),
                       "--device", "cpu"])
    computed = pd.read_csv(computed_csv)
    assert list(computed["file"]) == midis
    for rule in RULES:
        for i in range(4):
            gen_cli = _parse_cell(computed[rule][i])
            gen_sampler = _parse_cell(results[rule + ".gen_rule"][i])
            assert gen_cli.shape == gen_sampler.shape, (rule, i)
            assert np.isfinite(gen_cli).all(), (rule, i)
            if rule == "pitch_hist":
                np.testing.assert_allclose(
                    gen_cli, gen_sampler, atol=0.06,
                    err_msg=f"sample {i}: pitch_hist round-trip drift")
            elif rule == "note_density":
                n = gen_cli.shape[0] // 2
                np.testing.assert_allclose(
                    gen_cli[:n], gen_sampler[:n], rtol=0.2, atol=3.0,
                    err_msg=f"sample {i}: vertical-density round-trip drift")
                assert (gen_cli[n:] >= 0).all(), (i, gen_cli)
                assert (gen_cli[n:] <= gen_sampler[n:] + 1.0).all(), \
                    (i, gen_cli, gen_sampler)
            else:
                assert np.all(gen_cli == np.round(gen_cli)), (i, gen_cli)
                assert gen_cli.min() >= 0, (i, gen_cli)
                assert gen_cli.max() <= max(float(gen_sampler.max()), 96.0), \
                    (i, gen_cli)
            target = _parse_cell(results[rule + ".target_rule"][i])
            np.testing.assert_allclose(
                _loss(rule, gen_sampler, target),
                float(results[rule + ".loss"][i]), rtol=1e-3, atol=1e-3,
                err_msg=f"{rule} sample {i}: recomputed loss drift")
            if rule == "pitch_hist":
                np.testing.assert_allclose(
                    _loss(rule, gen_cli, target),
                    float(results[rule + ".loss"][i]), rtol=0.3, atol=0.05,
                    err_msg=f"sample {i}: round-trip pitch_hist loss drift")

    # --- stage 3: eval_rule tabulates the run --------------------------------
    table_csv = tmp_path / "rule_table.csv"
    eval_rule.main(["--root", str(tmp_path / "loggings" / "cond_demo"),
                    "--out", str(table_csv)])
    table = pd.read_csv(table_csv)
    assert len(table) == 1 and int(table["n"][0]) == 4
    assert table["method"][0] == "chain_tiny_cls_1"
    for rule in RULES:
        want = float(
            summary[summary["Attr"] == rule + ".loss"]["Mean"].iloc[0])
        np.testing.assert_allclose(
            float(table[rule + ".loss.mean"].iloc[0]), want, rtol=1e-6,
            err_msg=f"{rule}: eval_rule mean != summary.csv mean")

    # --- stage 4: mgeval quality table vs a synthetic reference set --------
    ref_dir = tmp_path / "ref_midis"
    arr = finalize_decoded_sample(make_rolls(4, seed=3), BACKGROUND_THRESHOLD)
    save_piano_roll_midi(arr, str(ref_dir), 100)
    rows = eval_quality.main(["--generated_dir", str(run_dir), "--reference_dir",
                              str(ref_dir), "--out", str(tmp_path / "quality")])
    quality = pd.read_csv(tmp_path / "quality.csv")
    assert {"feature", "kl_divergence", "overlap_area"} \
        <= set(quality.columns), quality.columns
    assert len(quality) >= 7
    assert np.isfinite(quality["kl_divergence"].to_numpy()).all()
    assert ((quality["overlap_area"] >= 0)
            & (quality["overlap_area"] <= 1)).all()
    assert (tmp_path / "quality_statistics.txt").exists()
    assert len(rows) == len(quality)
