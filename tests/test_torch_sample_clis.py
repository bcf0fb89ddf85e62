"""The port's sampling CLIs on the fixtures: the long-form demos through
``sample_rule``, ``diffcollage_sample``, ``cfg_sample``,
``classifier_sample``, ``--cfg/--w`` on ``sample_rule`` and ``edit``, and
``--record --record_states``.

Each writes the files its JAX counterpart writes: MIDI files of the
chain's length (10.24 s per 128 latent columns), ``results.csv`` with the
columns of the JAX package's ``eval_rule_loss`` and ``summary.csv`` with
a row per loss column, and ``record.pkl`` with every record the JAX
sampler makes for the same config, at the same shapes (read from
``jax.eval_shape`` of its ``sample_loop``). The chains are 2-4 steps of
the quality_tiny DiTRotary_XS_8 and ch-32 VAE; the demos' S/8 classifiers
have no weights in the repo and keep seeded random ones.
"""

import csv
import glob
import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu import config as jconfig
from rule_guided_music_tpu.diffusion import sampling as jsampling
from rule_guided_music_tpu.diffusion import schedule as jschedule
from rule_guided_music_tpu.pipeline import eval_rule_loss
from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch import (cfg_sample, classifier_sample,
                                         diffcollage_sample, edit, pipeline,
                                         sample_rule)
from rule_guided_music_tpu_torch.data.midi_io import read_midi
from rule_guided_music_tpu_torch.data.pianoroll import midi_to_roll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
DEMOS = os.path.join(REPO, "scripts", "configs", "cond_demo")
MODEL_ARGS = [
    "--model", "DiTRotary_XS_8", "--num_classes", "0", "--model_path", FIXTURE,
    "--vae_path", FIXTURE,
    "--vae_arch", '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}',
    "--device", "cpu", "--dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def midi_columns(out_dir):
    """Piano-roll columns (fs 100) of each MIDI file the CLI wrote."""
    paths = sorted(glob.glob(os.path.join(out_dir, "*.midi")))
    return [midi_to_roll(read_midi(p)).shape[-1] for p in paths]


def check_midi(out_dir, n, seconds):
    """``n`` files, none longer than its chain, the long ones longer than
    one 10.24 s excerpt (the roll's silent tail writes nothing)."""
    cols = midi_columns(out_dir)
    assert len(cols) == n, cols
    assert all((seconds - 10.24) * 100 < c <= seconds * 100 for c in cols), cols


def check_tables(out_dir, rule_names, n_rows):
    """results.csv with eval_rule_loss's columns, summary.csv with a row per
    loss column, in pandas' layout."""
    rules = pipeline.extract_targets_from_rolls(
        rule_names, torch.as_tensor(make_rolls(1, seed=3)))
    want = list(eval_rule_loss(jnp.asarray(make_rolls(1, seed=4)),
                               {k: jnp.asarray(v.numpy()) for k, v in rules.items()}
                               ).columns)
    with open(os.path.join(out_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert sorted(rows[0]) == sorted(want) and len(rows) == n_rows + 1
    with open(os.path.join(out_dir, "summary.csv")) as f:
        summary = list(csv.reader(f))
    assert summary[0] == ["", "Attr", "Mean", "Std"]
    assert [r[1] for r in summary[1:]] == [c for c in rows[0] if ".loss" in c]


def jax_record_shapes(yaml_path, steps, shape, rule_names, record_states):
    """The JAX sampler's record for this YAML, by name: shapes only."""
    jcfg = jconfig.sampler_config_from_yaml(
        jconfig.load_config(yaml_path), record=True,
        record_states=record_states, rule_names=rule_names)
    tables = jschedule.make_schedule("linear", 1000, str(steps)).tables()
    rules = {n: jnp.zeros((shape[0], {"pitch_hist": 12, "note_density": 16,
                                      "chord_progression": 8}[n]),
                          jnp.int32 if "chord" in n else jnp.float32)
             for n in rule_names}
    decode = lambda z: jnp.zeros((z.shape[0], 3, 128, z.shape[2] * 8))
    _, rec = jax.eval_shape(lambda key: jsampling.sample_loop(
        key, lambda x, t, y=None: x, shape, tables, jcfg, rules=rules,
        decode_fn=decode), jax.random.PRNGKey(0))
    return {k: v.shape for k, v in rec.items()}


@pytest.mark.parametrize("demo", ["demo1", "demo2", "demo3"])
def test_sample_rule_runs_each_long_form_demo(tmp_path, demo):
    """Two steps (one guided) of each demo YAML: a circle of one image
    (10.24 s), windowed SCG in demo1 (16 columns) and demo2 (128), the
    S/8 classifiers of demo1 and demo3 on the whole latent."""
    out = tmp_path / demo
    args = ["--config_path", os.path.join(DEMOS, demo + ".yml"), *MODEL_ARGS,
            "--class_cond", "True", "--batch_size", "1", "--num_samples", "1",
            "--timestep_respacing", "2", "--out_dir", str(out)]
    rows = sample_rule.main(args)
    rules = ["pitch_hist", "note_density"] + (
        ["chord_progression"] if demo == "demo1" else [])
    assert sorted({c.split(".")[0] for c in rows[0]}) == sorted(rules)
    check_midi(out, 1, 10.24)
    check_tables(out, rules, 1)


def test_sample_rule_writes_the_record_and_states(tmp_path):
    """demo1 with --record --record_states, 3 steps: record.pkl holds
    every record of JAX's sampler at its shape (plus the port's per-window
    ``selected`` and the classifier gradient norm), the plots and six
    state images (as many distinct steps as the chain has)."""
    out = tmp_path / "rec"
    yaml_path = os.path.join(DEMOS, "demo1.yml")
    sample_rule.main(["--config_path", yaml_path, *MODEL_ARGS,
                      "--class_cond", "True", "--batch_size", "1", "--num_samples", "1",
                      "--timestep_respacing", "3", "--record", "True",
                      "--record_states", "True", "--out_dir", str(out)])
    with open(out / "record.pkl", "rb") as f:
        rec = pickle.load(f)
    names = ["pitch_hist", "note_density", "chord_progression"]
    want = jax_record_shapes(yaml_path, 3, (1, 4, 128, 16), names, True)
    assert want.pop("state") == (3, 1, 4, 128, 16)
    for name, shape in want.items():
        assert rec[name].shape == shape, name
    assert set(rec) == set(want) | {"selected", "guidance_grad_norm"}
    assert rec["selected"].shape == (3, 8, 1)
    assert (rec["selected"][:2] >= 0).all() and (rec["selected"][2] == -1).all()
    pngs = sorted(os.path.basename(p) for p in glob.glob(str(out / "*.png")))
    assert [p for p in pngs if p.startswith("state_step")] == [
        "state_step0.png", "state_step1.png", "state_step2.png"]
    assert "log_prob.png" in pngs and "guidance_grad_norm.png" in pngs


def test_save_record_decodes_six_states(tmp_path):
    """The record writer that chip_smoke.py calls on the card: the first
    example's state at six steps spread over the chain, decoded to rolls,
    and record.pkl without the states."""
    vae = pipeline.create_vae(FIXTURE, arch=dict(ch=32, ch_mult=(1, 1, 2, 2),
                                                 num_res_blocks=1),
                              dtype=torch.float32, device="cpu")
    states = torch.randn(10, 2, 4, 256, 16, generator=torch.Generator().manual_seed(0))
    records = {"log_prob": torch.arange(10.0), "state": states}
    rec, decoded = sample_rule.save_record(records, str(tmp_path), vae, 1.0)
    assert sorted(decoded) == [0, 1, 3, 5, 7, 9]
    direct = pipeline.decode_rolls(vae, states[[0, 1, 3, 5, 7, 9], 0], 1.0)
    assert all(decoded[s].shape == (3, 128, 2048) for s in decoded)
    np.testing.assert_array_equal(
        decoded[9], sample_rule.finalize_decoded_sample(
            direct.numpy(), sample_rule.BACKGROUND_THRESHOLD)[5])
    with open(tmp_path / "record.pkl", "rb") as f:
        assert list(pickle.load(f)) == ["log_prob"] == list(rec)


@pytest.mark.parametrize("flags", [
    ["--dc_type", "circle"],
    ["--dc_type", "linear"],
    ["--dc_type", "circle", "--cfg", "True", "--class_cond", "True", "--w", "2"],
])
def test_diffcollage_sample_writes_long_midi(tmp_path, flags):
    """The defaults: three images, overlap 64, 256 latent columns: one
    20.48 s MIDI per sample."""
    out = tmp_path / "dc"
    diffcollage_sample.main([*MODEL_ARGS, "--num_samples", "2",
                             "--timestep_respacing", "3", "--out_dir", str(out),
                             *flags])
    check_midi(out, 2, 20.48)
    assert sorted(os.listdir(out)) == ["sample_0_y_1.midi", "sample_1_y_1.midi"]


@pytest.mark.parametrize("sampler", [["--use_ddim", "True"], ["--sampler", "dpmpp"]])
def test_cfg_sample_writes_midi(tmp_path, sampler):
    out = tmp_path / "cfg"
    cfg_sample.main([*MODEL_ARGS, "--num_samples", "2", "--batch_size", "2",
                     "--timestep_respacing", "ddim4" if "--use_ddim" in sampler
                     else "4", "--class_cond", "True", "--out_dir", str(out),
                     *sampler])
    check_midi(out, 2, 10.24)


def test_classifier_sample_writes_midi_and_tables(tmp_path):
    out = tmp_path / "cls"
    classifier_sample.main([*MODEL_ARGS, "--num_samples", "2", "--batch_size", "1",
                            "--timestep_respacing", "3", "--out_dir", str(out)])
    check_midi(out, 2, 10.24)
    check_tables(out, ["pitch_hist"], 2)


@pytest.mark.parametrize("name", ["sample_rule", "edit", "diffcollage_sample",
                                  "cfg_sample", "classifier_sample"])
def test_cli_takes_cfg_where_the_jax_script_does(name):
    """--cfg/--w parse in a port CLI exactly where the JAX script has them:
    classifier_sample refuses them, as its JAX parser does."""
    jparser = importlib.import_module(f"scripts.{name}").create_argparser()
    tparser = importlib.import_module(
        f"rule_guided_music_tpu_torch.{name}").create_argparser()

    def dests(parser):
        return {a.dest for a in parser._actions} & {"cfg", "w"}

    assert dests(tparser) == dests(jparser)
    if not dests(jparser):
        with pytest.raises(SystemExit):
            tparser.parse_args(["--cfg", "True"])


def test_sample_rule_and_edit_take_cfg(tmp_path, monkeypatch):
    """--cfg/--w reach both CLIs' denoisers: each call of a CFG chain runs
    the conditional and the null halves in one batch of 2B."""
    from test_torch_edit import _edit_yaml, _write_test_set

    batches = []
    create = pipeline.create_denoiser

    def counting(*a, **kw):
        model = create(*a, **kw)
        forward = model.forward
        model.forward = lambda x, t, y=None: batches.append(x.shape[0]) or \
            forward(x, t, y)
        return model

    monkeypatch.setattr(pipeline, "create_denoiser", counting)
    sample_rule.main([
        "--config_path", os.path.join(REPO, "scripts", "configs",
                                      "cond_table", "all", "scg.yml"),
        *MODEL_ARGS, "--class_cond", "True", "--batch_size", "1", "--num_samples", "1",
        "--timestep_respacing", "2", "--cfg", "True", "--w", "3",
        "--out_dir", str(tmp_path / "rule")])
    rule_calls, batches[:] = list(batches), []
    edit.main([
        "--config_path", _edit_yaml(tmp_path, "dataset", noise_level=2),
        "--data_dir", _write_test_set(tmp_path), *MODEL_ARGS, "--class_cond", "True",
        "--batch_size", "1", "--num_samples", "1", "--timestep_respacing", "3",
        "--cfg", "True", "--out_dir", str(tmp_path / "edit")])
    monkeypatch.undo()
    # trajectory calls at 2B, the k=16 rollout at 2kB
    assert rule_calls == [2, 32, 2] and batches == [2, 8, 2]
    check_midi(tmp_path / "rule", 1, 10.24)
    check_midi(tmp_path / "edit", 1, 10.24)


@pytest.mark.parametrize("name", ["sample_rule", "edit"])
def test_class_cond_and_vae_defaults_match_jax(name):
    """The JAX scripts' effective defaults: class_cond False (their
    model_and_diffusion_defaults() overrides the script's own True), and
    sample_rule's --vae kl/f8-all-onset."""
    argv = ["--config_path", "unused.yml"]
    jargs = importlib.import_module(f"scripts.{name}").create_argparser().parse_args(argv)
    targs = importlib.import_module(
        f"rule_guided_music_tpu_torch.{name}").create_argparser().parse_args(argv)
    assert targs.class_cond is jargs.class_cond is False
    if name == "sample_rule":
        assert targs.vae == jargs.vae == "kl/f8-all-onset"


def test_sample_rule_without_vae_matches_jax(tmp_path, monkeypatch):
    """--vae '': no VAE is built, the chain runs with its decode off (SCG
    scores the latents) and the DiT's output is saved as the rolls, as
    scripts/sample_rule.py does (:80-83, 210, 241). The port's CLI draws
    JAX's numbers; its latents, MIDI files and results.csv are held
    against JAX's make_sample_fn with no VAE, and JAX's finalize, export
    and eval_rule_loss on its latents."""
    import pandas as pd

    from rule_guided_music_tpu import pipeline as jpipeline
    from rule_guided_music_tpu.constants import BACKGROUND_THRESHOLD
    from rule_guided_music_tpu.data.midi_io import read_midi as jread_midi
    from rule_guided_music_tpu.data.pianoroll import (
        finalize_decoded_sample as jfinalize, save_piano_roll_midi as jsave)
    from rule_guided_music_tpu.models import DiT_models as JaxDiT
    from rule_guided_music_tpu.utils.fixtures import load_fixture_npz
    from test_torch_eval_chain import replay_cli_noise

    steps, batch = 4, 2
    cfg_path = tmp_path / "pitch.yml"
    cfg_path.write_text(
        "target_rules:\n  pitch_hist: [4., 0., 1., 0., 2., 1., 0., 3., 0., 2., 0., 1.]\n"
        "guidance:\n  vae: True\n  nn: False\n  scg: True\n  method: no_guidance\n"
        "  cond_fn: Null\n  schedule: True\n  t_start: 750\n  t_end: 0\n"
        "  interval: 1\nscg:\n  num_samples: 4\n"
        "sampling:\n  use_ddim: False\n  diff_collage: False\n  t_end: 0\n")

    def no_vae(*a, **kw):
        raise AssertionError("--vae '' built a VAE")

    monkeypatch.setattr(pipeline, "create_vae", no_vae)
    draws, real, decode_flags = replay_cli_noise(0, steps), pipeline.generate, []

    def generate(*a, **kw):
        decode_flags.append(kw["use_decode"])
        return real(*a, **dict(kw, noise_fn=next(draws)))

    monkeypatch.setattr(pipeline, "generate", generate)
    finals = []
    finalize = sample_rule.finalize_decoded_sample
    monkeypatch.setattr(sample_rule, "finalize_decoded_sample",
                        lambda *a, **kw: finals.append(finalize(*a, **kw)) or finals[-1])
    out = tmp_path / "port"
    rows = sample_rule.main([
        "--config_path", str(cfg_path), *MODEL_ARGS, "--vae", "",
        "--batch_size", str(batch), "--num_samples", str(2 * batch),
        "--timestep_respacing", str(steps), "--out_dir", str(out)])
    monkeypatch.undo()
    assert decode_flags == [False, False] and finals[0].shape == (batch, 4, 128, 16)

    # JAX: the script's sampler without a VAE, fed its own key splits
    jconf = jconfig.load_config(str(cfg_path))
    rules = jpipeline.resolve_given_targets(vars(jconf.target_rules), batch)
    sc = jconfig.sampler_config_from_yaml(jconf, rule_names=list(rules))
    dit = JaxDiT["DiTRotary_XS_8"](input_size=(128, 16), in_channels=4,
                                  num_classes=0, learn_sigma=False)
    generate_j = jpipeline.make_sample_fn(
        denoiser_model=dit, tables=jschedule.make_schedule(
            "linear", 1000, str(steps)).tables(),
        sampler_config=sc, gen_shape=(batch, 4, 128, 16), vae_model=None,
        use_decode=False, num_classes=0, class_cond=False)
    params = {"denoiser": load_fixture_npz(FIXTURE)["dit"], "vae": None,
              "classifiers": ()}
    rng, ref = jax.random.PRNGKey(0), []
    with jax.default_matmul_precision("highest"):
        for count in range(0, 2 * batch, batch):
            rng, sub = jax.random.split(rng)
            latents, _ = generate_j(sub, params, rules, None)
            arr = jfinalize(np.asarray(latents), BACKGROUND_THRESHOLD)
            jsave(arr, str(tmp_path / "jax"), 100, save_ind=count)
            np.testing.assert_allclose(
                finals[count // batch].astype(float), arr.astype(float), rtol=0,
                atol=1.0)   # uint8 steps where a latent lies on a rounding edge
            ref.append(eval_rule_loss(jnp.asarray(
                finals[count // batch].astype(np.float32) / 63.5 - 1.0), rules))
    ref = pd.concat(ref, ignore_index=True)
    assert [list(r) for r in rows][0] == list(ref.columns)
    for col in ref.columns:
        for got, want in zip([r[col] for r in rows], ref[col]):
            np.testing.assert_allclose(np.asarray(got, float),
                                       np.asarray(want, float), rtol=1e-5,
                                       atol=1e-6, err_msg=col)
    names = sorted(os.listdir(out))
    assert names == ["results.csv", "sample_0.midi", "sample_1.midi",
                     "sample_2.midi", "sample_3.midi", "summary.csv"]
    for name in names[1:-1]:
        got = read_midi(str(out / name))
        want = jread_midi(str(tmp_path / "jax" / name))
        events = lambda m: ([(n.pitch, n.velocity, n.start, n.end) for n in m.notes],
                            [(c.number, c.value, c.time) for c in m.control_changes])
        assert events(got) == events(want) and got.control_changes, name
