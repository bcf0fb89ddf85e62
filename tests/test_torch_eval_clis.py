"""The port's eight evaluation CLIs (rule_guided_music_tpu_torch.eval_results)
against the JAX package's scripts/eval_results on the same inputs.

Each JAX script runs by subprocess, as tests/test_eval.py runs them; each
port CLI through ``main(argv)``. Outputs are compared parsed (pandas
reads both): compute_rule's values within 1e-5, chord tags equal except
at an exact float64 tie (ROADMAP 3.1); eval_rule and eval_quality within
1e-9 with the same file names; eval_uncond, eval_uncond_summary and
edit_create_bins equal; edit_accuracy's and compute_fad's printed lines
equal. The inputs include the pandas edge cases: a one-row results.csv
(std NaN), a NaN loss, a missing attribute and ties in the summary's sort.
Each CLI's flags and defaults equal the JAX script's, apart from
compute_rule's --device.
"""

import argparse
import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from rule_guided_music_tpu.data.pianoroll import (
    finalize_decoded_sample as jfinalize,
    save_piano_roll_midi as jsave,
)
from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch.constants import EXCERPT_COLS
from rule_guided_music_tpu_torch.eval_results import (
    compute_fad, compute_rule, edit_accuracy, edit_create_bins, eval_quality,
    eval_rule, eval_uncond, eval_uncond_summary)
from test_torch_rules import _assert_tags_equal_up_to_exact_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts", "eval_results")
PORT = {m.__name__.rsplit(".", 1)[-1]: m for m in (
    compute_fad, compute_rule, edit_accuracy, edit_create_bins, eval_quality,
    eval_rule, eval_uncond, eval_uncond_summary)}
ATTRS = ["total_used_pitch", "avg_IOI", "total_pitch_class_histogram",
         "pitch_range", "mean_note_velocity", "mean_note_duration",
         "note_density", "avg"]


def run_jax(name, *args, cwd=REPO):
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name + ".py"), *map(str, args)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=cwd,
        capture_output=True, text=True, timeout=600)
    return proc


def run_port(capsys, name, *args):
    capsys.readouterr()
    out = PORT[name].main([str(a) for a in args])
    return out, capsys.readouterr().out


def assert_frames_close(got, want, tol=1e-9):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        a, b = got[col], want[col]
        assert a.isna().tolist() == b.isna().tolist(), col
        if pd.api.types.is_numeric_dtype(b):
            np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float),
                                       rtol=tol, atol=tol, err_msg=col)
        else:
            assert a[~a.isna()].tolist() == b[~b.isna()].tolist(), col


@pytest.fixture(scope="module")
def midi_sets(tmp_path_factory):
    """Two sets of 6 MIDI files written by the JAX package, the generated
    one with a .mid file among its .midi ones."""
    root = tmp_path_factory.mktemp("sets")
    sets = {}
    for name, seed in (("gen", 5), ("ref", 6)):
        sets[name] = root / name
        jsave(jfinalize(make_rolls(6, seed=seed)), str(sets[name]), 100)
    os.rename(sets["gen"] / "sample_5.midi", sets["gen"] / "sample_5.mid")
    return sets


@pytest.mark.parametrize("extra", [[], ["--rules", "pitch_hist",
                                        "note_density_hr_2", "chord_progression",
                                        "--length", "512"]])
def test_compute_rule_matches_jax(tmp_path, midi_sets, capsys, extra):
    proc = run_jax("compute_rule", "--midi_dir", midi_sets["gen"], "--out",
                   tmp_path / "jax.csv", *extra)
    assert proc.returncode == 0, proc.stderr[-2000:]
    _, out = run_port(capsys, "compute_rule", "--midi_dir", midi_sets["gen"],
                      "--out", tmp_path / "port.csv", "--device", "cpu", *extra)
    assert out.splitlines()[-1] == proc.stdout.splitlines()[-1].replace(
        "jax.csv", "port.csv")
    want, got = pd.read_csv(tmp_path / "jax.csv"), pd.read_csv(tmp_path / "port.csv")
    assert list(got.columns) == list(want.columns)
    assert got["file"].tolist() == want["file"].tolist()
    length = int(extra[-1]) if extra else EXCERPT_COLS
    rolls = compute_rule.load_batch(
        compute_rule.midi_files(str(midi_sets["gen"])), length, "cpu").numpy()
    for rule in want.columns[1:]:
        a = np.array([ast.literal_eval(c) for c in got[rule]])
        b = np.array([ast.literal_eval(c) for c in want[rule]])
        assert a.shape == b.shape, rule
        if "chord" in rule:
            _assert_tags_equal_up_to_exact_ties(rolls, a, b, 100)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=rule)


def test_compute_rule_refuses_cuda_without_a_card(tmp_path, midi_sets):
    if torch.cuda.is_available():
        pytest.skip("this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_rule.main(["--midi_dir", str(midi_sets["gen"]), "--out",
                           str(tmp_path / "x.csv")])


def _results_tree(root):
    """results.csv files as the sampling CLIs write them (pandas): three
    rows, one row (std NaN), a NaN loss with other columns, and a
    directory without one."""
    def write(rel, rows):
        (root / rel).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / rel / "results.csv", index=False)

    rng = np.random.default_rng(0)
    write("scg_cls_1", [{"pitch_hist.target_rule": str([0.1] * 12),
                         "pitch_hist.gen_rule": str(list(rng.random(12))),
                         "pitch_hist.loss": float(rng.random()),
                         "note_density.loss": float(rng.random() * 10)}
                        for _ in range(3)])
    write(os.path.join("edit", "one_row"), [{"note_density.loss": 2.5,
                                             "chord_progression.loss": 0.25}])
    write("with_nan", [{"pitch_hist.loss": v, "chord_progression.key_str": "C",
                        "chord_progression.loss": 0.5}
                       for v in (0.1, float("nan"), 0.3, 0.7)])
    (root / "empty_dir").mkdir()


def test_eval_rule_matches_jax(tmp_path, capsys):
    _results_tree(tmp_path / "root")
    proc = run_jax("eval_rule", "--root", tmp_path / "root", "--out",
                   tmp_path / "jax.csv")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows, _ = run_port(capsys, "eval_rule", "--root", tmp_path / "root",
                       "--out", tmp_path / "port.csv")
    want = pd.read_csv(tmp_path / "jax.csv")
    assert_frames_close(pd.read_csv(tmp_path / "port.csv"), want)
    assert len(rows) == 3 and want["n"].tolist() == [r["n"] for r in rows]
    # the one-row file's std is NaN, the NaN loss is skipped
    assert want.filter(like=".std").isna().to_numpy().any()


def _quality_files(out):
    return sorted(os.listdir(out))


def test_eval_quality_single_run_matches_jax(tmp_path, midi_sets, capsys):
    args = ["--generated_dir", midi_sets["gen"], "--reference_dir",
            midi_sets["ref"], "--max_files", "5"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    proc = run_jax("eval_quality", *args, "--out", tmp_path / "jax" / "q")
    assert proc.returncode == 0, proc.stderr[-2000:]
    run_port(capsys, "eval_quality", *args, "--out", tmp_path / "port" / "q")
    assert _quality_files(tmp_path / "port") == _quality_files(tmp_path / "jax") \
        == ["q.csv", "q_statistics.txt"]
    assert_frames_close(pd.read_csv(tmp_path / "port" / "q.csv"),
                        pd.read_csv(tmp_path / "jax" / "q.csv"))
    assert (tmp_path / "port" / "q_statistics.txt").read_text() == \
        (tmp_path / "jax" / "q_statistics.txt").read_text()


@pytest.mark.parametrize("naming", [
    ["--dataset", "maestro", "--method", "scg", "--out", "{d}/custom"],
    ["--out", "{d}/quality", "--seed", "3"]])
def test_eval_quality_runs_match_jax(tmp_path, midi_sets, capsys, naming):
    args = ["--generated_dir", midi_sets["gen"], "--reference_dir",
            midi_sets["ref"], "--runs", "3", "--subsample", "4"]
    outs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        flags = args + [a.format(d=d) for a in naming]
        if side == "jax":
            proc = run_jax("eval_quality", *flags)
            assert proc.returncode == 0, proc.stderr[-2000:]
            printed = proc.stdout
        else:
            _, printed = run_port(capsys, "eval_quality", *flags)
        outs[side] = (printed.splitlines()[0].startswith("note:"), printed.splitlines()[0]
                      .replace(str(d), ""), _quality_files(d))
    assert outs["port"] == outs["jax"]
    names = outs["jax"][2]
    assert len(names) == 2 and all(n.endswith((".mean.csv", ".std.csv")) for n in names)
    for name in names:
        assert_frames_close(pd.read_csv(tmp_path / "port" / name),
                            pd.read_csv(tmp_path / "jax" / name))


def _uncond_folder(folder, attrs_missing=()):
    """<dataset>.<method>.<mean|std>.csv files as eval_quality --runs N
    writes them, one attribute left out of one file, and a file the
    pivot skips."""
    folder.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for dataset, method in [("pop", "scg"), ("maestro", "scg"),
                            ("maestro", "base"), ("muscore", "dps")]:
        for stat in ("mean", "std"):
            attrs = [a for a in ATTRS if (dataset, a) not in attrs_missing]
            pd.DataFrame({"attribute": attrs, "KL": rng.random(len(attrs)),
                          "OA": rng.random(len(attrs))}).to_csv(
                folder / f"{dataset}.{method}.{stat}.csv", index=False)
    (folder / "notes.csv").write_text("a,b\n1,2\n")


@pytest.mark.parametrize("metric", ["OA", "KL"])
def test_eval_uncond_matches_jax(tmp_path, capsys, metric):
    for side in ("jax", "port"):
        _uncond_folder(tmp_path / side, attrs_missing={("pop", "avg")})
    proc = run_jax("eval_uncond", "--path_to_folder", tmp_path / "jax",
                   "--metric", metric)
    assert proc.returncode == 0, proc.stderr[-2000:]
    run_port(capsys, "eval_uncond", "--path_to_folder", tmp_path / "port",
             "--metric", metric)
    for stat in ("mean", "std"):
        want = pd.read_csv(tmp_path / "jax" / f"results_{stat}.csv")
        assert_frames_close(pd.read_csv(tmp_path / "port" / f"results_{stat}.csv"),
                            want, tol=0)
        assert want["avg"].isna().sum() == 1


def test_eval_uncond_summary_matches_jax(tmp_path, capsys):
    """Three folders whose tables share (dataset, method) pairs: the
    summary's sort keeps the folders' order on ties."""
    for side in ("jax", "port"):
        for i, sub in enumerate(("a", "b/c", "d")):
            folder = tmp_path / side / sub
            folder.mkdir(parents=True)
            for stat in ("mean", "std"):
                pd.DataFrame({"dataset": ["pop", "maestro"],
                              "method": ["scg", "scg"],
                              "avg": [0.1 * i, float("nan") if i == 1 else 0.2 * i],
                              "note_density": [i, i + 1]}).to_csv(
                    folder / f"results_{stat}.csv", index=False)
    proc = run_jax("eval_uncond_summary", "--path_to_folder", tmp_path / "jax")
    assert proc.returncode == 0, proc.stderr[-2000:]
    _, printed = run_port(capsys, "eval_uncond_summary", "--path_to_folder",
                          tmp_path / "port")
    assert printed.replace(str(tmp_path / "port"), "") == \
        proc.stdout.replace(str(tmp_path / "jax"), "")
    for stat in ("mean", "std"):
        want = pd.read_csv(tmp_path / "jax" / f"summary_{stat}.csv")
        assert_frames_close(pd.read_csv(tmp_path / "port" / f"summary_{stat}.csv"),
                            want, tol=0)
        assert want["dataset"].tolist() == ["maestro"] * 3 + ["pop"] * 3


def _edit_results(path, rows=24, seed=0):
    rng = np.random.default_rng(seed)
    pd.DataFrame({
        "note_density.target_rule": [
            str([round(float(x), 3) for x in rng.uniform(0.5, 7.5, size=16)])
            for _ in range(rows)],
        "note_density.gen_rule": [
            str([round(float(x), 3) for x in rng.uniform(0.5, 7.5, size=16)])
            for _ in range(rows)],
        "note_density.loss": rng.random(rows)}).to_csv(path, index=False)


@pytest.mark.parametrize("bins", ["8", "5"])
def test_edit_create_bins_matches_jax(tmp_path, capsys, bins):
    _edit_results(tmp_path / "results.csv")
    proc = run_jax("edit_create_bins", "--file_name", tmp_path / "results.csv",
                   "--bins", bins, "--out", tmp_path / "jax.json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out, printed = run_port(capsys, "edit_create_bins", "--file_name",
                            tmp_path / "results.csv", "--bins", bins,
                            "--out", tmp_path / "port.json")
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want == out
    assert printed.splitlines()[:-1] == proc.stdout.splitlines()[:-1]
    assert len(want["vertical_bounds"]) == int(bins) - 1


@pytest.mark.parametrize("hr_scale", ["1.0", "2.0"])
def test_edit_accuracy_matches_jax(tmp_path, capsys, hr_scale):
    _edit_results(tmp_path / "results.csv", rows=10, seed=hr_scale == "2.0")
    proc = run_jax("edit_accuracy", "--results", tmp_path / "results.csv",
                   "--hr_scale", hr_scale)
    assert proc.returncode == 0, proc.stderr[-2000:]
    _, printed = run_port(capsys, "edit_accuracy", "--results",
                          tmp_path / "results.csv", "--hr_scale", hr_scale)
    assert printed.splitlines() == proc.stdout.splitlines()


def test_compute_fad_matches_jax(tmp_path, midi_sets, capsys):
    args = ["--background_dir", midi_sets["ref"], "--eval_dir",
            midi_sets["gen"], "--max_files", "3"]
    proc = run_jax("compute_fad", *args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    score, printed = run_port(capsys, "compute_fad", *args)
    assert printed.splitlines() == proc.stdout.splitlines()
    assert np.isfinite(score) and score >= 0
    # vggish: the gate's error in both, no fallback to the proxy
    proc = run_jax("compute_fad", *args, "--backend", "vggish")
    assert proc.returncode != 0
    with pytest.raises(RuntimeError) as gate:
        compute_fad.main([str(a) for a in args] + ["--backend", "vggish"])
    assert f"RuntimeError: {gate.value}" in proc.stderr


class _Parsed(Exception):
    pass


def _jax_parser(name, monkeypatch):
    """The parser that scripts/eval_results/<name>.py builds in its main."""
    spec = importlib.util.spec_from_file_location(
        f"jax_eval_{name}", os.path.join(SCRIPTS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as parsed:
        module.main()
    monkeypatch.undo()
    return parsed.value.args[0]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs,
                     getattr(a.type, "__name__", a.type),
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PORT))
def test_cli_flags_and_defaults_match_jax(name, monkeypatch):
    want = _flags(_jax_parser(name, monkeypatch))
    got = _flags(PORT[name].create_argparser())
    if name == "compute_rule":
        assert got.pop("device")[1] == "cuda"
    assert got == want


TABLE_CASES = {
    "mixed": [{"a": 1, "b": 0.1, "s": "x,y", "l": [0.1, 2.0]},
              {"a": 2, "c": float("nan"), "s": "q", "l": [1e-05]}],
    "int_gap": [{"n": 3, "m": 0.5}, {"m": 1.5}, {"n": 4, "m": float("nan")}],
    "ints_and_floats": [{"v": 1}, {"v": 2.5}, {"v": -3}],
    "strings_nan": [{"k": "C", "x": 1e30}, {"k": float("nan"), "x": -0.0}],
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_tables_write_and_read_as_pandas(tmp_path, case):
    """utils/tables.py's pandas layout, byte for byte on writing; read_table,
    mean, std and sort_rows against read_csv, Series.mean/std and a
    two-key sort_values."""
    from rule_guided_music_tpu_torch.utils import tables

    rows = TABLE_CASES[case]
    tables.write_table(str(tmp_path / "port.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    got, want = tables.read_table(str(tmp_path / "port.csv")), pd.read_csv(
        tmp_path / "pandas.csv")
    assert list(got) == list(want.columns)
    for col in want.columns:
        if pd.api.types.is_numeric_dtype(want[col]):
            np.testing.assert_array_equal(np.asarray(got[col], float),
                                          want[col].to_numpy(float))
            for ours, theirs in ((tables.mean(got[col]), want[col].mean()),
                                 (tables.std(got[col]), want[col].std())):
                np.testing.assert_allclose(ours, theirs, rtol=1e-12, equal_nan=True)
    keys = list(want.columns[:2])
    order = [tuple(r[k] for k in keys) for r in tables.sort_rows(
        tables.table_rows(got), keys)]
    expect = want.sort_values(by=keys)[keys].itertuples(index=False, name=None)
    assert [tuple(map(str, r)) for r in order] == [tuple(map(str, r)) for r in expect]
