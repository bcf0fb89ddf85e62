"""The port's evaluation modules (eval/mgeval.py, eval/remi.py, eval/fad.py)
against the JAX package's.

MIDI files are written once by the JAX package's writer from seeded
``make_rolls`` (plus an empty file and hand-made note lists) and read by
each package's own reader. Tolerances: every mgeval extractor within rtol
1e-12, ``evaluate_sets`` within 1e-10 on 8 against 8 files, ``write_report``
text equal; REMI events, vocabulary ids, chord labels and symbols equal;
the FAD proxy's synthesis, filterbank, embedding, Fréchet distance and
score within rtol 1e-9; the FAD gate's error text equal.
"""

import os

import numpy as np
import pytest

from rule_guided_music_tpu.data import midi_io as jmidi
from rule_guided_music_tpu.data.pianoroll import (
    finalize_decoded_sample as jfinalize,
    save_piano_roll_midi as jsave,
)
from rule_guided_music_tpu.eval import fad as jfad
from rule_guided_music_tpu.eval import mgeval as jmgeval
from rule_guided_music_tpu.eval import remi as jremi
from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch.data import midi_io as tmidi
from rule_guided_music_tpu_torch.eval import fad as tfad
from rule_guided_music_tpu_torch.eval import mgeval as tmgeval
from rule_guided_music_tpu_torch.eval import remi as tremi

# (velocity, pitch, start, end): a 4-note two-bar line with a note across
# the bar line, and a triad, then an A minor triad one window later
HAND_MADE = {
    "bars": [(80, 60, 0.0, 0.5), (80, 64, 0.5, 1.5), (80, 67, 2.0, 2.25),
             (80, 72, 2.25, 4.25)],
    "chords": [(80, p, 0.0, 1.0) for p in (60, 64, 67)]
    + [(80, p, 1.0, 2.0) for p in (57, 60, 64)],
}
# tests/test_eval.py's golden REMI fixture (120 bpm 4/4, bar 2.0 s)
GOLDEN = ([(100, 60, 0.0, 0.5), (80, 64, 0.0, 0.5), (64, 67, 0.0, 0.5)]
          + [(90, p, 2.0, 3.0) for p in (65, 68, 72)])
GOLDEN_EVENTS = [
    "Bar_0",
    "Position_0", "Pitch_60", "Velocity_25", "Duration_3",
    "Position_0", "Pitch_64", "Velocity_20", "Duration_3",
    "Position_0", "Pitch_67", "Velocity_16", "Duration_3",
    "Bar_1",
    "Position_0", "Pitch_65", "Velocity_22", "Duration_5",
    "Position_0", "Pitch_68", "Velocity_22", "Duration_5",
    "Position_0", "Pitch_72", "Velocity_22", "Duration_5",
]


def _write(path, notes):
    jmidi.write_midi(path, jmidi.MidiData(
        notes=[jmidi.Note(velocity=v, pitch=p, start=s, end=e)
               for v, p, s, e in notes]))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{'gen': 8 paths, 'ref': 8 paths, 'extra': the empty and hand-made
    files}, written by the JAX package."""
    root = tmp_path_factory.mktemp("eval_midi")
    out = {}
    for name, seed in (("gen", 3), ("ref", 4)):
        out[name] = jsave(jfinalize(make_rolls(8, seed=seed)), str(root / name), 100)
    out["extra"] = [_write(str(root / "empty.midi"), [])] + [
        _write(str(root / f"{k}.midi"), v) for k, v in HAND_MADE.items()]
    return out


def _both(path):
    return jmidi.read_midi(path), tmidi.read_midi(path)


def _all(files):
    return files["gen"] + files["ref"] + files["extra"]


FEATURE_CALLS = {
    **{name: (lambda n: lambda mod, m: mod.FEATURES[n](m))(name)
       for name in jmgeval.FEATURES},
    **{name: (lambda n: lambda mod, m: mod.BAR_EXTRACTORS[n](m))(name)
       for name in jmgeval.BAR_EXTRACTORS},
    **{f"{name}_norm{k}": (lambda n, k: lambda mod, m: getattr(mod, n)(
        m, normalize=k))(name, k)
       for name in ("pitch_class_transition_matrix",
                    "note_length_transition_matrix") for k in (0, 1, 2)},
    "note_length_hist_counts": lambda mod, m: mod.note_length_hist(
        m, normalize=False),
    "bar_used_pitch_1s": lambda mod, m: mod.bar_used_pitch(m, bar_seconds=1.0),
}


def test_feature_tables_match_jax():
    assert list(tmgeval.FEATURES) == list(jmgeval.FEATURES)
    assert list(tmgeval.BAR_EXTRACTORS) == list(jmgeval.BAR_EXTRACTORS)
    assert tmgeval.RUNNER_FEATURES == jmgeval.RUNNER_FEATURES
    assert tmgeval.ATTRIBUTE_ALIASES == jmgeval.ATTRIBUTE_ALIASES


@pytest.mark.parametrize("name", sorted(FEATURE_CALLS))
def test_extractor_matches_jax(files, name):
    call = FEATURE_CALLS[name]
    for path in _all(files):
        jm, tm = _both(path)
        want = np.asarray(call(jmgeval, jm), dtype=float)
        got = np.asarray(call(tmgeval, tm), dtype=float)
        assert got.shape == want.shape, (name, path)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=path)


def test_evaluate_sets_and_report_match_jax(files, tmp_path):
    want = jmgeval.evaluate_sets(files["gen"], files["ref"])
    got = tmgeval.evaluate_sets(files["gen"], files["ref"])
    assert list(got) == list(want)
    for feature, stats in want.items():
        assert list(got[feature]) == list(stats)
        for key, value in stats.items():
            np.testing.assert_allclose(got[feature][key], value, rtol=1e-10,
                                       atol=1e-10, err_msg=(feature, key))
    jmgeval.write_report(want, str(tmp_path / "jax.txt"))
    tmgeval.write_report(got, str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_evaluate_sets_extended_features_match_jax(files):
    """Every fixed-size extractor in evaluate_sets, on 4 against 4 files
    with the empty and hand-made ones among them."""
    gen = files["gen"][:2] + files["extra"][:2]
    ref = files["ref"][:2] + files["extra"][1:]
    want = jmgeval.evaluate_sets(gen, ref, features=list(jmgeval.FEATURES))
    got = tmgeval.evaluate_sets(gen, ref, features=list(tmgeval.FEATURES))
    for feature, stats in want.items():
        for key, value in stats.items():
            np.testing.assert_allclose(got[feature][key], value, rtol=1e-10,
                                       atol=1e-10, err_msg=(feature, key))


@pytest.mark.parametrize("fn", ["c_dist", "kl_dist", "overlap_area"])
def test_distance_functions_match_jax(fn):
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(40, 3)), rng.normal(1.0, 2.0, size=(30, 3))
    if fn == "c_dist":
        args = (a[0], b)
    else:
        args = (a[:, 0], b[:, 1])
    np.testing.assert_allclose(getattr(tmgeval, fn)(*args),
                               getattr(jmgeval, fn)(*args), rtol=1e-12)
    if fn != "c_dist":   # a constant set: both return 0
        assert getattr(tmgeval, fn)(np.ones(5), b[:, 0]) == \
            getattr(jmgeval, fn)(np.ones(5), b[:, 0]) == 0.0


def _remi_outputs(mod, midi):
    events = mod.midi_to_events(midi)
    vocab = mod.Vocab()
    ids = vocab.encode(events)
    rebuilt = mod.events_to_midi(events)
    labels = mod.recognize_chords(midi)
    return dict(
        events=[str(e) for e in events], ids=ids, vocab_len=len(vocab),
        decoded=[str(e) for e in vocab.decode(ids + [0, 1, 2])],
        rebuilt=[(n.velocity, n.pitch, n.start, n.end) for n in rebuilt.notes],
        labels=labels, symbols=mod.chord_symbols(labels),
        labels_1s=mod.recognize_chords(midi, window_seconds=1.0,
                                       total_seconds=12.0),
        quantized=([mod.quantize_velocity(v) for v in range(128)],
                   [mod.quantize_duration(p) for p in np.linspace(0, 80, 161)]))


def test_remi_matches_jax(files):
    for path in _all(files):
        jm, tm = _both(path)
        assert _remi_outputs(tremi, tm) == _remi_outputs(jremi, jm), path


def test_remi_golden_fixture_matches_jax():
    """tests/test_eval.py's hand-computed stream and chord labels, in both
    packages."""
    outs = {}
    for mod, midi_mod in ((jremi, jmidi), (tremi, tmidi)):
        midi = midi_mod.MidiData(notes=[midi_mod.Note(velocity=v, pitch=p, start=s,
                                                      end=e) for v, p, s, e in GOLDEN])
        outs[mod.__name__] = _remi_outputs(mod, midi)
        assert outs[mod.__name__]["events"] == GOLDEN_EVENTS
        assert outs[mod.__name__]["labels"] == [("maj", 0), ("N", -1), ("min", 5)]
        assert outs[mod.__name__]["symbols"] == ["C:maj", "N", "F:min"]
    assert outs[tremi.__name__] == outs[jremi.__name__]


def test_fad_proxy_parts_match_jax(files):
    for path in files["gen"][:2] + files["extra"]:
        jm, tm = _both(path)
        want = jfad.synth_midi(jm)
        got = tfad.synth_midi(tm)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        np.testing.assert_allclose(tfad.logmel_embedding(got),
                                   jfad.logmel_embedding(want), rtol=1e-9)
    np.testing.assert_allclose(tfad._mel_filterbank(16000, 1024, 64),
                               jfad._mel_filterbank(16000, 1024, 64), rtol=1e-9)
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(12, 6)), rng.normal(0.5, 1.5, size=(12, 6))
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0), np.cov(y, rowvar=False))
    np.testing.assert_allclose(tfad.frechet_distance(*args),
                               jfad.frechet_distance(*args), rtol=1e-9)


def test_fad_proxy_score_matches_jax(files):
    gen, ref = files["gen"][:4], files["ref"][:4]
    want = jfad.compute_fad_proxy(ref, gen)
    np.testing.assert_allclose(tfad.compute_fad_proxy(ref, gen), want, rtol=1e-9)
    assert want > 0 and tfad.compute_fad_proxy(gen, gen) == pytest.approx(0.0, abs=1e-3)


def test_fad_gate_raises_the_same_error(tmp_path):
    """Without frechet_audio_distance (not installed here), both packages'
    compute_fad raise the gate's RuntimeError with the same text; _require
    does the same for any missing module; midi_dir_to_wav fails alike
    without fluidsynth."""
    errors = []
    for mod in (jfad, tfad):
        with pytest.raises(RuntimeError) as gate:
            mod.compute_fad(str(tmp_path), str(tmp_path))
        with pytest.raises(RuntimeError) as missing:
            mod._require("a_module_that_is_not_installed")
        errors.append((str(gate.value), str(missing.value)))
    assert errors[0] == errors[1]
    assert "FAD evaluation needs 'frechet_audio_distance'" in errors[0][0]
    _write(str(tmp_path / "one.midi"), HAND_MADE["bars"])
    outcomes = []
    for mod in (jfad, tfad):
        try:
            mod.midi_dir_to_wav(str(tmp_path), str(tmp_path / "wav"), "none.sf2")
            outcomes.append(None)
        except Exception as e:   # the same failure in both, whatever it is
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]


def test_port_eval_reads_through_the_port():
    """The copies read MIDI through the port's reader, not the JAX one."""
    assert tmgeval.read_midi is tmidi.read_midi
    assert os.path.dirname(tmgeval.__file__).endswith(
        os.path.join("rule_guided_music_tpu_torch", "eval"))
