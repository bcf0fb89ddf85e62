"""The port's test-set loader, MIDI rasteriser and ``--data_dir`` CLI
against the JAX package (CPU).

The same manifests of ``.npy`` rolls written to ``tmp_path`` go through
``load_data`` of both packages; the batches must be identical (no
tolerance: the same numpy arithmetic on the same draws). The JAX package
sends uint8 rolls through its C++ augmenter, the port through the numpy
path that the JAX package's own tests hold equal to it.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.data import datasets as jdatasets
from rule_guided_music_tpu.data import pianoroll as jpianoroll
from rule_guided_music_tpu.data.midi_io import read_midi as jread_midi
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu_torch import sample_rule
from rule_guided_music_tpu_torch.data import datasets as tdatasets
from rule_guided_music_tpu_torch.data import pianoroll as tpianoroll
from rule_guided_music_tpu_torch.data.midi_io import (ControlChange, MidiData,
                                                      Note, read_midi, write_midi)

from test_torch_edit import _write_test_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_tiny.npz")
CONFIGS = os.path.join(REPO, "scripts", "configs")
TINY_VAE_ARCH = '{"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}'


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on one machine; torch's default of a
    thread per core makes the conv-heavy chains here contend badly there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_manifest(tmp_path, dtype, n=5, seed=0):
    """``n`` rolls of 1000-1300 columns (shorter and longer than an
    excerpt): random notes, onsets and pedal in [0, 127], saved as
    ``dtype``."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        cols = int(rng.integers(1000, 1300))
        roll = np.zeros((3, 128, cols), dtype=np.float32)
        for _ in range(40):
            p, s = int(rng.integers(21, 109)), int(rng.integers(0, cols - 40))
            d = int(rng.integers(5, 40))
            roll[0, p, s:s + d] = rng.integers(20, 127)
            roll[1, p, s] = 127
        roll[2, 21:109, rng.integers(0, cols, 8)] = 72
        path = tmp_path / f"roll{i}.npy"
        np.save(path, roll.astype(dtype))
        paths.append(str(path))
    manifest = tmp_path / f"test_{np.dtype(dtype).name}.csv"
    with open(manifest, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["midi_filename", "classes"])
        for i, p in enumerate(paths):
            writer.writerow([p, i % 3])
    return str(manifest), paths


def test_load_manifest_matches_jax(tmp_path):
    manifest, paths = write_manifest(tmp_path, np.uint8)
    assert tdatasets.load_manifest(manifest) == jdatasets.load_manifest(manifest)
    assert tdatasets.load_manifest(manifest)[0] == paths


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_load_data_batches_identical_to_jax(tmp_path, dtype, deterministic, seed):
    """Three batches of 2 (the third wraps into a second epoch, so a
    reshuffle) with the same manifest, seed and flags: the same rolls and
    labels, bit for bit."""
    manifest, _ = write_manifest(tmp_path, dtype, seed=seed + 3)
    kw = dict(data_dir=manifest, batch_size=2, class_cond=True,
              deterministic=deterministic, image_size=1024, seed=seed)
    port = tdatasets.load_data(**kw)
    ref = jdatasets.load_data(**kw, prefetch=0)
    for _ in range(3):
        (tx, tc), (jx, jc) = next(port), next(ref)
        assert tx.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tc["y"], jc["y"])


def test_dataset_refuses_rule_labels(tmp_path):
    manifest, _ = write_manifest(tmp_path, np.uint8, n=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(tdatasets.load_data(data_dir=manifest, batch_size=1,
                                 rule="note_density"))


@pytest.mark.parametrize("seed", [0, 5])
def test_augmentation_pieces_match_jax(seed):
    rng = np.random.default_rng(seed)
    arr = rng.uniform(-1, 1, (3, 128, 1100)).astype(np.float32)
    for size in (1024, 1200):
        a = tdatasets.time_stretch(arr.copy(), size, np.random.default_rng(seed))
        b = jdatasets.time_stretch(arr.copy(), size, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
    for k in (-6, -1, 0, 3):
        np.testing.assert_array_equal(tdatasets.key_shift(arr.copy(), k),
                                      jdatasets.key_shift(arr.copy(), k))


def _midi(seed):
    """Notes (overlapping ones too) and a sustain pedal with a 0 -> 127
    flip inside one column."""
    rng = np.random.default_rng(seed)
    notes = []
    for _ in range(30):
        s = float(rng.uniform(0, 8))
        notes.append(Note(velocity=int(rng.integers(1, 128)),
                          pitch=int(rng.integers(21, 109)), start=s,
                          end=s + float(rng.uniform(0.05, 1.5))))
    ccs = [ControlChange(number=64, value=int(v), time=float(t))
           for t, v in ((0.5, 100), (1.0, 0), (1.004, 127), (3.0, 40),
                        (6.0, 0))]
    return MidiData(notes=notes, control_changes=ccs)


@pytest.mark.parametrize("seed", [0, 1])
def test_midi_to_roll_matches_jax(tmp_path, seed):
    """A MIDI file written by the port's ``write_midi``, read by each
    package's reader and rasterized by each package's ``midi_to_roll``
    (the JAX one with its C++ rasteriser where it builds)."""
    path = str(tmp_path / "source.mid")
    write_midi(path, _midi(seed))
    got = tpianoroll.midi_to_roll(read_midi(path), fs=100)
    want = jpianoroll.midi_to_roll(jread_midi(path), fs=100)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for length in (256, 1500):
        np.testing.assert_array_equal(
            tpianoroll.midi_to_roll(read_midi(path), fs=100, length=length),
            jpianoroll.midi_to_roll(jread_midi(path), fs=100, length=length))


def test_quantize_pedal_matches_jax():
    assert [tpianoroll.quantize_pedal(v) for v in range(128)] == \
        [jpianoroll.quantize_pedal(v) for v in range(128)]
    with pytest.raises(ValueError):
        tpianoroll.quantize_pedal(128)


@pytest.mark.parametrize("yml", [
    os.path.join("single", "dps_rule", "pitch.yml"),
    os.path.join("all", "scg_classifier_all.yml")])
def test_cli_takes_test_set_targets(tmp_path, yml):
    """``--data_dir`` on a Null-target YAML: the targets are the rules of
    the JAX loader's first batch of ``<prefix>_test_cls_1.csv`` (drawn
    with the same seed), and the CLI writes its result files; a DPS YAML
    runs its value cond_fn on the way."""
    prefix = _write_test_set(tmp_path)
    out = tmp_path / "out"
    rows = sample_rule.main([
        "--config_path", os.path.join(CONFIGS, "cond_table", yml),
        "--data_dir", prefix, "--model", "DiTRotary_XS_8", "--num_classes", "0",
        "--class_cond", "True",
        "--model_path", FIXTURE, "--vae_path", FIXTURE, "--vae_arch", TINY_VAE_ARCH,
        "--batch_size", "2", "--num_samples", "2", "--timestep_respacing", "3",
        "--device", "cpu", "--dtype", "float32", "--out_dir", str(out)])
    gt, _ = next(jdatasets.load_data(data_dir=prefix + "_test_cls_1.csv", batch_size=2,
                            class_cond=True, image_size=1024, prefetch=0))
    names = [c[:-len(".target_rule")] for c in rows[0] if c.endswith(".target_rule")]
    assert names
    for name in names:
        want = np.asarray(JFUNC[name](jnp.asarray(gt)))
        got = np.array([r[f"{name}.target_rule"] for r in rows])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    assert {"results.csv", "summary.csv"} <= set(os.listdir(out))
    with open(out / "results.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
