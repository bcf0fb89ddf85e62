"""The data chain before training, in both frameworks on the CPU:
``prepare_data chunks`` and ``rearrange`` (MIDI -> uint8 npy chunks ->
sequences and the train/test and ``_cls_N`` manifests) write the same
bytes as ``scripts/prepare_data.py`` on the same MIDI files, and
``compute_std`` on that manifest and one production-VAE npz (JAX's
initialisation, written by ``flatten_tree``) prints the scale_factor of
``scripts/compute_std.py`` within 2e-2 relative: both encode in bf16
(JAX over float32 parameters, the port over bf16 ones), 2^-8 relative per
rounding through the encoder's ~40 layers (0.3% seen).
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rule_guided_music_tpu.models import AutoencoderKL as JaxVAE
from rule_guided_music_tpu.utils import logger as jlogger
from rule_guided_music_tpu.utils.fixtures import flatten_tree
from rule_guided_music_tpu_torch import compute_std, prepare_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PREP_FLAGS = ["--seq_chunks", "8", "--gap", "4", "--label", "1"]


def load_script(name):
    """A JAX script of ``scripts/`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_midis(root):
    """chip_smoke's seeded piano MIDI files (notes and sustain pedal), one
    moved to a subdirectory, and a corrupt one that both frameworks skip."""
    chip_smoke.write_midi_set(root, n=3, seconds=30.0)
    os.makedirs(os.path.join(root, "sub"))
    os.rename(os.path.join(root, "piece2.mid"), os.path.join(root, "sub", "piece2.mid"))
    with open(os.path.join(root, "broken.mid"), "wb") as f:
        f.write(b"MThd not a midi file")


def tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both frameworks' chunks, sequences and manifests, each written from
    its own working directory with the same relative paths."""
    tmp = tmp_path_factory.mktemp("prep")
    midi_dir = str(tmp / "midi")
    write_midis(midi_dir)
    jprep = load_script("prepare_data")
    cwd, argv = os.getcwd(), sys.argv
    try:
        for name in ("jax", "port"):
            os.makedirs(tmp / name)
            os.chdir(tmp / name)
            for args in (["chunks", "--midi_dir", midi_dir, "--chunk_dir", "chunks"],
                         ["rearrange", "--chunk_dir", "chunks", "--out_dir", "sequences",
                          "--csv_prefix", "data", *PREP_FLAGS]):
                if name == "jax":
                    sys.argv = ["prepare_data.py", *args]
                    jprep.main()
                else:
                    prepare_data.main(args)
    finally:
        os.chdir(cwd)
        sys.argv = argv
    return tmp


def test_prepare_data_writes_jaxs_bytes(prepared):
    jax_files, port_files = tree_bytes(prepared / "jax"), tree_bytes(prepared / "port")
    assert set(port_files) == set(jax_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    assert any(n.startswith("chunks/piece2_") for n in port_files)      # the subdir
    assert not any("broken" in n for n in port_files)                 # skipped
    train = port_files["data_train.csv"].decode().splitlines()
    assert train[0] == "midi_filename,classes" and len(train) > 8
    assert port_files["data_test_cls_1.csv"] == port_files["data_test.csv"]


def test_compute_std_matches_jax(prepared, tmp_path, monkeypatch, capsys):
    """The production KL-VAE (JAX-initialised, its npz written as
    ``flatten_tree`` writes the tree), two batches of one roll at one chunk,
    the port's manifest."""
    params = JaxVAE().init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 128, 128)),
                           rng=jax.random.PRNGKey(2))
    vae_path = str(tmp_path / "vae.npz")
    np.savez(vae_path, **flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                             params["params"])))
    manifest = str(prepared / "port" / "data_train.csv")
    monkeypatch.chdir(prepared / "port")
    flags = ["--data_dir", manifest, "--vae_path", vae_path, "--batch_size", "1",
             "--num_batches", "2", "--image_size", "128"]
    monkeypatch.setattr(sys, "argv", ["compute_std.py", *flags])
    # the JAX bundle logs through its global logger, which would keep this
    # test's captured stdout after it closes: the old logger comes back
    monkeypatch.setattr(jlogger.Logger, "CURRENT", jlogger.Logger.CURRENT)
    load_script("compute_std").main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = float(re.search(r"scale_factor = ([0-9.]+)", line).group(1))
    std, scale_factor = compute_std.main([*flags, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == f"latent std: {std:.4f}  ->  scale_factor = {scale_factor:.4f}"
    assert np.isfinite(scale_factor)
    assert scale_factor == pytest.approx(want, rel=2e-2)
