"""The all-rules gate study's candidate regret in the port
(``allrules_gate_study``) against ``scripts/allrules_gate_study.py`` on the
CPU. Both studies run only the regret (``--variants ""``) at a tiny K and
B, the port on JAX's draws for each timestep and on the targets the JAX
study made (read from its ``np.tile``; the port's own differ in 2 of the
16 note_density entries: onsets of the reconstruction within rounding of
the roll threshold). The normalised
regrets agree within 1e-3 absolute: each is a difference of candidate
losses that agree to ~1e-6 relative, over a spread that can be as small
as the losses' own 1e-5.

The JAX study's chord tags are computed op by op inside its jit (a host
callback): the candidates' chord windows tie exactly, and XLA's fused
rounding under jit breaks those ties another way than its eager ops do
(ROADMAP 3.1), which moves the chord regret at K=2 by a whole tie (0.833
against 0.800 eager); ``jax_chord_ties`` gives the port the eager tags.
The JAX study writes under its ``REPO`` and the port to ``OUT_PATH``,
both pointed at a temporary directory.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu_torch import allrules_gate_study as study
from test_torch_allrules_gate import jax_chord_ties
from test_torch_serving_gate import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SHAPE, TINY_K = (1, 4, 128, 16), 2


def jax_study(monkeypatch, root):
    """The JAX study script as a module whose record goes under ``root``."""
    # the script sets a compilation cache directory at import
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(root / "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        "jax_allrules_gate_study", os.path.join(REPO, "scripts", "allrules_gate_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    os.makedirs(root / "docs")
    module.REPO = str(root)
    return module


def eager_jax_chords(monkeypatch):
    """JAX's chord_progression computed op by op even inside a jit (through
    a host callback)."""
    chords = JFUNC["chord_progression"]

    def chord(roll):
        return jax.pure_callback(lambda r: np.asarray(chords(jnp.asarray(r))),
                                 jax.eval_shape(chords, roll), roll)

    monkeypatch.setitem(JFUNC, "chord_progression", chord)


class TileRecorder:
    """numpy for the JAX study script, keeping what its ``np.tile`` makes:
    the three targets, in RULES order."""

    def __init__(self):
        self.tiles = []

    def __getattr__(self, name):
        return getattr(np, name)

    def tile(self, *args, **kw):
        self.tiles.append(np.tile(*args, **kw))
        return self.tiles[-1]


def test_regret_matches_jax(tmp_path, monkeypatch):
    jmod = jax_study(monkeypatch, tmp_path / "jax")
    for module in (jmod, study):
        monkeypatch.setattr(module, "SHAPE", TINY_SHAPE)
        monkeypatch.setattr(module, "K", TINY_K)
    monkeypatch.setattr("sys.argv", ["allrules_gate_study.py", "--variants", ""])
    eager_jax_chords(monkeypatch)
    recorder = TileRecorder()
    monkeypatch.setattr(jmod, "np", recorder)
    jmod.main()
    assert len(recorder.tiles) == len(study.RULES)
    with open(tmp_path / "jax" / "docs" / "allrules_gate_study.json") as f:
        want = json.load(f)

    def jax_draws(i, shape):
        k1, k2 = jax.random.split(jax.random.PRNGKey(100 + i))
        return (torch.as_tensor(np.array(jax.random.normal(k1, shape))),
                torch.as_tensor(np.array(jax.random.normal(k2, (TINY_K,) + shape))))

    monkeypatch.setattr(study, "OUT_PATH", str(tmp_path / "port.json"))
    jax_chord_ties(monkeypatch)
    build = study.build
    targets = {r: torch.as_tensor(t) for r, t in zip(study.RULES, recorder.tiles)}
    monkeypatch.setattr(study, "build", lambda device: {**build(device), "targets": targets})
    got = study.main(["--variants", "", "--device", "cpu"], regret_draws=jax_draws)
    assert set(got) == set(want)
    assert set(got["norm_regret"]) == set(want["norm_regret"]) == {"light_dec", "feat"}
    for tag, row in want["norm_regret"].items():
        assert set(got["norm_regret"][tag]) == set(row)
        for key, value in row.items():
            assert got["norm_regret"][tag][key] == pytest.approx(value, rel=0,
                                                                 abs=1e-3), (tag, key)
