"""The all-rules gate study in the port (``allrules_gate_study``) against
its committed record ``docs/allrules_gate_study.json``, on the CPU:
``plain`` seed 0, fed the draws of ``sample_loop(PRNGKey(0), ...)``
(tests/test_torch_serving_gate.py's ``jax_replay_noise``) and scoring
chord tags through ``jax_chord_ties`` (ROADMAP 3.1), is within 1% of the
record's ``per_seed`` row, and the JSON has the record's schema. The
regret is held against the JAX study in test_torch_gate_regret.py.

The port writes to ``allrules_gate_study.OUT_PATH``, pointed at a
temporary directory here, so no run touches the committed record.
"""

import json

from rule_guided_music_tpu_torch import allrules_gate_study as study
from test_torch_allrules_gate import jax_chord_ties
from test_torch_serving_gate import STUDY, few_threads, jax_replay_noise  # noqa: F401


def test_plain_row_on_jaxs_draws_matches_the_record(tmp_path, monkeypatch):
    monkeypatch.setattr(study, "OUT_PATH", str(tmp_path / "study.json"))
    jax_chord_ties(monkeypatch)
    out = study.main(["--variants", "plain", "--skip_regret", "--device", "cpu"],
                     seeds=(0,), noise_fn_for=lambda s: jax_replay_noise(s, study.STEPS))
    with open(STUDY) as f:
        record = json.load(f)
    with open(study.OUT_PATH) as f:
        assert json.load(f) == out
    assert set(out) == set(record)
    assert set(out["per_seed"]["plain"]["0"]) == set(record["per_seed"]["plain"]["0"])
    assert set(out["final_losses"]["plain"]) == set(record["final_losses"]["plain"])
    assert out["k"] == record["k"] and out["weights"] == record["weights"]
    assert out["seeds_per_variant"] == {"plain": [0]} and out["norm_regret"] == {}
    got = out["per_seed"]["plain"]["0"]["weighted"]
    want = record["per_seed"]["plain"]["0"]["weighted"]
    assert abs(got - want) <= 0.01 * abs(want), (got, want)
