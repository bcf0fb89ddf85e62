"""The all-rules quality gate's rows in the port (the three serving
stacks' are in tests/test_torch_serving_gate.py).

``docs/allrules_gate_study.json`` records, for the chain of
``scripts/allrules_gate_study.py`` on quality_tiny (16 steps, B=4, weights
40/1/1, seeds 0-3), a weighted loss for each row: no SCG (``plain``,
``sde_plain`` on SDE-DPM-Solver++), SCG k=16 scored through the full
decoder (``full``, ``sde_full``), the light decoder (``light_dec``), the
rule-feature head (``feat``), or the head re-ranked by a decoder on its
top 4 (``feat_pre4_light``, ``feat_pre4_full``). The harness of
tests/test_torch_serving_gate.py replays each row in both frameworks: the
same pick at every step (``plain`` searches nowhere), and the weighted
loss of the port's result within 1% of the study's ``per_seed`` row.

The full decoder's candidates often tie two or three triads in a chord
window (C major, F major and A minor over a sustained C-E-F-G-A cluster).
The port takes the first triad of an exact tie; JAX normalises before its
float32 dot products, so its rounding takes any of them, and may reorder
triads whose scores differ by less than that rounding (ROADMAP 3.1). A
tied window also casts the vote that settles a relative major/minor key,
so a tie can move every tag of an excerpt. A tag off by one window moves
a candidate's score by 1/8 and the two chains part (step 4 of seed 0).
So the port's chain scores chord tags through :func:`jax_chord_ties`: on
every roll with no window tied within TIE_RTOL the port's tags must equal
JAX's, and the chain then takes JAX's tags; every other part of the chain
is the port's own.

Seed 0 of ``plain``, ``sde_plain`` and ``feat`` runs in tier 1 (10, 6
and 18 s on 8 cores, beside the 25 s fixture). The rest are in the same
parametrisation, marked slow: ``full`` decodes 64 candidates of 8 chunks
at each of 15 steps in both frameworks, about 9 minutes; ``light_dec``
took 310 s, ``feat_pre4_light`` 89 s, ``feat_pre4_full`` 185 s and
``sde_full`` 657 s (both decode through the ch=32 full decoder); and
seed 1 of every row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu_torch.rules import chord as tchord
from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT
from test_torch_serving_gate import check_gate_row, few_threads, jax_side  # noqa: F401

SLOW = pytest.mark.slow


# JAX's float32 rounding (~1e-7) can reorder triads whose exact scores
# lie closer than this, equal ones included
TIE_RTOL = 1e-6


def tied_rolls(rolls: np.ndarray, window=128) -> np.ndarray:
    """(B,) whether any chord window of a roll has two triads within
    TIE_RTOL of its best score (float64 scores of the port's active-note
    counts)."""
    active = tchord._active_notes(torch.as_tensor(rolls)).numpy().astype(np.float64)
    b, _, cols = active.shape
    counts = active[..., :cols // window * window].reshape(b, 128, -1, window).sum(-1)
    chroma = np.stack([counts[:, np.arange(128) % 12 == pc].sum(1) for pc in range(12)], -1)
    scores = chroma @ (tchord._TRIADS / np.linalg.norm(tchord._TRIADS, axis=1, keepdims=True)).T
    best = scores.max(-1, keepdims=True)
    ties = (scores >= best - TIE_RTOL * np.abs(best)).sum(-1) >= 2
    return (ties & (chroma.sum(-1) > 0.5)).any(-1)


def jax_chord_ties(monkeypatch):
    """The port's chord_progression, equal to JAX's on every roll without a
    tied window, returning JAX's tags."""
    port = FUNC_DICT["chord_progression"]

    def chord(rolls):
        ours = port(rolls).numpy()
        theirs = np.asarray(JFUNC["chord_progression"](jnp.asarray(rolls.numpy())))
        clean = ~tied_rolls(rolls.numpy())
        np.testing.assert_array_equal(ours[clean], theirs[clean])
        return torch.as_tensor(theirs).to(torch.int32)

    monkeypatch.setitem(FUNC_DICT, "chord_progression", chord)


@pytest.mark.parametrize("variant,seed", [
    ("plain", 0),
    ("sde_plain", 0),
    ("feat", 0),
    pytest.param("light_dec", 0, marks=SLOW),
    pytest.param("feat_pre4_light", 0, marks=SLOW),
    pytest.param("full", 0, marks=SLOW),
    pytest.param("feat_pre4_full", 0, marks=SLOW),
    pytest.param("sde_full", 0, marks=SLOW),
    *(pytest.param(v, 1, marks=SLOW) for v in (
        "plain", "full", "sde_plain", "feat", "light_dec", "feat_pre4_light",
        "feat_pre4_full", "sde_full")),
])
def test_allrules_gate_row_matches_jax_and_the_study(monkeypatch, jax_side,
                                                     variant, seed):
    check_gate_row(monkeypatch, jax_side, variant, seed,
                   port_patch=jax_chord_ties)
