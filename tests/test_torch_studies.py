"""The chord-divergence study in the port against
``scripts/chord_divergence_study.py`` on the CPU: the corpus is JAX's, bit
for bit; every tag array the study computes equals JAX's ``get_chords``
(and ``classify_keys``) on the same rolls, off rolls with a chord window
tied within TIE_RTOL (tests/test_torch_allrules_gate.py); the report's
numbers are the JAX script's; and the invariants of
tests/test_chord_divergence.py hold on the port.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rule_guided_music_tpu.rules import chord as jchord
from rule_guided_music_tpu_torch import chord_divergence_study as study
from rule_guided_music_tpu_torch.rules.chord import get_chords
from test_torch_allrules_gate import tied_rolls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TONICS = [48, 50, 53, 55]        # C, D, F, G, as tests/test_chord_divergence.py


def jax_study():
    spec = importlib.util.spec_from_file_location(
        "jax_chord_divergence_study",
        os.path.join(REPO, "scripts", "chord_divergence_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_study():
    return study.study(torch.device("cpu"))


@pytest.mark.parametrize("kw", [{}, {"offset": 48}, {"offset": 64},
                                {"sevenths": True}, {"passing": True, "seed": 1}])
def test_corpus_is_jaxs(kw):
    want = jax_study().corpus(**kw)
    got = study.corpus(**kw)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_tags_equal_jax_off_ties(port_study):
    """Every chord-tag array of the study (class 1 at each offset, class 2,
    the clean and ornamented corpora, both template sets) equals JAX's on
    every roll with no tied window; the key indices equal JAX's on all."""
    jget = jax.jit(jchord.get_chords, static_argnames=("templates",))
    keys_of = {}
    checked = 0
    for name, tags in port_study["tags"].items():
        if name.startswith("keys_"):
            continue
        rolls = port_study["rolls"][name]
        # every corpus call passes its own given keys: the 24 keys in order
        given = keys_of.setdefault(len(rolls), np.array(
            [t + 12 * m for t in range(12) for m in (0, 1) for _ in range(3)],
            np.int32))
        templates = "sevenths" if "sevenths" in name else "triads"
        want = np.asarray(jget(jnp.asarray(rolls), given_key=jnp.asarray(given),
                               templates=templates))
        clean = ~tied_rolls(rolls)
        np.testing.assert_array_equal(tags[clean], want[clean], err_msg=name)
        checked += int(clean.sum())
    # the corpus's chords ring in equal counts: 18% of its rolls tie a window
    assert checked > 0.75 * sum(len(r) for r in port_study["rolls"].values())
    for label, kw in study.KEY_CASES:
        rolls = study.corpus(**kw)[0]
        for mode, dis in (("raw", False), ("disambiguated", True)):
            want = np.asarray(jchord.classify_keys(jnp.asarray(rolls),
                                                   disambiguate_relative=dis)[0])
            np.testing.assert_array_equal(port_study["tags"][f"keys_{label}_{mode}"],
                                          want, err_msg=label)


def test_report_is_the_jax_scripts(port_study, capsys):
    jax_study().main()
    want = capsys.readouterr().out
    study.report(port_study)
    assert capsys.readouterr().out == want


def small_corpus(offset=0, sevenths=False, passing=False, seed=0, minor=False):
    rng = np.random.default_rng(seed)
    scale = study.MINOR_SCALE if minor else study.MAJOR_SCALE
    progs = study.MINOR_PROGS if minor else study.MAJOR_PROGS
    rolls, truths, keys = [], [], []
    for tonic in TONICS:
        for prog in progs:
            sev = {i for i, d in enumerate(prog) if d == 5} if sevenths else set()
            roll, truth = study.render(prog, tonic, scale, offset=offset,
                                       sevenths_on=sev, passing=passing, rng=rng)
            rolls.append(roll)
            truths.append(study.majority_truth(truth))
            keys.append(tonic % 12 + (12 if minor else 0))
    return (torch.as_tensor(np.stack(rolls)), np.stack(truths),
            torch.as_tensor(np.array(keys, dtype=np.int32)))


def tags(rolls, keys, templates="triads"):
    return get_chords(rolls, given_key=keys, templates=templates).numpy()


def test_no_boundary_flips_up_to_32_cols_triads():
    for off in (0, 16, 32):
        rolls, truth, keys = small_corpus(offset=off)
        t = tags(rolls, keys)
        assert ((t == truth) | (t == 0)).all(), off


def test_major_v7_windows_correct_under_both_template_sets():
    rolls, truth, keys = small_corpus(sevenths=True)
    v7 = truth == 5
    assert (tags(rolls, keys)[v7] == 5).all()
    assert (tags(rolls, keys, "sevenths")[v7] == 5).all()


def test_seventh_templates_fix_minor_v7_windows():
    rolls, truth, keys = small_corpus(sevenths=True, minor=True)
    v7 = truth == 5
    assert v7.any()
    assert (tags(rolls, keys)[v7] == 7).all()             # the documented mistag
    assert (tags(rolls, keys, "sevenths")[v7] == 5).all()


def test_template_sets_agree_on_clean_triads():
    rolls, truth, keys = small_corpus()
    np.testing.assert_array_equal(tags(rolls, keys), tags(rolls, keys, "sevenths"))
    np.testing.assert_array_equal(tags(rolls, keys), truth)


def test_passing_tones_do_not_flip_tags():
    rolls_c, _, keys = small_corpus()
    rolls_p, _, _ = small_corpus(passing=True, seed=1)
    np.testing.assert_array_equal(tags(rolls_c, keys), tags(rolls_p, keys))
