"""Port rule programs against the JAX package's.

Integer outputs (chord tags, key indices, note-density classes) must be
exactly equal, on tests/test_chord_golden.py's progressions and on the
synthetic ``make_rolls`` textures; float rule values agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_chord_golden as golden
from rule_guided_music_tpu.rules import chord as jchord
from rule_guided_music_tpu.rules.registry import FUNC_DICT as JFUNC
from rule_guided_music_tpu.rules.registry import LOSS_DICT as JLOSS
from rule_guided_music_tpu.utils.fixtures import make_rolls
from rule_guided_music_tpu_torch.rules import chord as tchord
from rule_guided_music_tpu_torch.rules.registry import FUNC_DICT, LOSS_DICT


def _golden_rolls():
    rolls = []
    for tonic_pc in range(12):
        rolls.append(golden.make_roll(golden.major_progression(60 + tonic_pc)))
        rolls.append(golden.make_roll(golden.minor_progression(57 + tonic_pc)))
    walk = [golden.major_triad(60, s) for s in (0, 2, 4, 5, 7, 9, 11, 0)]
    rolls.append(golden.make_roll(walk)[..., :512])
    rolls.append(golden.make_roll([[], [60, 64, 67], [], [65, 69, 72]]))
    rolls.append(golden.make_roll([[], [], [], []]))
    rolls.append(golden.make_roll([[60, 64, 67, 70], [65, 69, 72], [67, 71, 74, 77],
                                   [60, 64, 67]]))
    return np.concatenate([np.array(r) for r in rolls], axis=0)


@pytest.mark.parametrize("templates", ["triads", "sevenths"])
def test_chords_and_keys_match_jax_on_golden_rolls(templates):
    rolls = _golden_rolls()
    jtags, jkey, jcorr = jchord.get_chords(jnp.asarray(rolls), return_key=True,
                                           templates=templates)
    ttags, tkey, tcorr = tchord.get_chords(torch.as_tensor(rolls),
                                           return_key=True, templates=templates)
    assert ttags.dtype == torch.int32
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    np.testing.assert_allclose(tcorr.numpy(), np.asarray(jcorr), rtol=1e-6, atol=1e-6)


def test_given_key_matches_jax():
    rolls = _golden_rolls()[:6]
    for given in (0, 9 + 12):
        np.testing.assert_array_equal(
            tchord.get_chords(torch.as_tensor(rolls), given_key=given).numpy(),
            np.asarray(jchord.get_chords(jnp.asarray(rolls), given_key=given)))


@pytest.mark.parametrize("name", sorted(JFUNC))
def test_registry_rule_matches_jax(name):
    rolls = make_rolls(3, seed=2)
    # a decoded-looking roll: noise around the background threshold
    noisy = np.clip(rolls + np.random.default_rng(3).normal(0, 0.05, rolls.shape)
                    .astype(np.float32), -1, 1)
    for x in (rolls, noisy):
        ref = np.asarray(JFUNC[name](jnp.asarray(x)))
        out = FUNC_DICT[name](torch.as_tensor(x)).numpy()
        assert out.shape == ref.shape
        if name.startswith("chord"):
            fs = 12.5 if name.endswith("pixel") else 100
            _assert_tags_equal_up_to_exact_ties(x, out, ref, fs)
        elif np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        target = np.roll(ref, 1, axis=0)
        np.testing.assert_allclose(
            LOSS_DICT[name](torch.as_tensor(out), torch.as_tensor(target)).numpy(),
            np.asarray(JLOSS[name](jnp.asarray(out), jnp.asarray(target))),
            rtol=1e-5, atol=1e-6)


def _assert_tags_equal_up_to_exact_ties(rolls, out, ref, fs, window=1.28):
    """Tags equal, except in windows whose best triads tie in exact
    arithmetic: there the port takes the first tied triad (documented
    tie-break) while JAX's float rounding may pick another of them."""
    mismatches = np.argwhere(out != ref)
    if not len(mismatches):
        return
    rolls_t = torch.as_tensor(rolls)
    active = tchord._active_notes(rolls_t).numpy().astype(np.float64)
    tonic = tchord.classify_keys(rolls_t, fs=fs)[2].numpy() % 12
    cols = int(round(window * fs))
    triads = tchord._TRIADS
    for b, w in mismatches:
        counts = active[b, :, w * cols:(w + 1) * cols].sum(axis=-1)
        chroma = np.bincount(np.arange(128) % 12, weights=counts, minlength=12)
        scores = triads @ chroma / np.linalg.norm(triads, axis=1)
        tied = np.flatnonzero(scores == scores.max())
        assert len(tied) >= 2, f"tag mismatch at {(b, w)} outside an exact tie"
        tags = tchord._SEMITONE2DEGREE[(tied % 12 - tonic[b]) % 12]
        assert out[b, w] == tags[0] and ref[b, w] in tags[1:]


def test_argmax_ties_break_to_the_first_index():
    """A lone note ties every triad containing it; both frameworks pick the
    first row, so the tag (and the key vote) agree."""
    roll = np.array(golden.make_roll([[60], [64], [60, 64], []]))
    np.testing.assert_array_equal(
        tchord.get_chords(torch.as_tensor(roll)).numpy(),
        np.asarray(jchord.get_chords(jnp.asarray(roll))))
    assert LOSS_DICT.keys() == JLOSS.keys() and FUNC_DICT.keys() == JFUNC.keys()
