"""Quantify the chord analyzer's divergence classes on realistic material.

    python -m rule_guided_music_tpu_torch.chord_divergence_study [--device cuda]

Counterpart of ``scripts/chord_divergence_study.py``: the same corpus
(voice-led diatonic progressions in all 24 keys, 2 windows per chord,
with seventh-chord and passing-tone variants, phase offsets 0-64 columns)
through the port's ``rules/chord.get_chords`` on ``--device``, under
``templates="triads"`` and ``"sevenths"``:

  class 1 — window-boundary tagging: the tag-flip rate against the
      majority-occupancy truth as the progression's phase slides across
      the window (offset 64 is an exact half-window tie);
  class 2 — seventh chords: the tag distribution on V7 windows under each
      template set, and the flips the seventh templates cause on clean
      triads;
  class 4 — passing tones: the flips ornaments cause, and the ornamented
      accuracy;
  key detection (class 3): major / natural-minor accuracy, raw
      Krumhansl-Schmuckler against the relative-pair disambiguation.

The corpus builders (``triad``, ``voice``, ``render``, ``majority_truth``,
``corpus``) are numpy, the port's own copy. ``study`` returns the numbers
and every tag array it computed; ``main`` prints the JAX script's report.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

from . import pipeline
from .rules.chord import _MAJOR_PC2KEY, _MINOR_PC2KEY, classify_keys, get_chords

MAJOR_SCALE = [0, 2, 4, 5, 7, 9, 11]
MINOR_SCALE = [0, 2, 3, 5, 7, 8, 10]          # natural minor

# progressions as scale degrees (1-based)
MAJOR_PROGS = [[1, 4, 5, 1], [1, 6, 2, 5], [1, 5, 6, 4]]
MINOR_PROGS = [[1, 4, 5, 1], [1, 6, 3, 7], [1, 7, 6, 5]]

WINDOW = 128                                   # 1.28 s at fs=100
ONSET = 1.0
SUSTAIN = 0.5
BG = -1.0
OFFSETS = (0, 8, 16, 32, 48, 56, 64)
TEMPLATES = ("triads", "sevenths")
KEY_CASES = (("clean", {}), ("clean off=48", {"offset": 48}),
             ("clean off=64 (degenerate tie)", {"offset": 64}),
             ("sevenths", {"sevenths": True}),
             ("ornamented", {"passing": True, "seed": 1}))


def triad(scale, degree, seventh=False):
    """Stacked-thirds chord pitch classes for a 1-based scale degree."""
    idx = degree - 1
    pcs = [scale[idx % 7], scale[(idx + 2) % 7], scale[(idx + 4) % 7]]
    if seventh:
        pcs.append(scale[(idx + 6) % 7])
    return pcs


def voice(pcs, tonic, register=60, prev=None):
    """Voice-led absolute pitches: nearest realization to the previous
    chord's mean pitch."""
    center = np.mean(prev) if prev is not None else register
    out = []
    for pc in pcs:
        p = tonic + pc + 12 * round((center - (tonic + pc)) / 12)
        out.append(int(np.clip(p, 24, 102)))
    return sorted(set(out))


def render(chord_seq, tonic, scale, *, cols_per_chord=2 * WINDOW,
           length=8 * WINDOW, offset=0, sevenths_on=(), passing=False,
           rng=None):
    """(3, 128, length) roll of a voiced progression; chord i starts at
    offset + i*cols_per_chord. ``sevenths_on``: degree positions rendered
    with an added seventh."""
    roll = np.full((3, 128, length), BG, dtype=np.float32)
    prev = None
    t = offset
    truth = []                                 # (start, end, degree)
    repeats = length // (cols_per_chord * len(chord_seq)) + 1
    for i, deg in enumerate(chord_seq * repeats):
        if t >= length:
            break
        pcs = triad(scale, deg, seventh=(i % len(chord_seq)) in sevenths_on)
        pitches = voice(pcs, tonic, prev=prev)
        prev = pitches
        end = min(t + cols_per_chord, length)
        for p in pitches:
            roll[0, p, t:end] = SUSTAIN
            roll[1, p, t] = ONSET
        if passing and rng is not None and end - t > 32:
            # scale-step run in the segment's last 16 columns, one voice
            base = pitches[-1]
            for j, step in enumerate(rng.choice([1, 2], size=2)):
                col = end - 16 + 8 * j
                p = int(np.clip(base + int(step), 24, 102))
                roll[0, p, col:col + 8] = SUSTAIN
                roll[1, p, col] = ONSET
        truth.append((t, end, deg))
        t = end
    return roll, truth


def majority_truth(truth, length=8 * WINDOW):
    """Ground-truth degree per window = chord occupying most columns."""
    out = []
    for w in range(length // WINDOW):
        lo, hi = w * WINDOW, (w + 1) * WINDOW
        occupancy = defaultdict(int)
        for (s, e, d) in truth:
            occupancy[d] += max(0, min(e, hi) - max(s, lo))
        out.append(max(occupancy.items(), key=lambda kv: kv[1])[0])
    return np.array(out)


def corpus(offset=0, sevenths=False, passing=False, seed=0):
    """(rolls (72, 3, 128, 1024) float32, truths (72, 8), given keys (72,)
    int32) over all 24 keys x 3 progressions, numpy."""
    rng = np.random.default_rng(seed)
    rolls, truths, keys = [], [], []
    for tonic in range(12):
        for minor, scale, progs in [(0, MAJOR_SCALE, MAJOR_PROGS),
                                    (1, MINOR_SCALE, MINOR_PROGS)]:
            for prog in progs:
                sev = {i for i, d in enumerate(prog) if d == 5} \
                    if sevenths else set()
                roll, truth = render(
                    prog, tonic + 48, scale, offset=offset,
                    sevenths_on=sev, passing=passing, rng=rng)
                rolls.append(roll)
                truths.append(majority_truth(truth))
                keys.append(tonic + 12 * minor)
    return np.stack(rolls), np.stack(truths), np.array(keys, dtype=np.int32)


def _tags(rolls, keys, templates, device) -> np.ndarray:
    return get_chords(torch.as_tensor(rolls, device=device),
                      given_key=torch.as_tensor(keys, device=device),
                      templates=templates).cpu().numpy()


def key_accuracy(rolls, keys, disambiguate: bool, device):
    """(major accuracy, minor accuracy) of ``classify_keys`` on the corpus,
    and its key indices."""
    key_idx, _, _ = classify_keys(torch.as_tensor(rolls, device=device),
                                  disambiguate_relative=disambiguate)
    expect = np.array([(_MAJOR_PC2KEY if k < 12 else _MINOR_PC2KEY)[int(k) % 12]
                       for k in keys])
    got = key_idx.cpu().numpy()
    minor = keys >= 12
    return ((float((got[~minor] == expect[~minor]).mean()),
             float((got[minor] == expect[minor]).mean())), got)


def study(device) -> dict:
    """Every number of the report, and ``tags``: each chord-tag array
    computed, by name, with the rolls it came from under ``rolls``."""
    tags, rolls_of, out = {}, {}, {"class1": {}, "class2": {}, "class4": {},
                                  "keys": {}}

    def run(name, rolls, keys, templates):
        tags[name] = _tags(rolls, keys, templates, device)
        rolls_of[name] = rolls
        return tags[name]

    for templates in TEMPLATES:
        rates = []
        for off in OFFSETS:
            rolls, truth, keys = corpus(offset=off)
            t = run(f"class1_{templates}_off{off}", rolls, keys, templates)
            # windows the offset leaves silent (tag 0) are not counted
            valid = t != 0
            rates.append((off, float(((t != truth) & valid).sum()
                                     / max(valid.sum(), 1))))
        out["class1"][templates] = rates

    rolls, truth, keys = corpus(sevenths=True)
    v7_mask = truth == 5
    for templates in TEMPLATES:
        v7 = run(f"class2_{templates}", rolls, keys, templates)[v7_mask]
        out["class2"][templates] = {int(d): round(float((v7 == d).mean()), 3)
                                    for d in sorted(set(v7.tolist()))}
    rolls_c, truth_c, keys_c = corpus(sevenths=False)
    t_tri = run("clean_triads", rolls_c, keys_c, "triads")
    t_sev = run("clean_sevenths", rolls_c, keys_c, "sevenths")
    out["class2"]["clean"] = dict(flip=float((t_tri != t_sev).mean()),
                                  acc_triads=float((t_tri == truth_c).mean()),
                                  acc_sevenths=float((t_sev == truth_c).mean()))

    rolls_p, truth_p, keys_p = corpus(passing=True, seed=1)
    for templates in TEMPLATES:
        t_clean = tags[f"clean_{templates}"]
        t_orn = run(f"ornamented_{templates}", rolls_p, keys_p, templates)
        out["class4"][templates] = dict(
            flip=float((t_clean != t_orn).mean()),
            acc=float((t_orn == truth_p).mean()))

    for label, kw in KEY_CASES:
        rolls, _, keys = corpus(**kw)
        (raw, raw_idx), (fix, fix_idx) = (key_accuracy(rolls, keys, d, device)
                                          for d in (False, True))
        out["keys"][label] = dict(raw=raw, disambiguated=fix)
        tags[f"keys_{label}_raw"], tags[f"keys_{label}_disambiguated"] = raw_idx, fix_idx
    out["tags"], out["rolls"] = tags, rolls_of
    return out


def report(out: dict) -> None:
    print("=== chord divergence study (24 keys x 3 progressions each) ===")
    print("\nclass 1 — tag-flip rate vs majority truth, by window offset")
    print("(given_key supplied; flips measure window tagging only)")
    for templates in TEMPLATES:
        print(f"  templates={templates}: " + ", ".join(
            f"off={o}: {r:.3f}" for o, r in out["class1"][templates]))
    print("\nclass 2 — V7 windows (degree-5 chords rendered with sevenths)")
    for templates in TEMPLATES:
        print(f"  templates={templates}: tag distribution on V7 windows "
              f"{out['class2'][templates]} (correct=5)")
    c = out["class2"]["clean"]
    print(f"  clean-triad corpus: triads-vs-sevenths flip rate {c['flip']:.3f} "
          f"(accuracy triads {c['acc_triads']:.3f}, sevenths "
          f"{c['acc_sevenths']:.3f})")
    print("\nclass 4 — passing tones (ornamented vs clean rendering)")
    for templates in TEMPLATES:
        c = out["class4"][templates]
        print(f"  templates={templates}: ornament flip rate {c['flip']:.3f}, "
              f"ornamented accuracy {c['acc']:.3f}")
    print("\nkey detection accuracy (major / natural-minor), raw KK vs "
          "relative-pair disambiguation (classify_keys default):")
    for label, _ in KEY_CASES:
        raw, fix = out["keys"][label]["raw"], out["keys"][label]["disambiguated"]
        print(f"  {label:30s} raw {raw[0]:.3f}/{raw[1]:.3f} -> "
              f"disambiguated {fix[0]:.3f}/{fix[1]:.3f}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out = study(pipeline.resolve_device(args.device))
    report(out)
    return out


if __name__ == "__main__":
    main()
