"""Plain reference of the three rules the benchmark's SCG cells score.

A frozen formulation of the pitch-class histogram, note density (vertical
and horizontal, 1.28 s windows) and the Roman-numeral chord tags
(Krumhansl-Kessler key finding with the relative major/minor re-vote,
triad templates per window), with their losses: mean squared error for
the first two, the share of differing tags for the chords. Rolls are
normalized (B, C, 128, L) in [-1, 1], background -1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MIN_PIANO, MAX_PIANO, OFF, THRESH = 21, 108, -1.0, -0.95


def piano_like(x):
    idx = torch.arange(x.shape[-2], device=x.device)
    keep = ((idx >= MIN_PIANO) & (idx <= MAX_PIANO)).reshape(-1, 1)
    return torch.where(keep, x, torch.full_like(x, OFF))


def fold12(x, axis):
    x = x.movedim(axis, -1)
    pad = (-x.shape[-1]) % 12
    x = F.pad(x, (0, pad)).reshape(x.shape[:-1] + (-1, 12)).sum(-2)
    return x.movedim(-1, axis)


def pitch_hist(roll):
    r = (piano_like(roll[:, 0]) + 1.0) / 2.0
    h = fold12(r.sum(-1), -1)
    return h / (h.sum(-1, keepdim=True) + 1e-12)


def active(roll):
    r = piano_like(roll)
    r = torch.where(r < THRESH, torch.full_like(r, OFF), r)
    return (((r + 1.0) / 2.0) >= 1e-2).float()


def note_density(roll, interval=128, horizontal_scale=5.0):
    b = active(roll[:, :1])
    n = b.shape[0]
    vert = b.sum(2)
    hor = (torch.diff(F.pad(b, (1, 1)), dim=-1).clamp(min=0).sum(2)[:, :, :-1] != 0).float()
    v = vert.reshape(n, 1, -1, interval).mean(-1)
    h = hor.reshape(n, 1, -1, interval).sum(-1) / horizontal_scale
    return torch.cat([v, h], -1)[:, 0]


_KK_MAJ = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_KK_MIN = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])
_PROFILES = np.stack([np.roll(_KK_MAJ, i) for i in range(12)]
                     + [np.roll(_KK_MIN, i) for i in range(12)])
_KEYIDX = np.array([10, 23, 0, 7, 18, 6, 11, 3, 16, 13, 2, 15,
                    19, 5, 4, 21, 8, 22, 9, 1, 12, 14, 17, 20])
_DEGREE = np.array([1, 2, 2, 3, 3, 4, 4, 5, 6, 6, 7, 7])
NO_KEY = 24


def _triads():
    t = np.zeros((36, 12))
    for root in range(12):
        for q, third in enumerate([4, 3, 3]):
            fifth = 7 if q < 2 else 6
            t[q * 12 + root, [root, (root + third) % 12, (root + fifth) % 12]] = 1.0
    return t


_TRIADS = _triads()


def _c(a, device, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype, device=device)


def _window_chroma(act, cols):
    w = act.shape[-1] // cols
    ch = fold12(act[..., :w * cols], 1)
    return ch.reshape(ch.shape[0], 12, w, cols).sum(-1).transpose(1, 2)


def _scores(chroma_w, table):
    t = _c(table, chroma_w.device)
    dots = torch.einsum("bwc,tc->bwt", chroma_w, t)
    return dots / torch.linalg.norm(t, dim=-1) / (torch.linalg.norm(chroma_w, dim=-1, keepdim=True) + 1e-12)


def _take(a, idx):
    return torch.gather(a, -1, idx[:, None])[:, 0]


def chord_progression(roll, fs=100, window=1.28):
    cols = int(round(window * fs))
    act = active(roll[:, 0])
    dev = roll.device
    chroma = fold12(act, 1).sum(-1)
    x = chroma[:, None] - chroma[:, None].mean(-1, keepdim=True)
    p = _c(_PROFILES, dev)[None]
    y = p - p.mean(-1, keepdim=True)
    corr = (x * y).sum(-1) / (torch.sqrt((x ** 2).sum(-1) * (y ** 2).sum(-1)) + 1e-12)
    best = torch.argmax(corr, -1)
    if act.shape[-1] >= cols:
        cw = _window_chroma(act, cols)
        tri = torch.argmax(_scores(cw, _TRIADS), -1)
        root, qual = tri % 12, tri // 12
        votable = (cw.sum(-1) >= 0.5) & ((cw > 0.5).sum(-1) >= 2)
        maj = torch.where(best < 12, best, (best + 3) % 12)
        mnr = (maj + 9) % 12
        n_maj = (votable & (qual == 0) & (root == maj[:, None])).sum(-1)
        n_min = (votable & (qual == 1) & (root == mnr[:, None])).sum(-1)
        first = torch.argmax(votable.int(), -1)
        ok, fr, fq = _take(votable, first), _take(root, first), _take(qual, first)
        s_maj = 2 * n_maj + (ok & (fr == maj) & (fq == 0)).long()
        s_min = 2 * n_min + (ok & (fr == mnr) & (fq == 1)).long()
        best = torch.where(s_min > s_maj, 12 + mnr, torch.where(s_maj > s_min, maj, best))
    key = _c(_KEYIDX, dev, torch.long)[best]
    key = torch.where(chroma.sum(-1) < 0.5, torch.full_like(key, NO_KEY), key)
    cw = _window_chroma(act, cols)
    root = torch.argmax(_scores(cw, _TRIADS), -1) % 12
    degree = _c(_DEGREE, dev, torch.long)[(root - (best % 12)[:, None]) % 12]
    empty = (cw.sum(-1) < 0.5) | (key == NO_KEY)[:, None]
    return torch.where(empty, torch.zeros_like(degree), degree).to(torch.int32)


RULES = {"pitch_hist": pitch_hist, "note_density": note_density,
         "chord_progression": chord_progression}


def loss(name, value, target):
    if name == "chord_progression":
        return (value != target).float().mean(-1)
    return ((value.float() - target.float()) ** 2).mean(-1)


def scores(rolls, targets, weights):
    """The SCG selection score of each roll: -sum_r w_r loss_r."""
    total = 0.0
    for name, target in targets.items():
        total = total - weights[name] * loss(name, RULES[name](rolls), target)
    return total
