"""Rule-feature head: SCG rule features predicted straight from latents.

Port of ``rule_guided_music_tpu/models/scoring_head.py::RuleFeatureHead``.
A small conv trunk over the x̂0 latent predicts each rule's feature in the
output contract of ``rules.registry.FUNC_DICT``, so SCG can rank its k
candidates with no VAE decode:

  * ``pitch_hist``        -> (B, 12) normalised histogram (softmax),
  * ``note_density``      -> (B, 2*w) positive floats, vertical then
                             horizontal (softplus),
  * ``chord_progression`` -> (B, w) int tags in [0, 8), the argmax of
                             per-window chord-tag logits.

It only ranks candidates; the trajectory and the final decode use the full
models. Its input is x0 / scale_factor, what ``make_decode_fn`` feeds the
decoder.

The JAX head runs NHWC on ``z.transpose(0, 2, 3, 1)`` and pools windows as
``(B, w, 16, P, ch)``. Here the trunk runs NCHW and pools
``(B, ch, w, 16, P)`` over its last two axes: the same elements. One
difference stays: ``F.softplus`` returns x itself above 20, where
``jax.nn.softplus`` returns log1p(exp(x)); the two differ there by
log1p(exp(-x)) < 2.1e-9.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

#: latent-time columns per 1.28 s rule window (one 128-column pixel window)
WINDOW_COLS = 16

#: chord-tag vocabulary: 0 = null, 1..7 = scale degree (rules/chord.py)
NUM_CHORD_TAGS = 8


class RuleFeatureHead(nn.Module):
    """Conv trunk + per-window heads (names as the JAX module's: ``conv{i}``,
    ``win_fc``, ``nd_head``, ``chord_head``, ``ph_fc``, ``ph_head``).

    ``forward`` returns the raw predictions (chord as float32 logits);
    :meth:`features` the ``FUNC_DICT`` contract (chord as int32 tags)."""

    def __init__(self, ch: int = 64, depth: int = 4, in_channels: int = 4,
                 n_chord_tags: int = NUM_CHORD_TAGS):
        super().__init__()
        self.ch = ch
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i}",
                    nn.Conv2d(in_channels if i == 0 else ch, ch, 3, padding=1))
        self.win_fc = nn.Linear(ch, ch)
        self.nd_head = nn.Linear(ch, 2)
        self.chord_head = nn.Linear(ch, n_chord_tags)
        self.ph_fc = nn.Linear(ch, ch)
        self.ph_head = nn.Linear(ch, 12)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, t, p = z.shape
        w = t // WINDOW_COLS
        h = z.to(self.win_fc.weight.dtype)
        for i in range(self.depth):
            h = F.silu(getattr(self, f"conv{i}")(h))
            if i == 0:
                skip = h
        h = h + skip
        # per-window pooled embedding: (B, ch, w, 16, P) -> (B, w, ch)
        h = h.reshape(b, self.ch, w, WINDOW_COLS, p).mean(dim=(3, 4))
        h = F.silu(self.win_fc(h.transpose(1, 2)))

        nd = F.softplus(self.nd_head(h).float())                 # (B, w, 2)
        note_density = torch.cat([nd[..., 0], nd[..., 1]], dim=-1)
        chord_logits = self.chord_head(h)                        # (B, w, 8)

        g = F.silu(self.ph_fc(h.mean(dim=1)))                    # (B, ch)
        pitch_hist = torch.softmax(self.ph_head(g).float(), dim=-1)
        return {"pitch_hist": pitch_hist, "note_density": note_density,
                "chord_logits": chord_logits.float()}

    def features(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``FUNC_DICT``-contract features for SCG ranking."""
        out = self(z)
        return {"pitch_hist": out["pitch_hist"],
                "note_density": out["note_density"],
                "chord_progression": out["chord_logits"].argmax(dim=-1).to(torch.int32)}
