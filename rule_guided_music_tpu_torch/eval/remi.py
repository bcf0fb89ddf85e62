"""REMI-style event representation + rule-based chord recognition.

A copy of ``rule_guided_music_tpu/eval/remi.py`` for the port, over the
port's ``data/midi_io``.

Re-architecture of music_evaluation/figaro/{input_representation.py,
chord_recognition.py, vocab.py}: the reference uses the FIGARO toolkit to
(1) tokenize MIDI into REMI events (bar / position / pitch / velocity /
duration) for representation-level metrics and (2) recognize chords with
chroma-template matching for chord/chroma evaluation of generated music.

This is a compact host-side implementation of both capabilities with the
same event vocabulary structure; exact token-id parity with FIGARO is not a
goal (the reference uses it only inside its own eval scripts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.midi_io import MidiData

# Grid: 4/4 bars at a fixed tempo, `POSITIONS_PER_BAR` slots per bar.
POSITIONS_PER_BAR = 16
DEFAULT_BAR_SECONDS = 2.0       # 120 bpm, 4/4
VELOCITY_BINS = 32
DURATION_BINS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64]  # in positions


@dataclass(frozen=True)
class Event:
    kind: str     # Bar | Position | Pitch | Velocity | Duration | Chord
    value: int

    def __str__(self):
        return f"{self.kind}_{self.value}"


def quantize_velocity(v: int) -> int:
    return min(int(v * VELOCITY_BINS / 128), VELOCITY_BINS - 1)


def quantize_duration(positions: float) -> int:
    """Index of the nearest duration bin."""
    arr = np.asarray(DURATION_BINS, dtype=float)
    return int(np.argmin(np.abs(arr - max(positions, 1e-6))))


def midi_to_events(
    midi: MidiData, bar_seconds: float = DEFAULT_BAR_SECONDS
) -> List[Event]:
    """Tokenize notes into REMI events ordered by (bar, position, pitch).

    Layout per note: Bar (emitted on bar change) -> Position -> Pitch ->
    Velocity -> Duration, mirroring input_representation.py's event stream.
    """
    pos_seconds = bar_seconds / POSITIONS_PER_BAR
    notes = sorted(midi.notes, key=lambda n: (n.start, n.pitch))
    events: List[Event] = []
    current_bar = -1
    for note in notes:
        grid = int(round(note.start / pos_seconds))
        bar, pos = divmod(grid, POSITIONS_PER_BAR)
        if bar != current_bar:
            events.append(Event("Bar", bar))
            current_bar = bar
        events.append(Event("Position", pos))
        events.append(Event("Pitch", note.pitch))
        events.append(Event("Velocity", quantize_velocity(note.velocity)))
        dur_pos = (note.end - note.start) / pos_seconds
        events.append(Event("Duration", quantize_duration(dur_pos)))
    return events


def events_to_midi(
    events: Sequence[Event], bar_seconds: float = DEFAULT_BAR_SECONDS
) -> MidiData:
    """Inverse tokenization (grid-quantized reconstruction)."""
    from ..data.midi_io import Note

    pos_seconds = bar_seconds / POSITIONS_PER_BAR
    midi = MidiData()
    bar = 0
    pos = 0
    pitch = velocity = None
    for ev in events:
        if ev.kind == "Bar":
            bar = ev.value
        elif ev.kind == "Position":
            pos = ev.value
        elif ev.kind == "Pitch":
            pitch = ev.value
        elif ev.kind == "Velocity":
            velocity = int((ev.value + 0.5) * 128 / VELOCITY_BINS)
        elif ev.kind == "Duration" and pitch is not None:
            start = (bar * POSITIONS_PER_BAR + pos) * pos_seconds
            dur = DURATION_BINS[ev.value] * pos_seconds
            midi.notes.append(
                Note(velocity=velocity or 64, pitch=pitch, start=start,
                     end=start + dur)
            )
            pitch = velocity = None
    midi.notes.sort(key=lambda n: (n.start, n.pitch))
    return midi


class Vocab:
    """Token vocabulary over the event kinds (vocab.py role)."""

    def __init__(self):
        tokens = ["<pad>", "<bos>", "<eos>"]
        tokens += [f"Bar_{i}" for i in range(256)]
        tokens += [f"Position_{i}" for i in range(POSITIONS_PER_BAR)]
        tokens += [f"Pitch_{i}" for i in range(128)]
        tokens += [f"Velocity_{i}" for i in range(VELOCITY_BINS)]
        tokens += [f"Duration_{i}" for i in range(len(DURATION_BINS))]
        tokens += [f"Chord_{q}_{r}" for q in ("maj", "min", "dim", "aug", "N")
                   for r in range(12)]
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.id_to_token = tokens

    def __len__(self):
        return len(self.id_to_token)

    def encode(self, events: Sequence[Event]) -> List[int]:
        return [self.token_to_id[str(e)] for e in events]

    def decode(self, ids: Sequence[int]) -> List[Event]:
        out = []
        for i in ids:
            tok = self.id_to_token[i]
            if "_" not in tok:
                continue
            kind, value = tok.rsplit("_", 1)
            if value.isdigit():
                out.append(Event(kind, int(value)))
        return out


# ---------------------------------------------------------------------------
# Rule-based chord recognition (chord_recognition.py role)
# ---------------------------------------------------------------------------

_QUALITIES = {
    "maj": (0, 4, 7),
    "min": (0, 3, 7),
    "dim": (0, 3, 6),
    "aug": (0, 4, 8),
}


def recognize_chords(
    midi: MidiData,
    window_seconds: float = DEFAULT_BAR_SECONDS / 2,
    total_seconds: float = None,
) -> List[Tuple[str, int]]:
    """Per-window (quality, root_pc) chord labels via chroma-template
    matching; ("N", -1) for empty windows."""
    end = total_seconds if total_seconds is not None else midi.get_end_time()
    n_windows = max(int(np.ceil(end / window_seconds)), 1)
    chroma = np.zeros((n_windows, 12))
    for note in midi.notes:
        w0 = int(note.start / window_seconds)
        w1 = int(np.ceil(note.end / window_seconds))
        for w in range(w0, min(w1, n_windows)):
            seg_start = max(note.start, w * window_seconds)
            seg_end = min(note.end, (w + 1) * window_seconds)
            if seg_end > seg_start:
                chroma[w, note.pitch % 12] += seg_end - seg_start

    labels = []
    templates = []
    names = []
    for q, ivs in _QUALITIES.items():
        for root in range(12):
            tpl = np.zeros(12)
            for iv in ivs:
                tpl[(root + iv) % 12] = 1.0
            templates.append(tpl / np.linalg.norm(tpl))
            names.append((q, root))
    templates = np.stack(templates)
    for w in range(n_windows):
        c = chroma[w]
        if c.sum() < 1e-9:
            labels.append(("N", -1))
            continue
        cn = c / (np.linalg.norm(c) + 1e-12)
        labels.append(names[int(np.argmax(templates @ cn))])
    return labels


def chord_symbols(labels: Sequence[Tuple[str, int]]) -> List[str]:
    pcs = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A", "Bb", "B"]
    return [
        "N" if q == "N" else f"{pcs[root]}:{q}" for q, root in labels
    ]
