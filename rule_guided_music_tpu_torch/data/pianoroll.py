"""Piano-roll <-> MIDI codecs (host-side, numpy).

A copy of ``rule_guided_music_tpu/data/pianoroll.py`` in pure numpy (the
JAX package's optional C++ rasteriser and codec are not carried over; its
tests hold them equal to these numpy semantics):

  * MIDI -> roll (:func:`midi_to_roll`): velocity roll, binary onset roll
    and the quantized sustain-pedal roll (guided_diffusion/midi_util.py:
    252-291), for ``edit: source: <file.mid>``;
  * roll -> MIDI: the onset-aware velocity-change scan of
    music_rule_guidance/piano_roll_to_chord.py:167-275, CC64 writing, and
    the ``sample_{i}_y_{label}.midi`` naming of midi_util.py:67-93.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..constants import (
    BACKGROUND_THRESHOLD,
    CC_SUSTAIN_PEDAL,
    MAX_PIANO,
    MIN_PIANO,
    NORM_SCALE,
    ONSET_THRESHOLD,
    PEDAL_BINS,
)
from .midi_io import ControlChange, MidiData, Note, write_midi


def quantize_pedal(value: int, num_bins: int = PEDAL_BINS) -> int:
    """Quantize a CC64 value to its bin's centre (midi_util.py:252-264)."""
    if value < 0 or value > 127:
        raise ValueError("pedal value must be in [0, 127]")
    bin_size = 128 // num_bins
    center = bin_size * (value // bin_size) + bin_size // 2
    return min(center, 127)


def midi_to_roll(midi: MidiData, fs: int = 100,
                 length: Optional[int] = None) -> np.ndarray:
    """MIDI -> (3, 128, T) float roll in [0, 127]: channel 0 the summed
    note velocities (clipped), channel 1 binary onsets (127), channel 2 the
    quantized sustain pedal across the piano range at each CC64 event."""
    end_time = midi.get_end_time()
    t_cols = max(length if length is not None else int(fs * end_time), 1)
    piano = np.zeros((128, t_cols), dtype=np.float32)
    onset = np.zeros((128, t_cols), dtype=np.float32)
    pedal = np.zeros((128, t_cols), dtype=np.float32)
    for note in midi.notes:
        s, e = int(note.start * fs), int(note.end * fs)
        if s >= t_cols:
            continue
        piano[note.pitch, s:min(e, t_cols)] += note.velocity
        onset[note.pitch, min(s, t_cols - 1)] = 127.0

    for cc in midi.control_changes:
        if cc.number != CC_SUSTAIN_PEDAL:
            continue
        t_now = int(cc.time * fs)
        if t_now >= t_cols:
            continue
        # a 0 -> 127 flip landing on a written column moves 2 columns on
        # (midi_util.py:278-284)
        if (pedal[MIN_PIANO, t_now] != 0.0
                and abs(pedal[MIN_PIANO, t_now] - cc.value) > 64):
            t_write = min(t_now + 2, t_cols - 1)
        else:
            t_write = t_now
        pedal[MIN_PIANO:MAX_PIANO + 1, t_write] = quantize_pedal(cc.value)

    piano = np.clip(piano, 0, 127)
    return np.stack([piano, onset, pedal], axis=0)


def roll_to_midi(full_roll: np.ndarray, fs: float = 100,
                 program: int = 0) -> MidiData:
    """(3|2, 128, T) or (128, T) float roll in [0, 127] -> MidiData.

    Port of piano_roll_to_pretty_midi (piano_roll_to_chord.py:167-275):
    stateful per-pitch velocity-change scan; with an onset channel, held
    spans are split into repeated notes at each onset, and spans without any
    onset are dropped.
    """
    full_roll = np.asarray(full_roll, dtype=np.float32).copy()
    # NaN/Inf lanes (e.g. a degenerate decoded pedal channel) must not cast
    # to garbage CC values downstream: map NaN/-Inf to background, +Inf to
    # full scale, and clamp to the [0, 127] velocity contract.
    if not np.isfinite(full_roll).all():
        full_roll = np.nan_to_num(full_roll, nan=0.0, posinf=127.0,
                                  neginf=0.0)
    np.clip(full_roll, 0.0, 127.0, out=full_roll)
    is_onset = False
    pedal_1d = None
    if full_roll.ndim == 3 and full_roll.shape[0] == 1:
        full_roll = full_roll[0]   # single-channel: plain velocity roll
    if full_roll.ndim == 3:
        piano_roll = full_roll[0]
        if full_roll.shape[0] == 2:
            pedal_roll = full_roll[1]
        else:
            onset_roll = full_roll[1]
            onset_roll[onset_roll < ONSET_THRESHOLD] = 0
            pedal_roll = full_roll[2]
            is_onset = True
        pedal_roll[pedal_roll < 4] = 0  # background must be 0
        lane = pedal_roll[MIN_PIANO:MAX_PIANO + 1]
        pedal_1d = (
            lane.mean(axis=0).astype(np.intc) if lane.size
            else np.zeros(pedal_roll.shape[-1], dtype=np.intc)
        )
        is_pedal = pedal_1d.size > 0 and \
            not math.isclose(float(pedal_1d.max()), 0.0)
    else:
        piano_roll = full_roll
        is_pedal = False

    notes_count, frames = piano_roll.shape
    background = piano_roll[:MIN_PIANO, :].max() if MIN_PIANO > 0 else 0.0
    piano_roll[piano_roll <= background] = 0

    midi = MidiData(program=program)

    padded = np.pad(piano_roll, [(0, 0), (1, 1)], "constant")
    binary = padded.copy()
    binary[binary != 0] = 1
    diff = np.diff(binary).T                       # (T+1, 128)
    velocity_changes = np.nonzero(diff)

    prev_velocities = np.zeros(notes_count, dtype=int)
    note_on_time = np.zeros(notes_count)

    for time, note in zip(*velocity_changes):
        velocity = padded[note, time + 1]
        time = time / fs
        if velocity > 0:
            if prev_velocities[note] == 0:
                note_on_time[note] = time
                prev_velocities[note] = int(velocity)
        else:
            if is_onset:
                start_ind = round(note_on_time[note] * fs)
                end_ind = round(time * fs)
                onsets_note = onset_roll[note, start_ind:end_ind + 1]
                onset_times = np.nonzero(onsets_note)[0]
                if len(onset_times) > 0:
                    start_times = (onset_times + start_ind) / fs
                    end_times = np.concatenate(
                        (start_times[1:], np.array([time])), axis=0
                    )
                    for i in range(len(onset_times)):
                        midi.notes.append(
                            Note(
                                velocity=prev_velocities[note],
                                pitch=int(note),
                                start=float(start_times[i]),
                                end=float(end_times[i]),
                            )
                        )
            else:
                midi.notes.append(
                    Note(
                        velocity=prev_velocities[note],
                        pitch=int(note),
                        start=float(note_on_time[note]),
                        end=float(time),
                    )
                )
            prev_velocities[note] = 0

    if is_pedal:
        _append_pedal_ccs(midi, pedal_1d, fs)
    midi.notes.sort(key=lambda n: (n.start, n.pitch))
    return midi


def _append_pedal_ccs(midi: MidiData, pedal_1d: np.ndarray, fs: float):
    """Write CC64 events from the 1-D pedal lane (piano_roll_to_chord
    :259-273 value snapping)."""
    for (t_idx,) in zip(*np.nonzero(pedal_1d)):
        val = int(pedal_1d[t_idx])
        if val < 16:
            val = 0  # bins 1-16 quantize back to 0
        if val > 112:
            val = 127
        midi.control_changes.append(
            ControlChange(
                number=CC_SUSTAIN_PEDAL, value=val, time=float(t_idx / fs)
            )
        )


def finalize_decoded_sample(
    sample: np.ndarray, threshold: float = BACKGROUND_THRESHOLD
) -> np.ndarray:
    """Normalized [-1,1] decoded rolls -> uint8 [0,127] (midi_util.py:60-64)."""
    sample = np.asarray(sample, dtype=np.float32).copy()
    sample[sample <= threshold] = -1.0
    return np.clip((sample + 1.0) * NORM_SCALE, 0, 127).astype(np.uint8)


def save_piano_roll_midi(
    sample: np.ndarray,
    save_dir: str,
    fs: int = 100,
    y: Optional[np.ndarray] = None,
    save_ind: int = 0,
) -> list:
    """Write a batch of (3|2, 128, T) uint8 rolls as .midi files.

    Mirrors midi_util.py:67-93 incl. the first-column onset fix and the
    ``sample_{i}_y_{label}.midi`` naming.
    """
    os.makedirs(save_dir, exist_ok=True)
    onset = sample.ndim == 4 and sample.shape[1] == 3
    paths = []
    for i in range(sample.shape[0]):
        cur = np.asarray(sample[i], dtype=np.float32).copy()
        if onset:
            first_column = cur[0, :, 0]
            first_onset_pitch = np.nonzero(first_column)[0]
            cur[1, first_onset_pitch, 0] = 127
        midi = roll_to_midi(cur, fs=fs)
        if y is not None:
            name = f"sample_{i + save_ind}_y_{int(y[i])}.midi"
        else:
            name = f"sample_{i + save_ind}.midi"
        path = os.path.join(save_dir, name)
        write_midi(path, midi)
        paths.append(path)
    return paths
