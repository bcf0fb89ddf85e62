"""Standard MIDI file reading/writing, from scratch.

The reference vendors a pretty_midi fork for MIDI I/O; neither pretty_midi
nor mido ships in this environment, so this module implements the subset of
SMF (Standard MIDI File) parsing/writing the framework needs: note on/off,
control changes (sustain pedal), program change, and tempo maps.  Host-side
only — device code never touches MIDI.

Format notes: SMF header 'MThd' (format, ntrks, division), 'MTrk' chunks of
<varlen delta><event>. Only PPQ (ticks-per-quarter) division is supported.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Note:
    velocity: int
    pitch: int
    start: float  # seconds
    end: float    # seconds


@dataclass
class ControlChange:
    number: int
    value: int
    time: float   # seconds


@dataclass
class MidiData:
    notes: List[Note] = field(default_factory=list)
    control_changes: List[ControlChange] = field(default_factory=list)
    program: int = 0

    def get_end_time(self) -> float:
        end = 0.0
        for n in self.notes:
            end = max(end, n.end)
        for c in self.control_changes:
            end = max(end, c.time)
        return end


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _varlen(value: int) -> bytes:
    """Encode a MIDI variable-length quantity."""
    buf = value & 0x7F
    out = bytearray()
    while value >> 7:
        value >>= 7
        buf <<= 8
        buf |= (value & 0x7F) | 0x80
    while True:
        out.append(buf & 0xFF)
        if buf & 0x80:
            buf >>= 8
        else:
            break
    return bytes(out)


def write_midi(
    path: str,
    midi: MidiData,
    tempo_bpm: float = 120.0,
    ticks_per_quarter: int = 480,
) -> None:
    """Write a single-track (format 0) MIDI file."""
    tempo_us = int(round(60_000_000 / tempo_bpm))
    sec_per_tick = tempo_us / 1_000_000 / ticks_per_quarter

    events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
    for cc in midi.control_changes:
        tick = int(round(cc.time / sec_per_tick))
        events.append((tick, 0, bytes([0xB0, cc.number & 0x7F, cc.value & 0x7F])))
    for note in midi.notes:
        on_tick = int(round(note.start / sec_per_tick))
        off_tick = int(round(note.end / sec_per_tick))
        if off_tick <= on_tick:
            off_tick = on_tick + 1
        # note-offs sort before note-ons at the same tick (order key)
        events.append((on_tick, 2, bytes([0x90, note.pitch & 0x7F,
                                          max(1, min(127, note.velocity))])))
        events.append((off_tick, 1, bytes([0x80, note.pitch & 0x7F, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    # tempo meta + program change at t=0
    track += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", tempo_us)[1:]
    track += _varlen(0) + bytes([0xC0, midi.program & 0x7F])
    prev_tick = 0
    for tick, _, payload in events:
        track += _varlen(tick - prev_tick) + payload
        prev_tick = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_quarter))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated MIDI file")
        self.pos += n
        return out

    def byte(self) -> int:
        return self.read(1)[0]

    def varlen(self) -> int:
        value = 0
        while True:
            b = self.byte()
            value = (value << 7) | (b & 0x7F)
            if not b & 0x80:
                return value

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.data)


def read_midi(path: str) -> MidiData:
    """Parse an SMF file into absolute-seconds notes and control changes."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    header_len = struct.unpack(">I", r.read(4))[0]
    fmt, ntrks, division = struct.unpack(">HHH", r.read(6))
    r.read(header_len - 6)
    if division & 0x8000:
        raise NotImplementedError("SMPTE division not supported")

    # Pass 1: collect raw events per track with absolute ticks.
    tracks = []
    tempo_events: List[Tuple[int, int]] = [(0, 500000)]  # (tick, us/quarter)
    for _ in range(ntrks):
        if r.read(4) != b"MTrk":
            raise ValueError("expected MTrk chunk")
        length = struct.unpack(">I", r.read(4))[0]
        tr = _Reader(r.read(length))
        tick = 0
        status = 0
        events = []
        while not tr.eof:
            tick += tr.varlen()
            b = tr.byte()
            if b >= 0x80:
                status = b
            else:
                tr.pos -= 1  # running status: reuse previous status byte
            if status == 0xFF:
                meta_type = tr.byte()
                meta_len = tr.varlen()
                payload = tr.read(meta_len)
                if meta_type == 0x51 and meta_len == 3:
                    tempo = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    tempo_events.append((tick, tempo))
            elif status in (0xF0, 0xF7):
                tr.read(tr.varlen())
            else:
                kind = status & 0xF0
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = tr.byte(), tr.byte()
                    events.append((tick, status, d1, d2))
                elif kind in (0xC0, 0xD0):
                    d1 = tr.byte()
                    events.append((tick, status, d1, 0))
                else:
                    raise ValueError(f"bad status byte {status:#x}")
        tracks.append(events)

    # Build the tempo map (tick -> seconds).
    tempo_events.sort()
    seg_ticks = [tempo_events[0][0]]
    seg_secs = [0.0]
    seg_tempo = [tempo_events[0][1]]
    for tick, tempo in tempo_events[1:]:
        dt = tick - seg_ticks[-1]
        seg_secs.append(seg_secs[-1] + dt * seg_tempo[-1] / 1e6 / division)
        seg_ticks.append(tick)
        seg_tempo.append(tempo)

    def tick_to_sec(tick: int) -> float:
        import bisect

        i = bisect.bisect_right(seg_ticks, tick) - 1
        return seg_secs[i] + (tick - seg_ticks[i]) * seg_tempo[i] / 1e6 / division

    midi = MidiData()
    for events in tracks:
        active = {}  # (channel, pitch) -> (start_tick, velocity)
        for tick, status, d1, d2 in events:
            kind, channel = status & 0xF0, status & 0x0F
            if kind == 0x90 and d2 > 0:
                active.setdefault((channel, d1), []).append((tick, d2))
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                stack = active.get((channel, d1))
                if stack:
                    start_tick, vel = stack.pop(0)
                    midi.notes.append(
                        Note(velocity=vel, pitch=d1,
                             start=tick_to_sec(start_tick),
                             end=tick_to_sec(tick))
                    )
            elif kind == 0xB0:
                midi.control_changes.append(
                    ControlChange(number=d1, value=d2, time=tick_to_sec(tick))
                )
            elif kind == 0xC0:
                midi.program = d1
    midi.notes.sort(key=lambda n: (n.start, n.pitch))
    midi.control_changes.sort(key=lambda c: c.time)
    return midi
