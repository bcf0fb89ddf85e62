"""Fréchet Audio Distance hookup (reference: music_evaluation/fad.py).

A copy of ``rule_guided_music_tpu/eval/fad.py`` for the port: the same
gate and the same numpy proxy, over the port's ``data/midi_io``.

The reference renders MIDI to wav with fluidsynth and scores FAD with the
``frechet_audio_distance`` package (VGGish). Neither fluidsynth nor that
package ships in this environment, so this module provides the same API
surface with explicit gating: it computes FAD when the dependencies exist
and raises a clear error otherwise.
"""

from __future__ import annotations

import os
from typing import Sequence


def _require(module: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise RuntimeError(
            f"FAD evaluation needs '{module}' (and a fluidsynth soundfont); "
            "install it in a full environment to enable this metric."
        ) from e


def midi_dir_to_wav(midi_dir: str, wav_dir: str, soundfont: str,
                    sample_rate: int = 16000) -> Sequence[str]:
    """Render .midi files to .wav via fluidsynth (convert_to_wav.py parity)."""
    import subprocess

    os.makedirs(wav_dir, exist_ok=True)
    out = []
    for fname in sorted(os.listdir(midi_dir)):
        if not fname.endswith((".mid", ".midi")):
            continue
        wav = os.path.join(wav_dir, os.path.splitext(fname)[0] + ".wav")
        subprocess.run(
            ["fluidsynth", "-ni", soundfont, os.path.join(midi_dir, fname),
             "-F", wav, "-r", str(sample_rate)],
            check=True, capture_output=True,
        )
        out.append(wav)
    return out


def compute_fad(background_dir: str, eval_dir: str) -> float:
    """FAD between two wav directories (fad.py:12-38 parity)."""
    fad_mod = _require("frechet_audio_distance")
    fad = fad_mod.FrechetAudioDistance(
        model_name="vggish", use_pca=False, use_activation=False,
    )
    return float(fad.score(background_dir, eval_dir))


# ---------------------------------------------------------------------------
# In-environment FAD proxy: additive synthesis + log-mel Fréchet distance
# ---------------------------------------------------------------------------
# The exact reference metric needs fluidsynth + VGGish; neither exists here.
# This proxy keeps the metric *runnable*: render MIDI with a harmonic
# additive synthesizer (numpy, no external deps), embed each clip as
# time-pooled log-mel statistics, and compute the same Fréchet distance
# formula over the embedding distributions. It is NOT calibrated to
# published VGGish-FAD numbers — use it for relative comparisons between
# sample sets produced in this repo; swap in compute_fad when the full
# stack is available.
#
# Validity envelope (tests/test_fad_proxy_validity.py): the score is 0 for
# identical sets and increases monotonically under progressive pitch/timing
# corruption (measured 435 -> 714 -> 924 -> 1322 across severities 0/.25/.5/1
# on 12-clip sets). Caveats: (a) absolute values are meaningless across
# embedding configs and NOT comparable to VGGish FAD; (b) the clean-vs-clean
# baseline is sizable at small N (rank-deficient covariances) — compare sets
# of equal size and treat only the ordering as signal.

import numpy as np


def synth_midi(midi, sample_rate: int = 16000, n_partials: int = 6,
               max_seconds: float = 30.0) -> np.ndarray:
    """Additive harmonic synthesis of a MidiData (host-side numpy).

    Each note: sum of decaying harmonic partials with an exponential
    envelope scaled by velocity. Good enough to expose pitch/rhythm/voicing
    content to a spectral metric.
    """
    end = min(midi.get_end_time() + 0.5, max_seconds)
    n = max(int(end * sample_rate), sample_rate // 4)
    audio = np.zeros(n, dtype=np.float64)
    for note in midi.notes:
        if note.start >= max_seconds:
            continue
        f0 = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
        s = int(note.start * sample_rate)
        e = min(int(note.end * sample_rate), n)
        if e <= s:
            continue
        t = np.arange(e - s) / sample_rate
        env = (note.velocity / 127.0) * np.exp(-3.0 * t)
        seg = np.zeros(e - s)
        for h in range(1, n_partials + 1):
            fh = f0 * h
            if fh >= sample_rate / 2:
                break
            seg += env * np.sin(2 * np.pi * fh * t) / h
        audio[s:e] += seg
    peak = np.abs(audio).max()
    return (audio / peak if peak > 0 else audio).astype(np.float32)


def _mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[m - 1, k] = (hi - k) / (hi - c)
    return fb


def logmel_embedding(audio: np.ndarray, sample_rate: int = 16000,
                     n_fft: int = 1024, hop: int = 512,
                     n_mels: int = 64) -> np.ndarray:
    """Per-clip embedding: mean + std of log-mel frames -> (2 * n_mels,)."""
    if len(audio) < n_fft:
        audio = np.pad(audio, (0, n_fft - len(audio)))
    n_frames = 1 + (len(audio) - n_fft) // hop
    window = np.hanning(n_fft)
    frames = np.stack([
        audio[i * hop:i * hop + n_fft] * window for i in range(n_frames)
    ])
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ _mel_filterbank(sample_rate, n_fft, n_mels).T
    logmel = np.log(mel + 1e-8)
    return np.concatenate([logmel.mean(axis=0), logmel.std(axis=0)])


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the FAD formula)."""
    from scipy import linalg

    diff = mu1 - mu2
    offset = np.eye(sigma1.shape[0]) * eps
    # the root alone: SciPy 1.18 removed sqrtm's disp, whose disp=False
    # form returned (root, error estimate)
    covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    val = float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))
    return max(val, 0.0)  # sqrtm noise can go slightly negative at ~0


def compute_fad_proxy(background_midis: Sequence[str],
                      eval_midis: Sequence[str],
                      sample_rate: int = 16000) -> float:
    """FAD over additive-synth log-mel embeddings of two MIDI sets."""
    from ..data.midi_io import read_midi

    def embed_set(paths):
        embs = [
            logmel_embedding(synth_midi(read_midi(p), sample_rate),
                             sample_rate)
            for p in paths
        ]
        arr = np.stack(embs)
        return arr.mean(axis=0), np.cov(arr, rowvar=False)

    mu1, s1 = embed_set(background_midis)
    mu2, s2 = embed_set(eval_midis)
    return frechet_distance(mu1, s1, mu2, s2)
