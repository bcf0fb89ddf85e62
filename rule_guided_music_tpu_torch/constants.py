"""Centralized data-representation contract for piano rolls and latents.

The reference scatters these magic numbers across many files (noted in
SURVEY.md §7 "quirks"); here they live in one place.

Piano-roll representation (reference: datasets/piano_roll_all.py:46-70):
  - 3 channels: [velocity roll, onset roll (binary, 127), quantized pedal].
  - 128 pitch rows, time columns at ``fs`` columns/second (default 100).
  - uint8 storage in [0, 127]; normalized to [-1, 1] via ``x / 63.5 - 1``
    (reference: guided_diffusion/pr_datasets_all.py:134).
  - Background threshold: decoded values <= -0.95 snap to -1
    (reference: guided_diffusion/midi_util.py:60).

Latent representation (reference: guided_diffusion/gaussian_diffusion.py:1347-1395):
  - KL-VAE f8 encodes each square (3, 128, 128) chunk to (4, 16, 16).
  - A 10.24 s excerpt = 8 chunks concatenated on time then transposed, so
    the denoiser input is (4, 128, 16) = (channels, latent-time, latent-pitch).
  - Latents are multiplied by ``scale_factor`` (released value 1.2465).
"""

# Piano range (MIDI pitch numbers of an 88-key piano).
MIN_PIANO = 21
MAX_PIANO = 108

# Value of "background"/note-off in normalized [-1, 1] space.
OFF = -1.0

# Heuristic background threshold applied to decoded rolls before
# quantization (reference: guided_diffusion/midi_util.py:60-61).
BACKGROUND_THRESHOLD = -0.95

# uint8 [0, 127] <-> [-1, 1] normalization scale.
NORM_SCALE = 63.5

# Onset channel threshold when converting rolls back to MIDI
# (reference: music_rule_guidance/piano_roll_to_chord.py:192).
ONSET_THRESHOLD = 64

# Default piano-roll sampling frequency (columns per second).
DEFAULT_FS = 100

# Default chunk geometry: 1.28 s = 128 columns; a training excerpt is
# 10.24 s = 1024 columns = 8 chunks.
CHUNK_COLS = 128
EXCERPT_CHUNKS = 8
EXCERPT_COLS = CHUNK_COLS * EXCERPT_CHUNKS

# Latent geometry for the f8 VAE.
LATENT_CH = 4
LATENT_PITCH = 16      # latent rows per chunk
LATENT_COLS_PER_CHUNK = 16
EXCERPT_LATENT_COLS = LATENT_COLS_PER_CHUNK * EXCERPT_CHUNKS  # 128

# Released latent scale factor = 1 / std of encoder outputs
# (reference: README.md:59, compute_std.py:24-48).
DEFAULT_SCALE_FACTOR = 1.2465

# Number of dataset classes (Maestro / Muscore / Pop);
# reference: guided_diffusion/script_util.py:10.
NUM_CLASSES = 3

# Sustain-pedal control-change number.
CC_SUSTAIN_PEDAL = 64

# Pedal quantization bins (reference: guided_diffusion/midi_util.py:252-264).
PEDAL_BINS = 8


def normalize_roll(arr):
    """uint8 [0,127] -> float [-1,1] (works for numpy or jax arrays)."""
    return arr / NORM_SCALE - 1.0


def denormalize_roll(arr):
    """float [-1,1] -> float [0,127] (caller clips/quantizes)."""
    return (arr + 1.0) * NORM_SCALE
