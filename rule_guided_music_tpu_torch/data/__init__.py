"""Host-side MIDI export (copies of the JAX package's numpy/struct code)."""
