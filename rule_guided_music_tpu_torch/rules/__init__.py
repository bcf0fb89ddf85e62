"""Rule programs (pitch histogram, note density, chords) on torch tensors."""
