"""Host-side evaluation of generated MIDI (copies of the JAX package's
numpy modules): mgeval features and set distances, REMI events and chord
recognition, and the FAD gate with its numpy proxy."""
