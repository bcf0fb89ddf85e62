"""Attention, rotary and GroupNorm+swish, with the two Hopper kernels."""
