"""Attention's roofline share: every Attention.forward of the denoiser and
the classifiers (qkv, rotary, kernel 1, proj) against its kernels' device
time."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, ("attention",))
