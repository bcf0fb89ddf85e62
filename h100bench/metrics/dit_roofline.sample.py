"""The denoiser's roofline share: DiTRotary.forward calls (trajectory at
B, rollout at k*B) by ``work/dit.py`` against the device time of the
kernels their ranges enclose."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, ("dit.trajectory", "dit.rollout"))
