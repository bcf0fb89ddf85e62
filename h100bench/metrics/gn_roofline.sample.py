"""The fused GroupNorm + swish's roofline share: every FusedNormSwish
forward (kernel 2), x read once and y written once, against its kernels'
device time."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, ("groupnorm_swish",))
