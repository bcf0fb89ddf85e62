"""Percent of the traced units' untraced wall time in which no kernel, copy
or fill ran on the card: 1 - (union of the traced device intervals) /
(units x untraced seconds a unit)."""
from harness import readers


def read(ctx):
    return readers.idle(ctx)
