"""The train step's share of the card's bf16 peak: per traced step the
denoiser's forward and backward at the batch and the encoder's forward on
its chunks, over the steps' untraced wall time, over 989 TFLOP/s."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx, ("train_dit", "encoder"))
