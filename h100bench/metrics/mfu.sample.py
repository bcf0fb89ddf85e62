"""The whole chain's share of the card's bf16 peak: the operations of the
traced chains (trajectory and rollout denoiser calls, the classifiers'
forwards and input gradients, every decode) over their untraced wall
time, over 989 TFLOP/s."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx, ("dit.trajectory", "dit.rollout", "classifier", "decoder"))
