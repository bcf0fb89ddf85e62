"""The VAE decoder's roofline share: Decoder.forward calls (candidate and
final decodes) by ``work/kl_vae.py`` against their kernels' device time."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, ("decoder",))
