"""Pixel-space sampling CLIs (no VAE; the state is the 128 x 128 roll at
fs=12.5): ``sample_pixel`` (the ADM UNet, optional SCG) and
``cfg_sample_pixel`` (the 2-D DiT with classifier-free guidance)."""
