"""Pixel-space CLIs (no VAE; the state is the 128 x 128 roll at fs=12.5):
sampling with ``sample_pixel`` (the ADM UNet, optional SCG) and
``cfg_sample_pixel`` (the 2-D DiT with classifier-free guidance);
training with ``train_unet_pixel``, ``train_dit_pixel`` and
``train_classifier_pixel`` (``DiT-S/2-cls`` on ``*_pixel`` rule labels)."""
