"""Training: the diffusion train loop, the VAE trainer, samplers, LPIPS."""
