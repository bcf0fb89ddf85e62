"""DiTRotary denoiser and KL-VAE decoder as ``nn.Module``s."""
