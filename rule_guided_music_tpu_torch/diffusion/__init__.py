"""Schedules, Gaussian math, latent bridges and the SCG sampler."""
