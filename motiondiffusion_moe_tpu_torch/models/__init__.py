"""Denoiser, text encoder and the flax -> torch weight bridge."""
