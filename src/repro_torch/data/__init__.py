"""Synthetic data generators (numpy, deterministic in the seed)."""
