"""Transforms of the spectral solve (single device)."""
