"""Spectral core and the CUDA kernels under it."""
