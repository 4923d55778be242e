"""Mamba-2 SSD: CUDA source, wrapper and plain version, ops, oracle."""
