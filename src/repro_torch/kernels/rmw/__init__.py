"""Combining-RMW kernels: CUDA sources, build, wrappers and plain versions."""
