"""Flash attention: CUDA source, wrapper and plain version, ops, oracle."""
