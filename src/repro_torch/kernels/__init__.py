"""Hand-written Hopper kernels of the port, one folder per kernel family."""
