"""Hand-written CUDA kernels for Hopper, their wrappers and the resident driver."""
