"""Hand-written CUDA kernels for Hopper (sources in csrc/) and their wrappers."""
