"""Stage timing and the CUDA kernel build."""
