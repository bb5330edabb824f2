"""Attention (with the paged-decode and flash CUDA kernels), embedding
lookup and losses."""
