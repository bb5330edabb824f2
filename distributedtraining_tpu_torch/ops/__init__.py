"""Attention, embedding lookup and the paged-decode CUDA kernel."""
