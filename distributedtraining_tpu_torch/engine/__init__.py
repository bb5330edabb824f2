"""Serving engine: continuous batching over a paged KV cache."""
