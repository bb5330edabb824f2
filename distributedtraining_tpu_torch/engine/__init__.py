"""Serving engine (continuous batching over a paged KV cache) and the
training step engine."""
