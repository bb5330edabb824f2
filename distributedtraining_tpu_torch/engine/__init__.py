"""Serving engine (continuous batching over a paged KV cache), the
training step engine, the miner's loop and its publisher, delta ingest,
and the averager's loop."""
