"""Embedding lookup — the forward of the JAX package's ``ops/embed.py``.

A gather with clamped ids: ``jnp.take(..., mode="clip")`` semantics, so an
out-of-range id (e.g. a position past ``n_positions``) reads the edge row
instead of garbage. The mesh-aware one-hot backward comes with training.
"""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[clip(ids, 0, rows - 1)]``."""
    return table[ids.clamp(0, table.shape[0] - 1)]
