"""Embedding lookup — the port of the JAX package's ``ops/embed.py``.

A gather with clamped ids: ``jnp.take(..., mode="clip")`` semantics, so an
out-of-range id (e.g. a position past ``n_positions``) reads the edge row
instead of garbage. It is differentiable: autograd's backward of the
gather is a scatter-add of the cotangent rows into the table, the JAX
package's single-device spelling. Its one-hot matmul backward exists only
for dp x fsdp meshes and waits for the parallel slice (ROADMAP "Slices of
the port", slice 7).
"""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[clip(ids, 0, rows - 1)]``."""
    return table[ids.clamp(0, table.shape[0] - 1)]
