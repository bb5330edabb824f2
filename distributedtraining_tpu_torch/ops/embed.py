"""Embedding lookup — the port of the JAX package's ``ops/embed.py``.

A gather with clamped ids: ``jnp.take(..., mode="clip")`` semantics, so an
out-of-range id (e.g. a position past ``n_positions``) reads the edge row
instead of garbage. It is differentiable: autograd's backward of the
gather is a scatter-add of the cotangent rows into the table, the JAX
package's single-device spelling. JAX's one-hot matmul backward on dp x
fsdp meshes (JAX ``ops/embed.py:74-104``) is a GSPMD spelling of the same
sum: on a mesh the port gathers the table (``parallel.sharding``), takes
this scatter-add of the rank's rows and positions, and the gather's
backward and the engine's sum over dp and sp complete it, so no second
spelling exists here.
"""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[clip(ids, 0, rows - 1)]``."""
    return table[ids.clamp(0, table.shape[0] - 1)]
