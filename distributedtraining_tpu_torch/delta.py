"""Weight-delta algebra on the port's state dicts — the dense v1 subset of
the JAX package's ``delta.py``.

A *delta* is the per-parameter difference ``trained - base`` between two
state dicts with the same keys and shapes (the JAX param tree's paths
joined with ``.``): the miner's product, which validators apply to score
and the averager merges. Screens, compressed wire forms and merges come
with the later slices (ROADMAP "Slices of the port").
"""

from __future__ import annotations

from typing import Mapping

import torch

Params = Mapping[str, torch.Tensor]

_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _same_keys(a: Params, b: Params) -> None:
    if a.keys() != b.keys():
        raise ValueError(f"state dicts differ in keys: "
                         f"{sorted(set(a) ^ set(b))[:5]}")


def tree_sub(a: Params, b: Params) -> dict[str, torch.Tensor]:
    """Elementwise ``a - b`` over state dicts with the same keys."""
    _same_keys(a, b)
    return {k: a[k] - b[k] for k in a}


def tree_add(a: Params, b: Params) -> dict[str, torch.Tensor]:
    """Elementwise ``a + b`` over state dicts with the same keys."""
    _same_keys(a, b)
    return {k: a[k] + b[k] for k in a}


@torch.no_grad()
def compute_delta(trained: Params, base: Params,
                  wire_dtype: str | None = None) -> dict[str, torch.Tensor]:
    """``delta = trained - base``, the artifact a miner uploads (outside
    autograd: training params take gradients, the artifact does not).
    ``wire_dtype="bfloat16"`` casts its float leaves for the wire (half
    the bytes; the rounding is of the delta, not of the weights)."""
    d = tree_sub(trained, base)
    if wire_dtype is None:
        return d
    dt = _WIRE_DTYPES[wire_dtype]
    return {k: v.to(dt) if v.is_floating_point() else v
            for k, v in d.items()}


def apply_delta(base: Params, delta: Params) -> dict[str, torch.Tensor]:
    """Reconstruct trained params from base + delta (a bf16 delta adds
    onto f32 weights in f32, by type promotion)."""
    return tree_add(base, delta)


def tree_finite(tree: Params) -> torch.Tensor:
    """0-dim bool tensor: True when every float leaf is finite (integer
    leaves are finite by construction). Stays on the leaves' device, so a
    caller decides when to synchronise."""
    flags = [torch.isfinite(t).all() for t in tree.values()
             if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()
