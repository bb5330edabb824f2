"""Causal-LM losses — the port of the JAX package's ``ops/losses.py``.

The shifted next-token cross-entropy of the training and eval steps, f32
throughout (the logits are upcast before the log-softmax), with the
padding- and packing-aware token count the data pipeline's ``loss_mask``
gives. ``(mean, count)`` pairs aggregate exactly across batches and
microbatches: ``sum(mean * count) / sum(count)``.
:func:`fused_linear_cross_entropy` is the same loss from hidden states,
through the fused CE kernels (``--fused-loss``).
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_with_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE in f32. logits ``[..., V]``, labels ``[...]`` int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1,
                                labels[..., None].long())[..., 0]
    return logz - label_logits


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted next-token loss. logits ``[B, T, V]``; input_ids ``[B, T]``;
    loss_mask ``[B, T]``, 1.0 where the *label* token is real (pad and
    cross-document boundaries excluded by the data pipeline).

    Returns ``(mean_loss, token_count)``, both f32 scalars; the count is
    at least 1."""
    total, count = causal_lm_totals(logits, input_ids, loss_mask)
    count = torch.clamp(count, min=1.0)
    return total / count, count


def causal_lm_totals(logits: torch.Tensor, input_ids: torch.Tensor,
                     loss_mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of masked per-token losses, raw mask sum)`` of
    :func:`causal_lm_loss`."""
    return lm_totals(logits[:, :-1, :], input_ids[:, 1:],
                     None if loss_mask is None else loss_mask[:, 1:])


def lm_totals(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of masked per-token losses, raw mask sum)`` of logits
    already aligned to their ``labels`` (a mesh's targets, shifted on
    the whole row; it sums both over its ranks first)."""
    per_tok = cross_entropy_with_logits(logits, labels)
    m = (torch.ones_like(per_tok) if mask is None
         else mask.to(per_tok.dtype))
    return torch.sum(per_tok * m), torch.sum(m)


def perplexity(mean_loss: torch.Tensor) -> torch.Tensor:
    """The validator's second metric: ``exp(mean_loss)``."""
    return torch.exp(mean_loss)


def fused_linear_cross_entropy(hidden: torch.Tensor, head_kernel: torch.Tensor,
                               labels: torch.Tensor,
                               loss_mask: Optional[torch.Tensor] = None,
                               *, mesh=None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted-label CE of ``logits = hidden @ head_kernel.T`` without
    materialising the ``[N, V]`` logits: the fused forward, dh and dW
    kernels of ``ops/fused_ce.py`` on the card, their plain versions on
    the CPU.

    ``hidden [..., E]`` is already shifted and aligned to ``labels
    [...]``; ``head_kernel`` is ``[V, E]`` (the tied ``wte``);
    ``loss_mask`` is shaped like ``labels``. Returns ``(mean_loss,
    token_count)``, the :func:`causal_lm_loss` contract. The JAX
    package's ``impl``, ``chunk`` and ``interpret`` name its own
    spellings of this one function; the port has one route.

    With ``mesh`` (a ``parallel.Mesh``, size 1 included, as JAX routes
    every mesh) the loss is ``fused_ce.fused_ce_loss_sharded``:
    ``hidden`` and ``labels`` are this rank's rows and ``head_kernel``
    its ``("tp", "fsdp")`` shard of the head."""
    if mesh is not None:
        from ..parallel.mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        from .fused_ce import fused_ce_loss_sharded
        return fused_ce_loss_sharded(hidden, head_kernel, labels, loss_mask,
                                     mesh=mesh)
    from .fused_ce import fused_ce_loss
    return fused_ce_loss(hidden, head_kernel, labels, loss_mask)
