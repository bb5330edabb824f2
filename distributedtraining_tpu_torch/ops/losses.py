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
    per_tok = cross_entropy_with_logits(logits[:, :-1, :], input_ids[:, 1:])
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(per_tok.dtype)
    else:
        m = torch.ones_like(per_tok)
    total = torch.sum(per_tok * m)
    count = torch.clamp(torch.sum(m), min=1.0)
    return total / count, count


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
    spellings of this one function; the port has one route."""
    if mesh is not None:
        raise NotImplementedError(
            "fused_linear_cross_entropy(mesh=...): the sharded spelling is "
            "the parallel slice, ROADMAP 'Slices of the port', slice 7")
    from .fused_ce import fused_ce_loss
    return fused_ce_loss(hidden, head_kernel, labels, loss_mask)
