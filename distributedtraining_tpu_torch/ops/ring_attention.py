"""Ring attention: sequence-parallel causal attention over the mesh's sp
axis — the port of the JAX package's ``ops/ring_attention.py``.

The sequence axis is split over sp; each rank holds one query block and
streams the K/V blocks around the ring (``parallel.collectives.ring_pass``
in place of ``ppermute``), accumulating attention with an online softmax
(running max and denominator, all f32). No ``[T, T]`` score matrix
exists, and a rank's activations are O(T/sp).

Causality across blocks: query block ``idx`` at global offset
``idx * t_local`` attends the K/V block it holds at step ``s``, block
``(idx - s) % sp``, through the global positions, masked to ``NEG_INF``
where the key is later than the query. JAX's static schedule is kept:
sp steps a call, fully masked blocks computed. The pass after the last
step is not made; JAX's ``fori_loop`` makes it and discards its result.

This is lax code in the JAX package, not a Pallas kernel: its products
are large matrix products that XLA computes there, and ``torch`` ops
compute here. Autograd differentiates it, each pass's backward sending
the K/V cotangents one step back around the ring.

Shapes: q, k, v are this rank's ``[B, T/sp, H, D]`` blocks.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def _ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
               axis: str) -> torch.Tensor:
    """JAX ``_ring_body`` step for step on this rank's blocks."""
    from ..parallel.collectives import ring_pass
    n, idx = mesh.size(axis), mesh.index(axis)
    B, Tl, H, D = q.shape
    qf = q.float() * D ** -0.5
    pos = torch.arange(Tl, device=q.device)
    q_pos = idx * Tl + pos                     # global query positions
    acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32,
                        device=q.device)
    l_prev = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])                   # one pass a step for both
    for s in range(n):
        src = (idx - s) % n                    # which block this rank holds
        k_pos = src * Tl + pos
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kv[0].float())
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
        m_new = torch.maximum(m_prev, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l_prev = l_prev * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, kv[1].float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m_prev = m_new
        if s + 1 < n:
            kv = ring_pass(kv, mesh, axis)
    l = torch.clamp(l_prev, min=1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh=None, axis: str = "sp") -> torch.Tensor:
    """Causal ring attention on this rank's ``[B, T/sp, H, D]`` blocks of
    ``mesh`` (a ``parallel.Mesh``) along ``axis``. With no mesh, or an
    axis of size 1, the blocks are the whole sequence and the dense path
    runs (JAX ``:102-105``)."""
    if mesh is None or mesh.size(axis) == 1:
        from .attention import dot_product_attention, make_causal_mask
        mask = make_causal_mask(q.shape[1], device=q.device)[None, None]
        return dot_product_attention(q, k, v, mask)
    return _ring_body(q, k, v, mesh, axis)
