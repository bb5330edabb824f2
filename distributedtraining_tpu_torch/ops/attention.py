"""Causal self-attention in PyTorch — the port of the JAX package's
``ops/attention.py``.

- ``dot_product_attention``: scores in f32, f32 softmax, probabilities
  rounded to the value dtype before PV — the reference's rounding points.
- ``blockwise_attention``: the forward of the JAX package's lax-flash
  spelling, a plain loop over query/key blocks with an online softmax;
  no ``[T, T]`` score matrix exists.
- ``cached_attention``: decode-step attention over a padded cached
  context plus the step's own tokens.
- ``causal_attention``: the models' entry point. ``impl="flash"``
  without a padding mask runs ``ops.flash_attention.flash_attention`` (the
  CUDA kernels on the card, their plain versions on the CPU), with
  ``segment_ids`` as its packing mask. With a padding mask it takes the
  path the JAX package takes when its Pallas kernel declines the mask
  (serving prefill always passes one): blockwise at
  ``T >= BLOCKWISE_FALLBACK_LEN``, dense below. On a mesh whose sp axis
  splits the positions (``sp=``) it takes one of two routes: the ring
  (``ops/ring_attention.py``) for ``impl="ring"`` without a padding
  mask or segment ids, as JAX routes it; else the gathered route, which
  all-gathers q, k and v over sp, runs the attention above on the whole
  sequence with the whole row's masks (the flash kernels for
  ``impl="flash"``: the computation of JAX's flash call on its global
  arrays) and keeps this rank's query rows. The gathered route costs sp
  times one rank's share of the attention.

Every path is differentiable by autograd; the flash path through its own
backward kernels.

Shapes: q, k, v are ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention

NEG_INF = -1e9

# dense materializes [B, H, T, T] scores; at and above this length the
# padded-mask flash path streams blocks instead
BLOCKWISE_FALLBACK_LEN = 1024


def make_causal_mask(q_len: int, kv_len: int | None = None, *,
                     q_offset: int = 0,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """Boolean ``[q_len, kv_len]`` mask, True = may attend."""
    kv_len = q_len if kv_len is None else kv_len
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return q_pos >= kv_pos


def combine_masks(causal: torch.Tensor,
                  attention_mask: Optional[torch.Tensor],
                  segment_ids: Optional[torch.Tensor],
                  kv_segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Fold padding (``attention_mask [B, kv_len]``, 1 = real token) and
    packing (``segment_ids [B, q_len]``) into the causal mask. Returns
    ``[B, 1, q_len, kv_len]`` boolean."""
    mask = causal[None, None, :, :]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].bool()
    if segment_ids is not None:
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        same = segment_ids[:, :, None] == kv_seg[:, None, :]
        mask = mask & same[:, None, :, :]
    return mask


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked attention with f32 scores and softmax.

    ``mask`` broadcasts to ``[B, H, Tq, Tkv]``, True = attend. The
    products of the inputs are exact in f32, so casting before the
    einsum is the JAX package's ``preferred_element_type=float32``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *,
                        attention_mask: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        block_q: int = 512,
                        block_kv: int = 512) -> torch.Tensor:
    """Causal attention as a loop over query/key blocks with an online
    softmax, in f32 throughout, cast to ``q.dtype`` at the end.

    Key blocks wholly in the future of a query block are skipped. Masked
    entries are zeroed after the exp, so a row with no visible key emits
    exact 0 (the JAX package's convention). The ragged last block is
    simply shorter: the JAX spelling pads it with masked keys, whose
    contribution is exactly 0."""
    B, T, H, D = q.shape
    bq, bkv = min(block_q, T), min(block_kv, T)
    qf = q.float() * D ** -0.5
    kf = k.float()
    vf = v.float()
    kvalid = None if attention_mask is None else attention_mask.bool()
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, bq):
        q1 = min(q0 + bq, T)
        q_tile = qf[:, q0:q1]
        acc = torch.zeros((B, q1 - q0, H, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q1 - q0), dtype=torch.float32,
                        device=q.device)
        for k0 in range(0, q1, bkv):      # causally dead blocks skipped
            k1 = min(k0 + bkv, T)
            scores = torch.einsum("bqhd,bkhd->bhqk", q_tile, kf[:, k0:k1])
            mask = (pos[q0:q1, None] >= pos[None, k0:k1])[None]
            if kvalid is not None:
                mask = mask & kvalid[:, None, k0:k1]
            if segment_ids is not None:
                mask = mask & (segment_ids[:, q0:q1, None]
                               == segment_ids[:, None, k0:k1])
            mask = mask[:, None]                              # [B,1,q,k]
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None]) * mask
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, vf[:, k0:k1])
            acc = acc * alpha.transpose(1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, q0:q1] = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ctx_lens: torch.Tensor) -> torch.Tensor:
    """Decode-step attention for KV-cache generation.

    ``q`` is ``[B, Tq, H, D]``; ``k``/``v`` are the padded cached context
    concatenated with the step's own keys/values, ``[B, S + Tq, H, D]``.
    Context positions at or past ``ctx_lens[b]`` are masked; the trailing
    Tq positions are causal among themselves and always visible to
    themselves. Masked scores take ``NEG_INF``, whose exp underflows to
    exact 0, so garbage in dead cache slots cannot reach the output."""
    B, Tq, _, depth = q.shape
    S = k.shape[1] - Tq
    scale = depth ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(S + Tq, device=q.device)[None, None, :]
    q_pos = torch.arange(Tq, device=q.device)[None, :, None]
    valid = (kv_pos < ctx_lens.to(q.device)[:, None, None]) | (
        (kv_pos >= S) & (kv_pos - S <= q_pos))               # [B, Tq, S+Tq]
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *,
                     attention_mask: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None,
                     impl: str = "dense", sp=None) -> torch.Tensor:
    """Causal self-attention entry point used by the models.

    impl: "dense", "blockwise", "flash" or "ring". "flash" runs the
    flash kernels unless a padding mask is present (the kernel declines
    those in the JAX package too). ``sp`` is a ``parallel.Mesh`` whose
    sp axis splits the positions, q, k and v being this rank's
    ``[B, T/sp, H, D]`` and the masks the whole row's ``[B, T]`` (the
    module docstring gives the two routes). "ring" without such a mesh,
    or with a mask, is dense attention, as in JAX."""
    if sp is not None and sp.size("sp") > 1:
        if impl == "ring" and attention_mask is None and segment_ids is None:
            from .ring_attention import ring_attention
            return ring_attention(q, k, v, mesh=sp)
        return _gathered(q, k, v, attention_mask, segment_ids, impl, sp)
    if impl == "ring":
        impl = "dense"
    T = q.shape[1]
    if impl == "blockwise":
        return blockwise_attention(q, k, v, attention_mask=attention_mask,
                                   segment_ids=segment_ids)
    if impl == "flash":
        if attention_mask is None:
            return flash_attention(q, k, v, segment_ids)
        if T >= BLOCKWISE_FALLBACK_LEN:
            return blockwise_attention(q, k, v,
                                       attention_mask=attention_mask,
                                       segment_ids=segment_ids)
    elif impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    mask = combine_masks(make_causal_mask(T, device=q.device),
                         attention_mask, segment_ids)
    return dot_product_attention(q, k, v, mask)


def _gathered(q, k, v, attention_mask, segment_ids, impl: str, mesh
              ) -> torch.Tensor:
    """The gathered route: q, k and v all-gathered over sp along T in one
    collective (its backward reduce-scatters their cotangents), the
    attention of the whole sequence, this rank's query rows kept."""
    from ..parallel.collectives import all_gather
    Tl = q.shape[1]
    qkv = all_gather(torch.stack([q, k, v], dim=2), mesh, "sp", 1)
    out = causal_attention(*qkv.unbind(2), attention_mask=attention_mask,
                           segment_ids=segment_ids, impl=impl)
    i = mesh.index("sp")
    return out[:, i * Tl:(i + 1) * Tl]
