"""Paged-attention decode: the hand-written CUDA kernel, its plain PyTorch
versions, the host planner of its split, and the dispatch between them.

Every decode step attends one fresh query per slot over that slot's
paged KV context. The kernel (``csrc/paged_attention.cu``, replacing the
JAX package's Pallas ``ops/paged_attention.py:_decode_kernel``) splits
each slot's context into chunks of ``C`` positions (flash-decoding): one
block per (kv head, slot, chunk) reads the pages its chunk names and
writes an f32 partial ``(acc, m, l)``; a second kernel of the same call
folds the partials and the step's own fresh ``(k, v)`` (the final
column: they are not in the pool yet, the engine writes them after the
forward) and normalises. GQA heads share their kv head's loads.
Positions at or past ``seq_lens`` are never read.

:func:`plan_split` is the host planner: ``C`` and the number of splits
from the table's width alone, so a call reads nothing back from the
card. :func:`paged_decode_reference` is the plain version: gather,
concatenate, repeat heads, :func:`ops.attention.cached_attention`. It is
the CPU path and the oracle the kernel is held against on the card
(chip_smoke.py). :func:`paged_decode_split_reference` is the plain
version of the kernel's decomposition (partials per chunk, then the
merge), used by the tests and chip_smoke.py only.

Dispatch (:func:`paged_attention`) is by the device of the tensors it is
given: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise. There is no fallback from a failed build or launch.

Layouts match the JAX package: q / k_new / v_new ``[B, 1, H(kv), D]``;
one layer's pool ``[pages, P, Hkv, D]``; ``page_tables [B, MP]`` int32
(padded entries point at trash page 0); ``seq_lens [B]`` int32, each
slot's real context length.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _cuda
from .attention import cached_attention

# kernel launches since the count was last set to 0 (one per call of
# paged_decode_attention that launched; the plain version never counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
# least context positions a block of the split kernel covers
_CHUNK = 64
# what dt_paged_decode returns, before it launches, for a call it does not
# take (such as a page too long for a chunk's rows to fit shared memory)
_CUDA_ERROR_INVALID_VALUE = 1


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel splits the context: ``chunk`` positions a block
    (a multiple of the page size), ``splits`` chunks across the table's
    ``MP * P`` positions, ``blocks`` in the split kernel's grid."""

    chunk: int
    splits: int
    blocks: int


@functools.cache
def plan_split(max_pages: int, page_size: int, batch: int,
               n_kv_heads: int) -> SplitPlan:
    """The split of a call from the table's shape alone (never from
    ``seq_lens``, whose values live on the card): chunks of at least
    ``_CHUNK`` positions made of whole pages (one page when a page is
    longer), no longer than the table, ``ceil(MP * P / C)`` of them.
    Cached per shape: a decode step calls it once a layer."""
    width = max_pages * page_size
    chunk = min(page_size * -(-_CHUNK // page_size), width)
    splits = -(-width // chunk)
    return SplitPlan(chunk, splits, batch * n_kv_heads * splits)


@functools.cache
def _kernel():
    """``dt_paged_decode`` from the built library, with its C signature
    (every pointer and the stream as c_void_p, so none is cut to 32
    bits)."""
    fn = _cuda.load("paged_attention").dt_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Returns
    ``[B, 1, Hq, D]``. Raises ValueError on anything the kernel does not
    take (a CPU tensor included) and RuntimeError if the launch fails."""
    global launches
    B, Tq, Hq, D = q.shape
    pool, P, Hkv, Dk = k_pages.shape
    MP = page_tables.shape[1] if page_tables.dim() == 2 else -1
    tensors = (q, k_pages, v_pages, page_tables, seq_lens, k_new, v_new)
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors):
        raise ValueError("paged_decode_attention needs every tensor on one "
                         "CUDA device")
    if Tq != 1:
        raise ValueError(f"decode is one query per slot, got Tq={Tq}")
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_pages, v_pages, k_new, v_new)):
        raise ValueError(
            f"q/pages/k_new/v_new must share one of {list(_DTYPES)}, got "
            f"{[t.dtype for t in (q, k_pages, v_pages, k_new, v_new)]}")
    if page_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_tables and seq_lens must be int32")
    if (Dk != D or D not in _HEAD_DIMS or Hq % Hkv
            or Hq // Hkv > _MAX_GROUP or B < 1 or MP < 1
            or page_tables.shape[0] != B or tuple(seq_lens.shape) != (B,)
            or k_new.shape != (B, 1, Hkv, D) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape):
        raise ValueError(
            f"unsupported shapes: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, tables {tuple(page_tables.shape)}, "
            f"seq_lens {tuple(seq_lens.shape)}, k_new {tuple(k_new.shape)} "
            f"(head_dim in {_HEAD_DIMS}, Hq/Hkv <= {_MAX_GROUP})")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the pool slices must be contiguous")
    plan = plan_split(MP, P, B, Hkv)
    # q/k_new/v_new arrive as strided views of the fused QKV split
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    page_tables, seq_lens = page_tables.contiguous(), seq_lens.contiguous()
    # the kernel reads rows 16 bytes at a time
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_new, v_new)):
        raise ValueError("q, the pools, k_new and v_new must start 16-byte "
                         "aligned")
    part = torch.empty((B, Hq, plan.splits, D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), part.data_ptr(), out.data_ptr(), B, Hq, Hkv,
            D, P, MP, plan.chunk, plan.splits, _DTYPES[q.dtype],
            q.device.index, stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"paged_decode_attention: the kernel does not take "
                         f"pages {tuple(k_pages.shape)}, tables "
                         f"{tuple(page_tables.shape)}, {q.dtype}")
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err} at "
                           "launch")
    launches += 1
    return out


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """The plain version: gather the table's pages into a padded
    context, append the fresh column, repeat GQA heads, and run
    :func:`ops.attention.cached_attention`."""
    B, Tq, Hq, D = q.shape
    _, P, Hkv, _ = k_pages.shape
    MP = page_tables.shape[1]
    idx = page_tables.long()
    k_ctx = k_pages[idx].reshape(B, MP * P, Hkv, D)
    v_ctx = v_pages[idx].reshape(B, MP * P, Hkv, D)
    k_full = torch.cat([k_ctx, k_new], dim=1)
    v_full = torch.cat([v_ctx, v_new], dim=1)
    if Hkv != Hq:
        rep = Hq // Hkv
        k_full = k_full.repeat_interleave(rep, dim=2)
        v_full = v_full.repeat_interleave(rep, dim=2)
    return cached_attention(q, k_full, v_full, seq_lens)


def paged_decode_split_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_tables: torch.Tensor,
                                 seq_lens: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor,
                                 chunk: int | None = None) -> torch.Tensor:
    """The plain version of the kernel's decomposition, in f32: per chunk
    of ``chunk`` context positions (the planner's by default) the max
    ``m``, sum ``l`` and unnormalised ``acc`` over its positions below
    ``min(seq_len, MP * P)``, then one merge of the chunks and the fresh
    column. Positions past the context take no part (their rows are
    zeroed before any product, as the kernel never reads them)."""
    B, _, Hq, D = q.shape
    _, P, Hkv, _ = k_pages.shape
    MP = page_tables.shape[1]
    G, width = Hq // Hkv, MP * P
    if chunk is None:
        chunk = plan_split(MP, P, B, Hkv).chunk
    splits = -(-width // chunk)
    pad = splits * chunk - width
    pos = torch.arange(splits * chunk, device=q.device)
    ctx = seq_lens.long().clamp(0, width)
    valid = pos[None, :] < ctx[:, None]                      # [B, S C]
    idx = page_tables.long()

    def rows(pages):
        x = pages[idx].reshape(B, width, Hkv, D).float()
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return torch.where(valid[:, :, None, None], x, 0.0)

    k, v = rows(k_pages), rows(v_pages)
    qg = q[:, 0].float().reshape(B, Hkv, G, D) * D ** -0.5
    s = torch.einsum("bhgd,bthd->bhgt", qg, k)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    s = s.reshape(B, Hkv, G, splits, chunk)
    m = s.amax(-1)                                        # -inf if empty
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgsc,bschd->bhgsd", p,
                       v.reshape(B, splits, chunk, Hkv, D))
    # the merge: the fresh column, then every chunk
    s_new = torch.einsum("bhgd,bhd->bhg", qg, k_new[:, 0].float())
    mx = torch.maximum(s_new, m.amax(-1))
    w_new = torch.exp(s_new - mx)
    w = torch.exp(m - mx[..., None])                      # 0 if empty
    num = (w_new[..., None] * v_new[:, 0].float()[:, :, None]
           + (w[..., None] * acc).sum(-2))
    den = w_new + (w * l).sum(-1)
    out = num / den[..., None]
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    seq_lens: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> torch.Tensor:
    """Model-facing entry (the GPT-2 decode block): the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_tables,
                                      seq_lens, k_new, v_new)
    return paged_decode_attention(q, k_pages, v_pages, page_tables,
                                  seq_lens, k_new, v_new)
