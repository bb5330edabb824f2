"""Paged-attention decode: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatch between them.

Every decode step attends one fresh query per slot over that slot's
paged KV context. The kernel (``csrc/paged_attention.cu``, replacing the
JAX package's Pallas ``ops/paged_attention.py:_decode_kernel``) walks each
slot's page table and reads exactly the pages it names, runs an f32
online softmax, groups GQA heads without repeating K/V, and folds the
step's own fresh ``(k, v)`` in as the final column: they are not in the
pool yet (the engine writes them after the forward). Positions at or past
``seq_lens`` are skipped.

:func:`paged_decode_reference` is the plain version: gather, concatenate,
repeat heads, :func:`ops.attention.cached_attention`. It is the CPU path
and the oracle the kernel is held against on the card (chip_smoke.py).

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


@functools.cache
def _kernel():
    """``dt_paged_decode`` from the built library, with its C signature
    (every pointer and the stream as c_void_p, so none is cut to 32
    bits)."""
    fn = _cuda.load("paged_attention").dt_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
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
    # q/k_new/v_new arrive as strided views of the fused QKV split
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    page_tables, seq_lens = page_tables.contiguous(), seq_lens.contiguous()
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, P, MP,
            _DTYPES[q.dtype], q.device.index, stream)
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
