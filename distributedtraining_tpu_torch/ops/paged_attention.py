"""Paged attention: the hand-written CUDA kernels, their plain PyTorch
versions, the host planner of the decode kernel's split, and the dispatch
between them.

Every decode step attends one fresh query per slot over that slot's
paged KV context. The decode kernel (``csrc/paged_attention.cu``,
replacing the JAX package's Pallas ``ops/paged_attention.py:_decode_kernel``)
splits each slot's context into chunks of ``C`` positions
(flash-decoding): one block per (kv head, slot, chunk) reads the pages its
chunk names and writes an f32 partial ``(acc, m, l)``; a second kernel of
the same call folds the partials and the step's own fresh ``(k, v)`` (the
final column: they are not in the pool yet, the engine writes them after
the forward) and normalises. GQA heads share their kv head's loads.
Positions at or past ``seq_lens`` are never read.

The window kernel (same source) takes ``W > 1`` queries a slot (the
speculative verify, the prefix cache's suffix prefill): query ``t`` sees
the slot's context below ``seq_lens`` and the window's own fresh rows
``0..t``. The JAX package computes this in XLA, not in a Pallas kernel.
In bf16 it runs on the tensor cores: 64-row tiles of (query, head of the
group) rows against 64-row key tiles (the context's, then the window's),
P split into two bf16 parts before PV, the walk split across blocks when
the grid is short and the f32 partials merged; in f32 it runs on the CUDA
cores in one kernel.

:func:`plan_split` and :func:`plan_window` are the host planners: the
splits from the shapes alone, so a call reads nothing back from the
card. :func:`paged_decode_reference` is the plain version of both kernels
(gather, concatenate, repeat heads, :func:`ops.attention.cached_attention`):
the CPU path and the oracle the kernels are held against on the card
(chip_smoke.py). :func:`paged_decode_split_reference` and
:func:`paged_window_split_reference` are the plain versions of the
kernels' decompositions (partials per chunk, then the merge), used by the
tests and chip_smoke.py only.

Dispatch (:func:`paged_attention`) is by the device of the tensors it is
given: CPU tensors take the plain version; CUDA tensors launch the decode
kernel (one query a slot) or the window kernel, or raise. There is no
fallback from a failed build or launch.

Layouts match the JAX package: q / k_new / v_new ``[B, Tq, H(kv), D]``;
one layer's pool ``[pages, P, Hkv, D]``; ``page_tables [B, MP]`` int32
(padded entries point at trash page 0); ``seq_lens [B]`` int32, each
slot's real context length.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils import devprof
from . import _cuda
from .attention import cached_attention

# kernel launches since the counts were last set to 0: one per call of
# paged_decode_attention (launches) or paged_window_attention
# (window_launches) that launched; the plain version never counts
launches = 0
window_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
# least context positions a block of the split kernel covers
_CHUNK = 64
# the window kernel's query and key tiles (rows), and the blocks its split
# aims for: three an SM of an H100's 132, what the D 64 ring lets reside
# at once
_WIN_TILE = 64
_WIN_BLOCKS = 3 * 132
_MAX_GRID_Z = 65535
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


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """How the bf16 window kernel splits its walk: the key tiles (64
    rows: the context's ``ceil(MP * P / 64)``, then the window's
    ``ceil(W / 64)``) run in ``splits`` ranges of ``tiles``."""

    tiles: int
    splits: int


@functools.cache
def plan_window(window: int, group: int, max_pages: int, page_size: int,
                batch: int, n_kv_heads: int) -> WindowPlan:
    """The window kernel's split from shapes alone: one block a (64-row
    tile of the ``W * G`` query rows, kv head, slot) and split, with as
    many splits as keep the grid within ``_WIN_BLOCKS``, one wave (none
    past one key tile a split, nor past the grid's z limit of 65535 over
    the batch): 4 splits at the verify (B 8, W 5, 12 heads, a 1024-row
    table) and at a 512-row suffix, 17 of one tile at a 64-row one."""
    key_tiles = (-(-max_pages * page_size // _WIN_TILE)
                 + -(-window // _WIN_TILE))
    base = -(-window * group // _WIN_TILE) * n_kv_heads * batch
    want = max(1, min(key_tiles, _WIN_BLOCKS // base, _MAX_GRID_Z // batch))
    tiles = -(-key_tiles // want)
    splits = -(-key_tiles // tiles)
    return WindowPlan(tiles, splits)


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
    _report_cost(q, k_pages, page_tables, seq_lens)
    return out


def _report_cost(q, k_pages, page_tables, seq_lens) -> None:
    """One launch's count for the device observatory's cost probe
    (``utils/devprof.kernel_cost``; nothing when no probe is active),
    the count chip_smoke.py's bounds use: the K/V rows the seq_lens reach
    (a read of them to the host), q, the fresh rows, the output and the
    tables once; QK and PV (2 FLOPs a multiply-add) of every visible
    (query, key) pair."""
    def cost():
        B, W, Hq, D = q.shape
        _, P, Hkv, _ = k_pages.shape
        MP = page_tables.shape[1]
        elt = q.element_size()
        ctx = [min(int(n), MP * P) for n in seq_lens.tolist()]
        nbytes = (sum(ctx) * Hkv * D * 2 * elt
                  + B * W * (2 * Hq + 2 * Hkv) * D * elt
                  + page_tables.numel() * 4 + B * 4)
        pairs = sum(W * c + W * (W + 1) // 2 for c in ctx)
        return 4 * pairs * Hq * D, nbytes
    devprof.kernel_cost(cost)


@functools.cache
def _window_kernel():
    """``dt_paged_window`` from the built library, with its C signature."""
    fn = _cuda.load("paged_attention").dt_paged_window
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _window_split_kernel():
    """``dt_paged_window_split`` from the built library, with its C
    signature."""
    fn = _cuda.load("paged_attention").dt_paged_window_split
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_window_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """Launch the window kernel on the current stream: ``W`` queries a
    slot, query ``t`` over the slot's paged context below ``seq_lens``
    and the fresh rows ``0..t`` of ``k_new``/``v_new [B, W, Hkv, D]``.
    Returns ``[B, W, Hq, D]``. Raises ValueError on anything the kernel
    does not take (a CPU tensor included) and RuntimeError if the launch
    fails."""
    global window_launches
    B, W, Hq, D = q.shape
    _, P, Hkv, Dk = k_pages.shape
    MP = page_tables.shape[1] if page_tables.dim() == 2 else -1
    tensors = (q, k_pages, v_pages, page_tables, seq_lens, k_new, v_new)
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors):
        raise ValueError("paged_window_attention needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_pages, v_pages, k_new, v_new)):
        raise ValueError(
            f"q/pages/k_new/v_new must share one of {list(_DTYPES)}, got "
            f"{[t.dtype for t in (q, k_pages, v_pages, k_new, v_new)]}")
    if page_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_tables and seq_lens must be int32")
    if (Dk != D or D not in _HEAD_DIMS or Hq % Hkv or B < 1 or W < 1
            or MP < 1 or page_tables.shape[0] != B
            or tuple(seq_lens.shape) != (B,)
            or k_new.shape != (B, W, Hkv, D) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape):
        raise ValueError(
            f"unsupported shapes: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, tables {tuple(page_tables.shape)}, "
            f"seq_lens {tuple(seq_lens.shape)}, k_new {tuple(k_new.shape)} "
            f"(head_dim in {_HEAD_DIMS})")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the pool slices must be contiguous")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    page_tables, seq_lens = page_tables.contiguous(), seq_lens.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_new, v_new)):
        raise ValueError("q, the pools, k_new and v_new must start 16-byte "
                         "aligned")
    out = torch.empty((B, W, Hq, D), dtype=q.dtype, device=q.device)
    # the f32 route walks in one kernel; bf16 splits when the grid is short
    plan = (plan_window(W, Hq // Hkv, MP, P, B, Hkv)
            if q.dtype == torch.bfloat16 else None)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan is None or plan.splits == 1:
        err = _window_kernel()(
            *ptrs, out.data_ptr(), B, W, Hq, Hkv, D, P, MP,
            _DTYPES[q.dtype], q.device.index, stream)
    else:
        rows = W * (Hq // Hkv)
        part = torch.empty((B, Hkv, rows, plan.splits, D + 4),
                           dtype=torch.float32, device=q.device)
        err = _window_split_kernel()(
            *ptrs, part.data_ptr(), out.data_ptr(), B, W, Hq, Hkv, D, P, MP,
            plan.tiles, plan.splits, q.device.index, stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"paged_window_attention: the kernel does not take "
                         f"q {tuple(q.shape)}, tables "
                         f"{tuple(page_tables.shape)}, {q.dtype}")
    if err != 0:
        raise RuntimeError(f"paged_window_attention: CUDA error {err} at "
                           "launch")
    window_launches += 1
    _report_cost(q, k_pages, page_tables, seq_lens)
    return out


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels: gather the table's pages into a
    padded context, append the fresh rows (one, or a window of ``Tq``),
    repeat GQA heads, and run :func:`ops.attention.cached_attention`."""
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


_LOG2E = 1.4426950408889634


def _pv(p: torch.Tensor, v: torch.Tensor, p_parts: int) -> torch.Tensor:
    """``p @ v`` over the key axis (``p [..., S, T]``, ``v [B, S, T, Hkv,
    D]``) with ``p`` in f32 (``p_parts`` 0), rounded once to bf16 (1), or
    as ``bf16(p) + bf16(p - bf16(p))``, two products (2)."""
    def mm(x):
        return torch.einsum("bhrst,bsthd->bhrsd", x, v)
    if p_parts == 0:
        return mm(p)
    hi = p.to(torch.bfloat16).float()
    if p_parts == 1:
        return mm(hi)
    return mm(hi) + mm((p - hi).to(torch.bfloat16).float())


def window_split_partials(q, k_pages, v_pages, page_tables, seq_lens, k_new,
                          v_new, tiles: int | None = None,
                          p_parts: int | None = None):
    """The window kernel's walk, in f32: rows ``t * G + g`` of kv head
    ``h`` (query ``t``, query head ``h * G + g``) against 64-row key
    tiles, the context's (``ceil(MP * P / 64)``, positions below
    ``min(seq_len, MP * P)`` visible) then the window's (fresh row ``f``
    visible to ``t >= f``), in ranges of ``tiles`` a split (the planner's
    by default). Each split runs an online softmax tile by tile in log2
    units (exp2, ``log2(e) / sqrt(D)`` folded into the scale) with PV as
    :func:`_pv` (``p_parts``: 2 for bf16 inputs, as the kernel, else 0).
    Returns per split ``m``, ``l`` ``[B, Hkv, W G, S]`` (``-inf`` and 0
    where a row saw nothing) and ``acc`` ``[B, Hkv, W G, S, D]``. Rows
    past a context are zeroed before any product, as the kernel never
    reads them."""
    B, W, Hq, D = q.shape
    _, P, Hkv, _ = k_pages.shape
    MP = page_tables.shape[1]
    G, T, width = Hq // Hkv, _WIN_TILE, MP * P
    R = W * G
    n_ctx, n_fresh = -(-width // T), -(-W // T)
    if tiles is None:
        tiles = plan_window(W, G, MP, P, B, Hkv).tiles
    if p_parts is None:
        p_parts = 2 if q.dtype == torch.bfloat16 else 0
    S = -(-(n_ctx + n_fresh) // tiles)
    length = S * tiles * T
    dev = q.device
    ctx = seq_lens.long().clamp(0, width)
    pos = torch.arange(width, device=dev)
    live = (pos[None, :] < ctx[:, None])[:, :, None, None]
    pad = torch.nn.functional.pad

    def keys(pages, new):
        x = pages[page_tables.long()].reshape(B, width, Hkv, D).float()
        x = pad(torch.where(live, x, 0.0),
                (0, 0, 0, 0, 0, n_ctx * T - width))
        y = pad(new.float(), (0, 0, 0, 0, 0, n_fresh * T - W))
        z = pad(torch.cat([x, y], 1), (0, 0, 0, 0, 0,
                                      length - (n_ctx + n_fresh) * T))
        return z.reshape(B, S, tiles, T, Hkv, D)

    k, v = keys(k_pages, k_new), keys(v_pages, v_new)
    kpos = torch.arange(length, device=dev)
    t_row = torch.arange(R, device=dev) // G
    in_ctx = kpos < n_ctx * T
    seen_ctx = in_ctx[None, None, :] & (kpos[None, None, :]
                                        < ctx[:, None, None])
    seen_fresh = ~in_ctx[None, None, :] & ((kpos - n_ctx * T)[None, None, :]
                                           <= t_row[None, :, None])
    vis = (seen_ctx | seen_fresh).reshape(B, 1, R, S, tiles, T)
    qr = (q.float().reshape(B, W, Hkv, G, D).permute(0, 2, 1, 3, 4)
          .reshape(B, Hkv, R, D))
    scale = _LOG2E / D ** 0.5
    m = torch.full((B, Hkv, R, S), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, R, S), device=dev)
    acc = torch.zeros((B, Hkv, R, S, D), device=dev)
    for i in range(tiles):
        s = torch.einsum("bhrd,bsthd->bhrst", qr, k[:, :, i]) * scale
        s = s.masked_fill(~vis[..., i, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # rows that have seen nothing keep m = -inf; exponents against 0
        m_use = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _pv(p, v[:, :, i], p_parts)
        m = m_new
    return m, l, acc


def window_split_merge(m, l, acc, q: torch.Tensor) -> torch.Tensor:
    """Fold :func:`window_split_partials`' splits into one softmax a row
    (every row saw its fresh row 0 in some split) and lay the rows out as
    ``q`` ``[B, W, Hq, D]``, in ``q``'s dtype."""
    B, W, Hq, D = q.shape
    Hkv = m.shape[1]
    mx = m.amax(-1)
    w = torch.exp2(m - mx[..., None])                  # 0 where empty
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]
    return (out.reshape(B, Hkv, W, Hq // Hkv, D).permute(0, 2, 1, 3, 4)
            .reshape(B, W, Hq, D).to(q.dtype))


def paged_window_split_reference(q, k_pages, v_pages, page_tables,
                                 seq_lens, k_new, v_new,
                                 tiles: int | None = None) -> torch.Tensor:
    """The plain version of the window kernel's decomposition: the
    split walk's partials (:func:`window_split_partials`, P in two bf16
    parts for bf16 inputs) and their merge. The CPU tests' and
    chip_smoke.py's mirror of the kernel; the CPU path of the window is
    :func:`paged_decode_reference`."""
    return window_split_merge(
        *window_split_partials(q, k_pages, v_pages, page_tables, seq_lens,
                               k_new, v_new, tiles), q)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    seq_lens: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> torch.Tensor:
    """Model-facing entry (the GPT-2 paged block): the plain version for
    CPU tensors; for CUDA tensors the decode kernel at one query a slot,
    the window kernel at more."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_tables,
                                      seq_lens, k_new, v_new)
    if q.shape[1] == 1:
        return paged_decode_attention(q, k_pages, v_pages, page_tables,
                                      seq_lens, k_new, v_new)
    return paged_window_attention(q, k_pages, v_pages, page_tables,
                                  seq_lens, k_new, v_new)
