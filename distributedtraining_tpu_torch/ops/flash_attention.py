"""Causal flash attention with packed-sequence ``segment_ids``: the
hand-written CUDA kernels, their plain PyTorch versions, the autograd
Function that ties them together, and the dispatch between them.

This replaces the JAX package's ``ops/flash_attention.py:flash_attention``,
which calls the Pallas TPU library kernels
(``jax/experimental/pallas/ops/tpu/flash_attention.py``: the forward
``_flash_attention_impl``, and behind its ``custom_vjp`` the backward
pair ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``). The
CUDA kernels (``csrc/flash_attention.cu``) compute the same function:

- forward: ``o = softmax(q k^T / sqrt(D) + mask) v`` with the causal and
  the ``segment_ids[q] == segment_ids[k]`` mask, an f32 online softmax,
  and the per-row log-sum-exp ``lse = m + log l`` saved for the backward
  (the library saves ``l`` and ``m`` apart; their sum in log space is the
  same information);
- backward, split like the library's so that no atomics are needed: a
  dk/dv kernel over key tiles and a dq kernel over query tiles, each
  recomputing ``P = exp(s - lse)`` from q, k and the saved lse.
  ``di = rowsum(o * do)`` is one plain PyTorch op outside the kernels, as
  the library computes it in XLA outside its kernels.

Unlike the TPU kernel, which the JAX package ran only at T >= 256 with
T % 128 == 0, the card's kernels take any T (the ragged last tile is
masked) and head dims 64 and 128. bf16 inputs run on the tensor cores
(``mma.sync``, f32 accumulation, P and dS rounded to bf16 before their
products, where the library rounds them); f32 inputs run in f32 FMA on
the CUDA cores, which agrees with the plain versions to summation order.

:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
are the plain versions: dense f32 scores with the same mask, and the same
backward formulas from the saved lse. They are the CPU path and the
oracle the kernels are held against on the card (chip_smoke.py).
:func:`visible_key_tiles` mirrors the rule by which the bf16 kernels
list the tiles they walk, and :func:`flash_attention_bwd_tiled_reference`
computes the backward along those lists, as the bf16 backward kernels
do (both for the tests and chip_smoke.py).

Dispatch is by the device of the tensors: CPU tensors take the plain
versions (forward and backward), CUDA tensors launch the kernels or
raise. There is no fallback from a failed build or launch. A padding mask
is not this function's input: ``ops.attention.causal_attention`` routes
padded batches to dense or blockwise attention, as the JAX package does.

Layout at the public function: q, k, v ``[B, T, H, D]``, any strides
with a unit last stride (they arrive as strided views of the fused QKV
projection, token stride 3E); ``segment_ids`` ``[B, T]`` integer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils import devprof
from . import _cuda

# kernel launches since the counts were last set to 0 (one per launch of
# that kernel; the plain versions never count)
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# what a C entry returns, before it launches, for a call it does not take
# (such as a T whose key-tile list would not fit the bf16 forward's shared
# memory)
_CUDA_ERROR_INVALID_VALUE = 1


@functools.cache
def _kernels() -> dict:
    """The three C entry points of the built library, with their
    signatures (pointers and the stream as c_void_p, so none is cut to 32
    bits; strides as a pointer to int64)."""
    lib = _cuda.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_int64)
    fns = {"fwd": (lib.dt_flash_fwd, 6),
           "dkv": (lib.dt_flash_bwd_dkv, 9),
           "dq": (lib.dt_flash_bwd_dq, 8)}
    out = {}
    for name, (fn, n_ptrs) in fns.items():
        fn.argtypes = ([ptr] * n_ptrs + [i32] * 4 + [strides]
                       + [i32, i32, ptr])
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _check(q, k, v, segment_ids, do=None, lse=None, di=None) -> None:
    """Raise ValueError on anything the kernels do not take; ``do``,
    ``lse`` and ``di`` are the backward kernels' extra inputs."""
    more = () if do is None else (do, lse, di)
    tensors = (q, k, v, *more) + (() if segment_ids is None
                                  else (segment_ids,))
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors):
        raise ValueError("the flash attention kernels need every tensor "
                         "on one CUDA device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, T, H, D = q.shape
    if D not in _HEAD_DIMS or B < 1 or T < 1 or H < 1:
        raise ValueError(f"unsupported shape {tuple(q.shape)} (head_dim in "
                         f"{_HEAD_DIMS})")
    views = [t for t in (q, k, v, *more) if t.dim() == 4]
    if any(t.stride(-1) != 1 for t in views):
        raise ValueError("the head dim of q, k, v and do must be contiguous")
    # the bf16 kernels read rows 16 bytes at a time
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in views):
        raise ValueError("bf16 q, k, v and do must have rows that start "
                         "16-byte aligned (strides multiples of 8)")
    if segment_ids is not None and (segment_ids.shape != (B, T)
                                    or segment_ids.dtype != torch.int32
                                    or not segment_ids.is_contiguous()):
        raise ValueError("segment_ids must be a contiguous int32 [B, T]")
    if do is not None and (
            do.shape != q.shape or do.dtype != q.dtype
            or any(t.shape != (B, H, T) or t.dtype != torch.float32
                   or not t.is_contiguous() for t in (lse, di))):
        raise ValueError("do must match q; lse and di must be contiguous "
                         "f32 [B, H, T]")


def _strides(*tensors) -> ctypes.Array:
    """Element strides (batch, token, head) of each [B, T, H, D] view."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _seg_ptr(segment_ids) -> int | None:
    return None if segment_ids is None else segment_ids.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: the kernel does not take this shape")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1


def visible_pairs(B: int, T: int, H: int, segment_ids) -> int:
    """(query, key) pairs the causal and segment mask leave visible: per
    document of n tokens, n (n + 1) / 2 (a read of the ids to the
    host)."""
    import numpy as np
    if segment_ids is None:
        return B * H * T * (T + 1) // 2
    total = 0
    for row in segment_ids.detach().cpu().numpy()[:B, :T]:
        _, counts = np.unique(row, return_counts=True)
        total += int(sum(int(n) * (int(n) + 1) // 2 for n in counts))
    return H * total


# each kernel's (bytes, FLOPs) over n = B T H D elements of one [B, T, H,
# D] tensor, rows = B H T f32 rows (lse, di) and the visible pairs: the
# count chip_smoke.py's bounds use (2 D FLOPs a pair and product; the
# forward two products, dk/dv four with the recomputed scores, dq three)
_COST = {"flash_attention_fwd": (4, 1, 4),
         "flash_attention_bwd_dkv": (6, 2, 8),
         "flash_attention_bwd_dq": (5, 2, 6)}


def _report_cost(name: str, q: torch.Tensor, segment_ids) -> None:
    """The launch's count for the device observatory's cost probe
    (``utils/devprof.kernel_cost``; nothing when no probe is active)."""
    def cost():
        B, T, H, D = q.shape
        n = B * T * H * D * q.element_size()
        rows = B * H * T * 4
        segb = 0 if segment_ids is None else B * T * 4
        tensors, row_sets, per_pair = _COST[name]
        return (per_pair * D * visible_pairs(B, T, H, segment_ids),
                tensors * n + row_sets * rows + segb)
    devprof.kernel_cost(cost)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream. Returns ``o``
    ``[B, T, H, D]`` (contiguous, q's dtype) and ``lse`` ``[B, H, T]``
    f32. Raises ValueError on anything the kernel does not take (a CPU
    tensor included) and RuntimeError if the launch fails."""
    _check(q, k, v, segment_ids)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
            o.data_ptr(), lse.data_ptr(), B, T, H, D, _strides(q, k, v),
            _DTYPES[q.dtype], q.device.index, stream)
    _raise_on(err, "flash_attention_fwd")
    _report_cost("flash_attention_fwd", q, segment_ids)
    return o, lse


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * do)`` in f32, ``[B, H, T]`` contiguous."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dkv(q, k, v, do, lse, di, segment_ids=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel. ``lse`` and ``di`` are f32 ``[B, H, T]``
    contiguous; ``do`` any [B, T, H, D] strides with a unit last stride.
    Returns contiguous ``(dk, dv)`` in q's dtype."""
    _check(q, k, v, segment_ids, do, lse, di)
    B, T, H, D = q.shape
    dk = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, H, D, _strides(q, k, v, do),
            _DTYPES[q.dtype], q.device.index, stream)
    _raise_on(err, "flash_attention_bwd_dkv")
    _report_cost("flash_attention_bwd_dkv", q, segment_ids)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, segment_ids=None
                           ) -> torch.Tensor:
    """Launch the dq kernel (arguments as for the dk/dv kernel). Returns
    a contiguous ``dq`` in q's dtype."""
    _check(q, k, v, segment_ids, do, lse, di)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            B, T, H, D, _strides(q, k, v, do), _DTYPES[q.dtype],
            q.device.index, stream)
    _raise_on(err, "flash_attention_bwd_dq")
    _report_cost("flash_attention_bwd_dq", q, segment_ids)
    return dq


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def visible_key_tiles(segment_ids: torch.Tensor, T: int,
                      tile: int = 64) -> torch.Tensor:
    """The tile pairs the bf16 kernels walk: ``[B, n, n]`` boolean (query
    tile, key tile), ``n = ceil(T / tile)``. Key tile ``kt`` is listed for
    query tile ``qt`` when ``kt <= qt`` and the range ``[min, max]`` of its
    real rows' segment ids meets the query tile's range. The forward and
    the dq kernel walk a row (the key tiles of one query tile, the
    diagonal first); the dk/dv kernel walks the transpose, a column (the
    query tiles of one key tile, the diagonal first). The rule is
    conservative (pairs inside a listed tile are still masked one by one)
    and holds for ids in any order. A mirror of the kernels' rule for the
    tests; not on the main path."""
    ids = segment_ids[:, :T].to(torch.int64)
    B, n = ids.shape[0], -(-T // tile)
    pad = n * tile - T
    big = 1 << 40  # past any int32 id (and exact as a pad value)
    lo = torch.nn.functional.pad(ids, (0, pad), value=big)
    hi = torch.nn.functional.pad(ids, (0, pad), value=-big)
    lo = lo.reshape(B, n, tile).amin(-1)
    hi = hi.reshape(B, n, tile).amax(-1)
    meets = ((lo[:, None, :] <= hi[:, :, None])
             & (hi[:, None, :] >= lo[:, :, None]))
    causal = torch.ones(n, n, dtype=torch.bool).tril()
    return meets & causal.to(meets.device)


def _mask(T: int, segment_ids, device) -> torch.Tensor:
    """``[B or 1, 1, T, T]`` boolean, True = query row may attend key
    column: causal, and the same segment when ``segment_ids`` is given."""
    pos = torch.arange(T, device=device)
    mask = (pos[:, None] >= pos[None, :])[None, None]
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        mask = mask & same[:, None]
    return mask


def _probs(q, k, lse, mask) -> torch.Tensor:
    """``P = exp(q k^T / sqrt(D) - lse)`` in f32, exactly 0 where masked."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: dense f32 scores, the causal and segment mask,
    ``lse = m + log l`` per row, ``o = exp(s - lse) v``. Returns ``o`` in
    q's dtype ``[B, T, H, D]`` and ``lse`` f32 ``[B, H, T]``."""
    T, scale = q.shape[1], q.shape[-1] ** -0.5
    mask = _mask(T, segment_ids, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1))
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  segment_ids: Optional[torch.Tensor] = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain backward, with the kernels' formulas from the saved lse:
    ``P = exp(s - lse)``, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P (dP - di)`` with ``di = rowsum(o dO)``, ``dQ = dS K / sqrt(D)``,
    ``dK = dS^T Q / sqrt(D)``. f32 throughout; the grads come back in the
    inputs' dtype."""
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, lse, _mask(q.shape[1], segment_ids, q.device))
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - _row_dot(o, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_tiled_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None, tile: int = 64
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the bf16 backward kernels' walk: the same
    function as :func:`flash_attention_bwd_reference`, computed tile pair
    by tile pair along the kernels' lists (:func:`visible_key_tiles`): dq
    over each query tile's row of listed key tiles, dk and dv over each
    key tile's column of listed query tiles, the diagonal first. Scores
    in exp2 units (``P = exp2(s log2(e) / sqrt(D) - lse log2(e))``, lse
    stays in natural-log units); with bf16 inputs P and dS are rounded to
    bf16 before their products, as the kernels round them. f32
    accumulation; the grads come back in the inputs' dtype. A pair the
    lists leave out adds nothing, so a list that missed a visible pair
    would show against the dense plain version."""
    B, T, H, D = q.shape
    log2e = 1.4426950408889634
    sc = D ** -0.5 * log2e
    ids = (torch.zeros((B, T), dtype=torch.int32, device=q.device)
           if segment_ids is None else segment_ids)
    listed = visible_key_tiles(ids, T, tile).cpu()
    n = listed.shape[-1]
    rnd = ((lambda x: x.to(torch.bfloat16).float())
           if q.dtype == torch.bfloat16 else (lambda x: x))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    lse2 = lse.float() * log2e
    di = _row_dot(o, do)
    pos = torch.arange(T, device=q.device)

    def pair(b, qt, kt):
        """P and dS ``[H, rows, cols]`` of one tile pair, rounded as the
        kernels round them, with the rows' and columns' slices."""
        r = slice(qt * tile, min(T, (qt + 1) * tile))
        c = slice(kt * tile, min(T, (kt + 1) * tile))
        s = torch.einsum("qhd,khd->hqk", qf[b, r], kf[b, c])
        ok = ((pos[r, None] >= pos[None, c])
              & (ids[b, r, None] == ids[b, None, c]))
        p = torch.where(ok, torch.exp2(s * sc - lse2[b, :, r, None]), 0.0)
        dp = torch.einsum("qhd,khd->hqk", dof[b, r], vf[b, c])
        ds = p * (dp - di[b, :, r, None])
        return rnd(p), rnd(ds), r, c

    def walk(own, others):
        return [own] + [x for x in others if x != own]

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for b in range(B):
        for qt in range(n):
            for kt in walk(qt, listed[b, qt].nonzero()[:, 0].tolist()):
                _, ds, r, c = pair(b, qt, kt)
                dq[b, r] += torch.einsum("hqk,khd->qhd", ds, kf[b, c])
        for kt in range(n):
            for qt in walk(kt, listed[b, :, kt].nonzero()[:, 0].tolist()):
                p, ds, r, c = pair(b, qt, kt)
                dv[b, c] += torch.einsum("hqk,qhd->khd", p, dof[b, r])
                dk[b, c] += torch.einsum("hqk,qhd->khd", ds, qf[b, r])
    scale = D ** -0.5
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------

def _forward(q, k, v, segment_ids):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, segment_ids)
    return flash_attention_fwd(q, k, v, segment_ids)


def _backward(q, k, v, o, lse, do, segment_ids):
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             segment_ids)
    di = _row_dot(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, segment_ids)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, di, segment_ids)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``(q, k, v, o, lse)``; backward recomputes ``P``
    from them (no ``[T, T]`` tensor is kept between the passes)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids):
        o, lse = _forward(q, k, v, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, segment_ids)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``[B, T, H, D]`` causal attention, differentiable in q, k and v:
    the plain versions for CPU tensors, the kernels for CUDA tensors.
    ``segment_ids [B, T]`` (packing ids) restrict attention to the query's
    own document."""
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, segment_ids)
