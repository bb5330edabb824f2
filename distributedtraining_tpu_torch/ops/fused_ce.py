"""Fused linear cross-entropy: the hand-written CUDA kernels, their plain
PyTorch versions, the autograd Function that ties them together, and the
dispatch between them.

This is the port of the JAX package's ``ops/pallas_ce.py``:
``fused_ce_loss`` and ``_fused_ce_totals`` on one device, and
:func:`fused_ce_loss_sharded`, the same kernels on a dp/fsdp/tp mesh
(``pallas_ce.py:381-496``). The three Pallas kernels become the C entry
points of ``csrc/fused_ce.cu``:

- forward (``_fwd_kernel``): per row the max ``m``, the sum ``s`` of
  ``exp(z - m)`` and the per-token loss ``m + log s - z[y]`` of
  ``z = h W^T``, without storing the ``[N, V]`` logits;
- dh (``_dh_kernel``): ``dh = dz W`` and dW (``_dw_kernel``):
  ``dW = dz^T h``, with ``dz = (softmax - onehot) g`` rounded to h's
  dtype before both products (``_dz_tile``), f32 sums, dh in h's dtype
  and dW in f32. In bf16 one entry computes both: it walks the vocab in
  chunks (:func:`_bwd_schedule`), forms each chunk's dz once (stored in
  both layouts) and runs the two products on it, dh summed over the
  chunks in f32 and rounded once. In f32 dh and dW are one kernel each,
  each recomputing z.

bf16 inputs run on the tensor cores (``mma.sync``); f32 inputs run in f32
FMA on the CUDA cores, which agrees with the plain versions to summation
order. The wrappers pad nothing: the kernels mask the ragged last row and
vocab tiles themselves, and the loss covers exactly the ``V = W.shape[0]``
columns it is given (in the engine that is the padded vocab, as in the
JAX package). Any hidden width that is a multiple of 64 is taken.

:func:`fused_ce_fwd_reference` and :func:`fused_ce_bwd_reference` are the
plain versions (dense f32 logits, the same formulas and rounding points);
:func:`fused_ce_bwd_chunked_reference` is the plain version of the bf16
backward's chunked decomposition. They are the CPU path and the oracles
the kernels are held against on the card (chip_smoke.py).

Dispatch is by the device of the tensors: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils import devprof
from . import _cuda

# kernel launches since the counts were last set to 0 (one per launch of
# that kernel's entry point; the plain versions never count)
launches = {"fused_ce_fwd": 0, "fused_ce_bwd_dh": 0, "fused_ce_bwd_dw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 forward's tiles (csrc/fused_ce.cu: kFM rows, 32 kFwdNT vocab
# columns) and its blocks resident on one SM (its __launch_bounds__)
FWD_ROWS, FWD_COLS, FWD_BLOCKS_PER_SM = 128, 256, 1
# the bf16 backward's square tiles (kFM = kBN), its K chunk (kFK), its
# blocks resident on one SM, and the most its dz scratch may take (both
# layouts counted): fewer, wider chunks cost fewer launch tails and f32
# passes over dh's sums (PERF.md)
BWD_TILE, BWD_K, BWD_BLOCKS_PER_SM = 128, 64, 2
DZ_SCRATCH_BYTES = 256 << 20


@functools.cache
def _kernels() -> dict:
    """The C entry points with their signatures (pointers and the stream
    as c_void_p, so none is cut to 32 bits)."""
    lib = _cuda.load("fused_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {"fwd": (lib.dt_ce_fwd, 7, 4), "dh": (lib.dt_ce_dh, 8, 4),
           "dw": (lib.dt_ce_dw, 7, 3)}
    out = {}
    for name, (fn, n_ptrs, n_ints) in fns.items():
        fn.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [i32, i32, ptr]
        fn.restype = ctypes.c_int
        out[name] = fn
    bwd = lib.dt_ce_bwd
    bwd.argtypes = [ptr] * 14 + [i32] * 7 + [ptr]
    bwd.restype = ctypes.c_int
    out["bwd"] = bwd
    return out


def check_width(E: int) -> None:
    """Raise ValueError for a hidden width the kernels do not take: every
    route K-chunks E by 64 (the f32 dh and dW take passes of 64 columns),
    so any multiple of 64 is taken."""
    if E < 64 or E % 64:
        raise ValueError(f"E = {E}: the fused CE kernels take a multiple "
                         f"of 64")


def _check(h, w, y, *stats) -> None:
    """Raise ValueError on anything the kernels do not take."""
    tensors = (h, w, y, *stats)
    if any(t.device.type != "cuda" or t.device != h.device for t in tensors):
        raise ValueError("the fused CE kernels need every tensor on one "
                         "CUDA device")
    if h.dim() != 2 or w.dim() != 2 or w.shape[1] != h.shape[1]:
        raise ValueError(f"h must be [N, E] and w [V, E], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if h.dtype not in _DTYPES or w.dtype != h.dtype:
        raise ValueError(f"h and w must share one of {list(_DTYPES)}, got "
                         f"{h.dtype}, {w.dtype}")
    N, E = h.shape
    if N < 1 or w.shape[0] < 1:
        raise ValueError(f"unsupported shape h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}")
    check_width(E)
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("h and w must be contiguous")
    if y.shape != (N,) or y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("y must be a contiguous int32 [N]")
    if any(t.shape != (N,) or t.dtype != torch.float32
           or not t.is_contiguous() for t in stats):
        raise ValueError("m, s and g must be contiguous f32 [N]")


def _splits(h: torch.Tensor, V: int) -> int:
    """Vocab splits of the f32 forward's and dh's grids (32 rows a
    block): enough blocks for one wave when the row tiles alone leave SMs
    idle (the miner's N = 504 has 16 row tiles on 132 SMs), else 1. With
    one split the kernels write their outputs themselves and no merge or
    reduce kernel runs."""
    row_tiles = -(-h.shape[0] // 32)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    return max(1, min(-(-V // 64), sms // row_tiles))


def _fwd_splits(N: int, V: int, sms: int) -> int:
    """Vocab splits of the bf16 forward's grid, from its own tiles: as
    many as fill the ``sms`` SMs' resident blocks beside the
    ``ceil(N / 128)`` row tiles (N 8184: 64 row tiles, 2 splits; N 504:
    4 row tiles, 33 splits on 132 SMs), never more than the vocab tiles,
    and none left empty (the kernel gives split i the tiles
    ``[i t, min((i + 1) t, tiles))``, ``t = ceil(tiles / splits)``)."""
    row_tiles = -(-N // FWD_ROWS)
    tiles = -(-V // FWD_COLS)
    want = max(1, min(tiles, sms * FWD_BLOCKS_PER_SM // row_tiles))
    return -(-tiles // -(-tiles // want))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _k_ranges(iters: int, splits: int) -> list[tuple[int, int]]:
    """The K chunks ``[k0, k1)`` of each split, as the product kernel
    takes them: ``kps = ceil(iters / splits)`` each, the last ones
    shorter or empty."""
    kps = -(-iters // splits)
    return [(min(iters, i * kps), min(iters, (i + 1) * kps))
            for i in range(splits)]


def _k_splits(tiles: int, iters: int, slots: int) -> int:
    """K splits of one backward product with ``tiles`` output tiles of
    ``iters`` K chunks each: enough blocks for one wave of the ``slots``
    resident blocks when the tiles alone leave some idle (dh at the
    miner's N 504: 24 tiles over K = V, 11 splits), else 1 (as
    :func:`_splits` for the f32 route)."""
    return max(1, min(iters, slots // tiles))


def _bwd_schedule(N: int, V: int, E: int, sms: int, dh: bool = True,
                  dw: bool = True) -> dict:
    """The bf16 backward's plan, as ``dt_ce_bwd`` walks it: ``Np``,
    ``Vp`` (N and V rounded up to the 128-row tile), the vocab chunk
    ``Vc`` (the largest multiple of the forward's 256-column tile whose dz
    scratch, one ``[Np, Vc]`` bf16 layout per product asked for, stays
    within :data:`DZ_SCRATCH_BYTES`, at most ``Vp``), the chunks (chunk c takes columns
    ``[c Vc, min((c + 1) Vc, Vp))``), the K splits of dh (K = a chunk's
    columns) and dW (K = the Np tokens), and the kernel launches of one
    call: the transposes, per chunk the dz kernel, the products (one
    launch for both) and dW's split sum, then dh's split sum."""
    Np, Vp = _round_up(N, BWD_TILE), _round_up(V, BWD_TILE)
    per_col = (int(dh) + int(dw)) * Np * 2
    Vc = min(Vp, max(FWD_COLS,
                     DZ_SCRATCH_BYTES // per_col // FWD_COLS * FWD_COLS))
    chunks = -(-Vp // Vc)
    slots = sms * BWD_BLOCKS_PER_SM
    e_tiles = -(-E // BWD_TILE)
    s_dh = _k_splits(-(-N // BWD_TILE) * e_tiles, Vc // BWD_K, slots)
    s_dw = _k_splits(Vc // BWD_TILE * e_tiles, Np // BWD_K, slots)
    n_launches = (int(dh) + int(dw) + chunks * (2 + int(dw and s_dw > 1))
                  + int(dh and s_dh > 1))
    return {"Np": Np, "Vp": Vp, "Vc": Vc, "chunks": chunks, "s_dh": s_dh,
            "s_dw": s_dw, "launches": n_launches}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, *names: str) -> None:
    if err != 0:
        raise RuntimeError(f"{'/'.join(names)}: CUDA error {err} at launch")
    for name in names:
        launches[name] += 1


def _report_cost(h: torch.Tensor, w: torch.Tensor, *, fwd: bool = False,
                 dh: bool = False, dw: bool = False) -> None:
    """One launch's count for the device observatory's cost probe
    (``utils/devprof.kernel_cost``; nothing when no probe is active),
    the count chip_smoke.py's bounds use: h and W read once, the row
    statistics, each output written once; 2 N V E FLOPs for the logits
    product, and as much again for each of dh and dW."""
    def cost():
        (N, E), V = h.shape, w.shape[0]
        hb, wb, row = N * E * h.element_size(), V * E * w.element_size(), \
            N * 4
        if fwd:
            return 2 * N * V * E, hb + wb + 4 * row
        return ((2 + 2 * dh + 2 * dw) * N * V * E,
                hb + wb + 4 * row + dh * hb + dw * V * E * 4)
    devprof.kernel_cost(cost)


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: per-token
    ``(loss, m, s)``, each f32 ``[N]``. ``h [N, E]`` and ``w [V, E]``
    share a dtype; ``y`` is int32 ``[N]``. Raises ValueError on anything
    the kernel does not take (a CPU tensor included) and RuntimeError if
    the launch fails."""
    _check(h, w, y)
    (N, E), V = h.shape, w.shape[0]
    if h.dtype == torch.bfloat16:
        splits = _fwd_splits(N, V, torch.cuda.get_device_properties(
            h.device).multi_processor_count)
    else:
        splits = _splits(h, V)
    part = (torch.empty((3, splits, N), dtype=torch.float32, device=h.device)
            if splits > 1 else None)
    loss, m, s = (torch.empty(N, dtype=torch.float32, device=h.device)
                  for _ in range(3))
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["fwd"](
            h.data_ptr(), w.data_ptr(), y.data_ptr(), _ptr(part),
            loss.data_ptr(), m.data_ptr(), s.data_ptr(), N, V, E, splits,
            _DTYPES[h.dtype], h.device.index, stream)
    _raise_on(err, "fused_ce_fwd")
    _report_cost(h, w, fwd=True)
    return loss, m, s


def _bwd_bf16(h, w, y, m, s, g, want_dh: bool, want_dw: bool
              ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One call of the bf16 backward entry: dh and/or dW, with its
    scratch (the transposes, the dz chunk in the layouts the products
    asked for need, the f32 sums) from :func:`_bwd_schedule`."""
    (N, E), V = h.shape, w.shape[0]
    sched = _bwd_schedule(N, V, E, torch.cuda.get_device_properties(
        h.device).multi_processor_count, want_dh, want_dw)
    Np, Vp, Vc = sched["Np"], sched["Vp"], sched["Vc"]
    s_dh, s_dw = sched["s_dh"], sched["s_dw"]

    def empty(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=h.device)

    f32 = torch.float32
    dh = dw = wt = ht = dz = dzt = acc = part = None
    if want_dh:
        dh, wt, dz = empty((N, E)), empty((E, Vp)), empty((Np, Vc))
        if sched["chunks"] > 1 or s_dh > 1:
            acc = empty((s_dh, N, E), f32)
    if want_dw:
        dw, ht, dzt = empty((V, E), f32), empty((E, Np)), empty((Vc, Np))
        if s_dw > 1:
            part = empty((s_dw, Vc, E), f32)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["bwd"](
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
            s.data_ptr(), g.data_ptr(), _ptr(ht), _ptr(wt), _ptr(dz),
            _ptr(dzt), _ptr(acc), _ptr(part), _ptr(dh), _ptr(dw), N, V, E,
            Vc, s_dh, s_dw, h.device.index, stream)
    _raise_on(err, *(["fused_ce_bwd_dh"] if want_dh else [])
              + (["fused_ce_bwd_dw"] if want_dw else []))
    _report_cost(h, w, dh=want_dh, dw=want_dw)
    return dh, dw


def _f32_dh(h, w, y, m, s, g) -> torch.Tensor:
    (N, E), V = h.shape, w.shape[0]
    splits = _splits(h, V)
    part = (torch.empty((splits, N, E), dtype=torch.float32, device=h.device)
            if splits > 1 else None)
    dh = torch.empty((N, E), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["dh"](
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
            s.data_ptr(), g.data_ptr(), _ptr(part), dh.data_ptr(),
            N, V, E, splits, _DTYPES[h.dtype], h.device.index, stream)
    _raise_on(err, "fused_ce_bwd_dh")
    _report_cost(h, w, dh=True)
    return dh


def _f32_dw(h, w, y, m, s, g) -> torch.Tensor:
    (N, E), V = h.shape, w.shape[0]
    dw = torch.empty((V, E), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["dw"](
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
            s.data_ptr(), g.data_ptr(), dw.data_ptr(), N, V, E,
            _DTYPES[h.dtype], h.device.index, stream)
    _raise_on(err, "fused_ce_bwd_dw")
    _report_cost(h, w, dw=True)
    return dw


def fused_ce_bwd(h, w, y, m, s, g) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream: ``(dh [N, E]`` in h's
    dtype, ``dW [V, E]`` in f32), from the forward's ``(m, s)`` and the
    per-token upstream gradient ``g`` (f32 ``[N]``). In bf16 one call of
    the backward entry (dz formed once for both products); in f32 the dh
    and dW kernels. Counts one launch of each."""
    _check(h, w, y, m, s, g)
    if h.dtype == torch.bfloat16:
        return _bwd_bf16(h, w, y, m, s, g, True, True)
    return _f32_dh(h, w, y, m, s, g), _f32_dw(h, w, y, m, s, g)


def fused_ce_bwd_dh(h, w, y, m, s, g) -> torch.Tensor:
    """dh alone (arguments as for :func:`fused_ce_bwd`): in bf16 the
    backward entry without its dW product, so dz is formed for dh
    alone."""
    _check(h, w, y, m, s, g)
    if h.dtype == torch.bfloat16:
        return _bwd_bf16(h, w, y, m, s, g, True, False)[0]
    return _f32_dh(h, w, y, m, s, g)


def fused_ce_bwd_dw(h, w, y, m, s, g) -> torch.Tensor:
    """dW alone (f32 ``[V, E]``), as :func:`fused_ce_bwd_dh` is dh."""
    _check(h, w, y, m, s, g)
    if h.dtype == torch.bfloat16:
        return _bwd_bf16(h, w, y, m, s, g, False, True)[1]
    return _f32_dw(h, w, y, m, s, g)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``z = h w^T`` in f32: products of the inputs' values summed in f32
    (the kernels' ``preferred_element_type=float32``)."""
    return h.float() @ w.float().T


def fused_ce_fwd_reference(h: torch.Tensor, w: torch.Tensor,
                           y: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The plain forward: dense f32 logits, ``m = max z``,
    ``s = sum exp(z - m)``, ``loss = m + log s - z[y]``."""
    z = _logits(h, w)
    m = z.amax(dim=-1)
    s = torch.exp(z - m[:, None]).sum(dim=-1)
    ll = torch.gather(z, 1, y.long()[:, None])[:, 0]
    return m + torch.log(s) - ll, m, s


def fused_ce_bwd_reference(h, w, y, m, s, g, *, want_dw: bool = True
                           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain backward from the saved ``(m, s)``:
    ``dz = (exp(z - m) / s - onehot(y)) g`` rounded to h's dtype,
    ``dh = dz w`` (in h's dtype), ``dW = dz^T h`` (f32; None without
    ``want_dw``, the frozen head's backward)."""
    z = _logits(h, w)
    p = torch.exp(z - m[:, None]) / s[:, None]
    onehot = torch.nn.functional.one_hot(y.long(), w.shape[0]).float()
    dz = ((p - onehot) * g[:, None]).to(h.dtype).float()
    dh = (dz @ w.float()).to(h.dtype)
    return dh, (dz.T @ h.float() if want_dw else None)


def fused_ce_bwd_chunked_reference(h, w, y, m, s, g, vc: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the bf16 backward's decomposition (the dz
    kernel's and the products' counterpart): the vocab in chunks of
    ``vc`` columns; per chunk ``z_c = h w_c^T`` in f32,
    ``dz_c = (exp(z_c - m) / s - onehot) g`` rounded to h's dtype,
    ``dh += dz_c w_c`` in f32 in chunk order, and the chunk's rows of dW
    ``= dz_c^T h``; dh rounded to h's dtype once at the end."""
    (N, E), V = h.shape, w.shape[0]
    hf = h.float()
    dh = torch.zeros((N, E), dtype=torch.float32, device=h.device)
    dw = torch.empty((V, E), dtype=torch.float32, device=h.device)
    for v0 in range(0, V, vc):
        wc = w[v0:v0 + vc].float()
        p = torch.exp(hf @ wc.T - m[:, None]) / s[:, None]
        cols = torch.arange(v0, v0 + wc.shape[0], device=h.device)
        onehot = (y.long()[:, None] == cols[None, :]).float()
        dz = ((p - onehot) * g[:, None]).to(h.dtype).float()
        dh += dz @ wc
        dw[v0:v0 + wc.shape[0]] = dz.T @ hf
    return dh.to(h.dtype), dw


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------

def _forward(h, w, y):
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w, y)
    return fused_ce_fwd(h, w, y)


def _backward(h, w, y, m, s, g, want_dw: bool):
    if h.device.type == "cpu":
        return fused_ce_bwd_reference(h, w, y, m, s, g, want_dw=want_dw)
    if not want_dw:
        return fused_ce_bwd_dh(h, w, y, m, s, g), None
    return fused_ce_bwd(h, w, y, m, s, g)


class _PerTokenCE(torch.autograd.Function):
    """Per-token loss of ``h [N, E]`` against ``w [V, E]``. The head is
    rounded to h's dtype once here (the JAX dense and scan paths round it
    the same way); the forward saves ``(h, w rounded, y, m, s)``, as
    ``_per_token_ce_fwd`` does, and the backward returns dW in f32
    straight to ``w`` (no cast's backward on its way). A head that takes
    no gradient (a LoRA miner's frozen base head) gets none: the
    backward then computes dh alone."""

    @staticmethod
    def forward(ctx, h, w, y):
        wc = w.to(h.dtype).contiguous()
        loss, m, s = _forward(h, wc, y)
        ctx.save_for_backward(h, wc, y, m, s)
        ctx.w_dtype = w.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        h, wc, y, m, s = ctx.saved_tensors
        want_dw = ctx.needs_input_grad[1]
        dh, dw = _backward(h, wc, y, m, s, g.float().contiguous(), want_dw)
        return dh, (dw.to(ctx.w_dtype) if want_dw else None), None


def fused_ce_totals(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of masked per-token losses, raw mask sum)``: the
    counterpart of ``_fused_ce_totals``. ``hidden [..., E]`` is already
    aligned to ``labels [...]``; ``head`` is ``[V, E]``."""
    E = hidden.shape[-1]
    h = hidden.reshape(-1, E).contiguous()
    y = labels.reshape(-1).to(torch.int32).contiguous()
    per_tok = _PerTokenCE.apply(h, head, y).reshape(labels.shape)
    msk = (torch.ones_like(per_tok) if loss_mask is None
           else loss_mask.to(per_tok.dtype))
    return torch.sum(per_tok * msk), torch.sum(msk)


def fused_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                  labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean loss, token count)``, the ``causal_lm_loss`` contract:
    ``total / max(count, 1)`` and ``max(count, 1)``. Differentiable in
    ``hidden`` and ``head``."""
    total, count = fused_ce_totals(hidden, head, labels, loss_mask)
    count = torch.clamp(count, min=1.0)
    return total / count, count


def fused_ce_loss_sharded(hidden: torch.Tensor, head_shard: torch.Tensor,
                          labels: torch.Tensor,
                          loss_mask: Optional[torch.Tensor] = None, *,
                          mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_ce_loss` on a dp/fsdp/tp mesh (``parallel.Mesh``):
    the JAX ``fused_ce_loss_sharded`` step for step, with the collectives
    of ``parallel/collectives.py`` in place of ``shard_map``'s.

    ``hidden [B, T, E]``, ``labels`` and ``loss_mask [B, T]`` are this
    rank's rows (the batch split over dp x fsdp, tp peers holding the
    same rows); ``head_shard`` is this rank's ``[V/tp, E/fsdp]`` shard of
    the head (spec ``("tp", "fsdp")``). Per rank:

    - the head is all-gathered over fsdp on dim 1, then over tp on dim 0;
    - with tp > 1, the local rows are padded to a multiple of tp (mask 0)
      and this rank keeps its tp slice ``i*per:(i+1)*per``;
    - ``fused_ce_totals`` runs on that slice (the kernels on the card,
      their plain versions on the CPU);
    - total and count are all-reduced over the whole mesh.

    Returns ``(total / max(count, 1), max(count, 1))`` on every rank.
    Backward: dW is reduce-scattered back to the head shard (tp on dim
    0, then fsdp on dim 1; neither runs, nor is dW computed, for a shard
    that takes no gradient, a LoRA miner's frozen head; the sum over dp
    is the caller's, as
    ``TrainEngine`` sums every gradient over dp once, where
    ``shard_map``'s transpose of the dp-replicated head would psum it
    here); dh, computed for this rank's tp slice, is
    summed over tp (the zero-padded slices), so every tp peer gets the
    full dh of the local rows, the padded rows dropped. On a mesh of
    size 1 every collective is the identity and the result is
    :func:`fused_ce_loss`'s, bit for bit."""
    from ..parallel import collectives as coll
    w = coll.all_gather(head_shard, mesh, "fsdp", 1)
    w = coll.all_gather(w, mesh, "tp", 0)
    tp = mesh.size("tp")
    h2, y2, m2 = hidden, labels, loss_mask
    if tp > 1:
        E = hidden.shape[-1]
        h2 = coll.copy_to(hidden.reshape(-1, E), mesh, "tp")
        y2 = labels.reshape(-1)
        m2 = (torch.ones(y2.shape, dtype=torch.float32, device=y2.device)
              if loss_mask is None else loss_mask.reshape(-1).float())
        n = h2.shape[0]
        pad = _round_up(n, tp) - n
        if pad:
            h2 = torch.nn.functional.pad(h2, (0, 0, 0, pad))
            y2 = torch.nn.functional.pad(y2, (0, pad))
            m2 = torch.nn.functional.pad(m2, (0, pad))
        per = (n + pad) // tp
        i = mesh.index("tp")
        h2, y2, m2 = (t[i * per:(i + 1) * per] for t in (h2, y2, m2))
    total, count = fused_ce_totals(h2, w, y2, m2)
    total = coll.all_reduce(total, mesh, mesh.axis_names)
    count = coll.all_reduce(count, mesh, mesh.axis_names)
    count = torch.clamp(count, min=1.0)
    return total / count, count
