"""Fused linear cross-entropy: the hand-written CUDA kernels, their plain
PyTorch versions, the autograd Function that ties them together, and the
dispatch between them.

This is the port of the JAX package's ``ops/pallas_ce.py`` (its
single-device half: ``fused_ce_loss`` and ``_fused_ce_totals``; the mesh
spelling ``fused_ce_loss_sharded`` is the parallel slice's). The three
Pallas kernels become the three C entry points of ``csrc/fused_ce.cu``:

- forward (``_fwd_kernel``): per row the max ``m``, the sum ``s`` of
  ``exp(z - m)`` and the per-token loss ``m + log s - z[y]`` of
  ``z = h W^T``, without storing the ``[N, V]`` logits;
- dh (``_dh_kernel``): ``dh = dz W`` and dW (``_dw_kernel``):
  ``dW = dz^T h``, each recomputing z, with
  ``dz = (softmax - onehot) g`` rounded to h's dtype before both products
  (``_dz_tile``), f32 sums, dh in h's dtype and dW in f32.

bf16 inputs run on the tensor cores (``mma.sync``); f32 inputs run in f32
FMA on the CUDA cores, which agrees with the plain versions to summation
order. The wrappers pad nothing: the kernels mask the ragged last row and
vocab tiles themselves, and the loss covers exactly the ``V = W.shape[0]``
columns it is given (in the engine that is the padded vocab, as in the
JAX package).

:func:`fused_ce_fwd_reference` and :func:`fused_ce_bwd_reference` are the
plain versions (dense f32 logits, the same formulas and rounding points).
They are the CPU path and the oracle the kernels are held against on the
card (chip_smoke.py).

Dispatch is by the device of the tensors: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _cuda

# kernel launches since the counts were last set to 0 (one per launch of
# that kernel's entry point; the plain versions never count)
launches = {"fused_ce_fwd": 0, "fused_ce_bwd_dh": 0, "fused_ce_bwd_dw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_E_BF16 = 1024   # bf16 dh and dW stage whole rows of h and W
# the bf16 forward's tiles (csrc/fused_ce.cu: kFM rows, 32 kFwdNT vocab
# columns) and its blocks resident on one SM (its __launch_bounds__)
FWD_ROWS, FWD_COLS, FWD_BLOCKS_PER_SM = 128, 256, 1
_SLICES = "ROADMAP 'Slices of the port'"


def refuse_width(E: int, dtype: torch.dtype) -> None:
    """Raise NotImplementedError for a hidden width the card's kernels do
    not take in ``dtype``: bf16 above :data:`MAX_E_BF16` (GPT-2-774M's
    1280 and -1.5B's 1600), which the forward takes but dh and dW do not
    (K-chunked dh and dW come with the larger models). Callers check it
    before any work, not at the first step."""
    if dtype == torch.bfloat16 and E > MAX_E_BF16:
        raise NotImplementedError(
            f"the fused CE backward kernels take a bf16 hidden width up to "
            f"{MAX_E_BF16}, not {E} (they stage whole rows in shared "
            f"memory); K-chunked dh and dW are {_SLICES}, slice 7")


@functools.cache
def _kernels() -> dict:
    """The three C entry points with their signatures (pointers and the
    stream as c_void_p, so none is cut to 32 bits)."""
    lib = _cuda.load("fused_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {"fwd": (lib.dt_ce_fwd, 7, 4), "dh": (lib.dt_ce_dh, 8, 4),
           "dw": (lib.dt_ce_dw, 7, 3)}
    out = {}
    for name, (fn, n_ptrs, n_ints) in fns.items():
        fn.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [i32, i32, ptr]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def check_width(E: int, dtype: torch.dtype, name: str) -> None:
    """Raise ValueError for a hidden width kernel ``name`` does not take:
    E a multiple of 64 for all three, and in bf16 at most
    :data:`MAX_E_BF16` for dh and dW (the forward is K-chunked)."""
    if E < 64 or E % 64:
        raise ValueError(f"E = {E}: the fused CE kernels take a multiple "
                         f"of 64")
    if (dtype == torch.bfloat16 and name != "fused_ce_fwd"
            and E > MAX_E_BF16):
        raise ValueError(f"bf16 E = {E} exceeds {name}'s {MAX_E_BF16}")


def _check(name, h, w, y, *stats) -> None:
    """Raise ValueError on anything kernel ``name`` does not take."""
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
    check_width(E, h.dtype, name)
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("h and w must be contiguous")
    if y.shape != (N,) or y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("y must be a contiguous int32 [N]")
    if any(t.shape != (N,) or t.dtype != torch.float32
           or not t.is_contiguous() for t in stats):
        raise ValueError("m, s and g must be contiguous f32 [N]")


def _splits(h: torch.Tensor, V: int) -> int:
    """Vocab splits of the dh grid and of the f32 forward's (32 rows a
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: per-token
    ``(loss, m, s)``, each f32 ``[N]``. ``h [N, E]`` and ``w [V, E]``
    share a dtype; ``y`` is int32 ``[N]``. Raises ValueError on anything
    the kernel does not take (a CPU tensor included) and RuntimeError if
    the launch fails."""
    _check("fused_ce_fwd", h, w, y)
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
    return loss, m, s


def fused_ce_bwd_dh(h, w, y, m, s, g) -> torch.Tensor:
    """Launch the dh kernel: ``dh [N, E]`` in h's dtype, from the
    forward's ``(m, s)`` and the per-token upstream gradient ``g`` (f32
    ``[N]``)."""
    _check("fused_ce_bwd_dh", h, w, y, m, s, g)
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
    return dh


def fused_ce_bwd_dw(h, w, y, m, s, g) -> torch.Tensor:
    """Launch the dW kernel (arguments as for dh): ``dW [V, E]`` in f32."""
    _check("fused_ce_bwd_dw", h, w, y, m, s, g)
    (N, E), V = h.shape, w.shape[0]
    dw = torch.empty((V, E), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()["dw"](
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m.data_ptr(),
            s.data_ptr(), g.data_ptr(), dw.data_ptr(), N, V, E,
            _DTYPES[h.dtype], h.device.index, stream)
    _raise_on(err, "fused_ce_bwd_dw")
    return dw


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


def fused_ce_bwd_reference(h, w, y, m, s, g
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain backward from the saved ``(m, s)``:
    ``dz = (exp(z - m) / s - onehot(y)) g`` rounded to h's dtype,
    ``dh = dz w`` (in h's dtype), ``dW = dz^T h`` (f32)."""
    z = _logits(h, w)
    p = torch.exp(z - m[:, None]) / s[:, None]
    onehot = torch.nn.functional.one_hot(y.long(), w.shape[0]).float()
    dz = ((p - onehot) * g[:, None]).to(h.dtype).float()
    dh = (dz @ w.float()).to(h.dtype)
    dw = dz.T @ h.float()
    return dh, dw


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------

def _forward(h, w, y):
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w, y)
    return fused_ce_fwd(h, w, y)


def _backward(h, w, y, m, s, g):
    if h.device.type == "cpu":
        return fused_ce_bwd_reference(h, w, y, m, s, g)
    return (fused_ce_bwd_dh(h, w, y, m, s, g),
            fused_ce_bwd_dw(h, w, y, m, s, g))


class _PerTokenCE(torch.autograd.Function):
    """Per-token loss of ``h [N, E]`` against ``w [V, E]``. The head is
    rounded to h's dtype once here (the JAX dense and scan paths round it
    the same way); the forward saves ``(h, w rounded, y, m, s)``, as
    ``_per_token_ce_fwd`` does, and the backward returns dW in f32
    straight to ``w`` (no cast's backward on its way)."""

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
        dh, dw = _backward(h, wc, y, m, s, g.float().contiguous())
        return dh, dw.to(ctx.w_dtype), None


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
