"""Dequantize -> scatter-add of one packed wire-v2 leaf: the hand-written
CUDA kernel, its plain PyTorch version, and the dispatch between them.

The averager folds each packed contribution ``{"idx": int32[k], "q":
int8|f32[k], "scale": f32}`` with merge weight ``w`` into its f32
accumulator in place::

    acc[idx[j]] += float(q[j]) * sw    for j in [0, k),  sw = w * scale

Duplicate indices (which only a hostile encoding carries: honest top-k
indices are unique) sum in j order, as the TPU kernel's serial loop sums
them. The kernel (``csrc/dequant_scatter.cu``, replacing the JAX
package's Pallas ``ops/dequant_scatter.py:_scatter_kernel``) writes O(k)
accumulator words per leaf and never a pass over all n; it detects
duplicates with a persistent n-bit bitmap and takes an ordered path only
for a leaf that has them, so its result is deterministic and bit-equal to
the serial loop. Unlike the TPU kernel it takes indexed leaves of any
size (there is no VMEM budget to decline on).

:func:`dequant_scatter_add_plain` is the plain version: the product
``float(q) * sw`` rounded once, then ``index_add_``, which on CPU tensors
adds in index order (the tests pin that against the serial loop). It is
the CPU path and the oracle the kernel is held against on the card
(chip_smoke.py).

Dispatch (:func:`dequant_scatter_add`) is by the device of the
accumulator: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda

# kernel launches since the count was last set to 0 (one per call of
# dequant_scatter_kernel; the plain version never counts)
launches = 0

_Q_DTYPES = (torch.int8, torch.float32)

# per CUDA device: an int32 tensor holding the collision flag (reset at
# each call) and the n-bit bitmap, all zero between calls (the kernel
# clears the bits it sets)
_SCRATCH: dict[int, torch.Tensor] = {}


@functools.cache
def _kernel():
    """``dt_dequant_scatter`` from the built library, with its C signature
    (pointers and the stream as c_void_p, k and n as 64-bit ints)."""
    fn = _cuda.load("dequant_scatter").dt_dequant_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch(device: torch.device, n: int) -> torch.Tensor:
    """The flag and a bitmap of at least ``n`` bits on ``device``, grown
    (zeroed once) when a larger leaf arrives."""
    words = 1 + (n + 31) // 32
    buf = _SCRATCH.get(device.index)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[device.index] = torch.zeros(
            words, dtype=torch.int32, device=device)
    return buf


def fold_weight(weight, scale) -> float:
    """``w * scale`` as one f32 product (the JAX package folds the
    traced f32 weight and the f32 scale the same way), returned as the
    Python float of that f32 value."""
    return float(np.float32(weight) * np.float32(scale))


def _check(acc: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> None:
    if acc.dtype != torch.float32 or acc.dim() != 1:
        raise ValueError(f"acc must be 1-D float32, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if idx.dtype != torch.int32 or q.dtype not in _Q_DTYPES:
        raise ValueError(f"idx must be int32 and q int8 or float32, got "
                         f"{idx.dtype} and {q.dtype}")
    if idx.dim() != 1 or q.shape != idx.shape or idx.numel() > acc.numel():
        raise ValueError(f"unsupported shapes: acc {tuple(acc.shape)}, idx "
                         f"{tuple(idx.shape)}, q {tuple(q.shape)}")


def dequant_scatter_kernel(acc: torch.Tensor, idx: torch.Tensor,
                           q: torch.Tensor, sw: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; ``acc`` is updated
    in place and returned. Raises ValueError on anything the kernel does
    not take (a CPU tensor included) and RuntimeError if the launch
    fails. An empty ``idx`` launches nothing."""
    global launches
    if any(t.device.type != "cuda" or t.device != acc.device
           for t in (acc, idx, q)):
        raise ValueError("dequant_scatter_kernel needs every tensor on one "
                         "CUDA device")
    _check(acc, idx, q)
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous (it is updated in place)")
    k, n = idx.numel(), acc.numel()
    if k == 0:
        return acc
    idx, q = idx.contiguous(), q.contiguous()
    scratch = _scratch(acc.device, n)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(acc.data_ptr(), idx.data_ptr(), q.data_ptr(),
                        int(q.dtype == torch.int8), k, n, float(sw),
                        scratch.data_ptr(), acc.device.index, stream)
    if err != 0:
        raise RuntimeError(f"dequant_scatter_kernel: CUDA error {err} at "
                           "launch")
    launches += 1
    return acc


def dequant_scatter_add_plain(acc: torch.Tensor, idx: torch.Tensor,
                              q: torch.Tensor, sw: float) -> torch.Tensor:
    """The plain version, in place: ``val = float(q) * sw`` rounded once
    in f32, then ``acc.index_add_(0, idx, val)`` (in j order on CPU
    tensors, duplicates included)."""
    _check(acc, idx, q)
    val = q.to(torch.float32) * torch.tensor(np.float32(sw),
                                             device=q.device)
    return acc.index_add_(0, idx.long(), val)


def dequant_scatter_add(acc: torch.Tensor, idx: torch.Tensor,
                        q: torch.Tensor, sw: float) -> torch.Tensor:
    """Merge-facing entry (``delta.accumulate_delta``): the plain version
    for a CPU accumulator, the kernel for a CUDA one; in place."""
    if acc.device.type == "cpu":
        return dequant_scatter_add_plain(acc, idx, q, sw)
    return dequant_scatter_kernel(acc, idx, q, sw)
