"""Dequantize -> scatter-add of packed wire-v2 leaves: the hand-written
CUDA kernel, its plain PyTorch version, and the dispatch between them.

The averager folds each packed contribution, one entry ``{"idx":
int32[k], "q": int8|f32[k], "scale": f32}`` a leaf, with merge weight
``w`` into its f32 accumulators in place::

    acc[idx[j]] += float(q[j]) * sw    for j in [0, k),  sw = w * scale

Duplicate indices (which only a hostile encoding carries: honest top-k
indices are unique) sum in j order, as the TPU kernel's serial loop sums
them. The kernel (``csrc/dequant_scatter.cu``, replacing the JAX
package's Pallas ``ops/dequant_scatter.py:_scatter_kernel``) folds every
indexed leaf of a contribution in one pair of launches, writes O(k)
accumulator words and never a pass over all n; it detects duplicates
with a persistent bitmap and takes an ordered path only for a leaf that
has them, so its result is deterministic and bit-equal to the serial
loop. Unlike the TPU kernel it takes indexed leaves of any size (there is
no VMEM budget to decline on).

A contribution is staged once (:func:`stage_contribution`): the leaves'
idx and q concatenated into one buffer (on a CUDA device through a
reusable pinned staging buffer and one copy), and a table of one record a
leaf and one a block of the kernel's grid. :func:`dequant_scatter_contribution`
folds it: the plain version for CPU accumulators, the kernel for CUDA
ones (one copy of the table, two launches). :func:`dequant_scatter_add`
is the one-leaf spelling of the same dispatch.

:func:`dequant_scatter_add_plain` is the plain version of one leaf: the
product ``float(q) * sw`` rounded once, then ``index_add_``, which on CPU
tensors adds in index order (the tests pin that against the serial
loop). It is the CPU path and the oracle the kernel is held against on
the card (chip_smoke.py).

Dispatch is by the device of the accumulators: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise. There is no fallback
from a failed build or launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils import devprof
from . import _cuda

# kernel launches since the count was last set to 0 (one per folded
# contribution, or per one-leaf kernel call; the plain version never
# counts)
launches = 0

_Q_DTYPES = (torch.int8, torch.float32)
_PER_BLOCK = 1024     # entries a block of the kernel's grid (kPerBlock)

# the kernel's records, 56 and 8 bytes (csrc/dequant_scatter.cu: Leaf,
# Block)
LEAF = np.dtype([("acc", "<u8"), ("n", "<i8"), ("e0", "<i8"), ("qb", "<i8"),
                 ("w0", "<i8"), ("k", "<i4"), ("sw", "<f4"),
                 ("q_int8", "<i4"), ("flag", "<i4")])
BLOCK = np.dtype([("leaf", "<i4"), ("j0", "<i4")])


class Contribution(NamedTuple):
    """One contribution's indexed leaves, staged for one fold."""
    accs: list          # flat f32 accumulators, one a leaf
    table: np.ndarray   # LEAF records (``acc`` filled at launch)
    blocks: np.ndarray  # BLOCK records: the kernel's grid
    idx: torch.Tensor   # int32: leaf i's entries at table[i]["e0"]
    q: torch.Tensor     # uint8: leaf i's q bytes at table[i]["qb"]
    extra: list         # further arrays staged in the same copy


class _Staging:
    """A pinned host buffer, grown as needed, and the event recorded after
    the last copy out of it: a refill waits on it first, so a copy still
    in flight never reads bytes of the next contribution."""

    def __init__(self):
        self.host: torch.Tensor | None = None
        self.view: np.ndarray | None = None
        self.event: torch.cuda.Event | None = None

    def fill(self, nbytes: int) -> np.ndarray:
        """The first ``nbytes`` of the buffer as numpy, once the previous
        copy out of it has finished."""
        if self.event is not None:
            self.event.synchronize()
        if self.host is None or self.host.numel() < nbytes:
            self.host = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                                    pin_memory=True)
            self.view = self.host.numpy()
        return self.view[:nbytes]

    def copy_to(self, device: torch.device, nbytes: int) -> torch.Tensor:
        """The buffer's first ``nbytes`` on ``device`` (one non-blocking
        copy on the current stream), with the event recorded after it."""
        out = torch.empty(nbytes, dtype=torch.uint8, device=device)
        out.copy_(self.host[:nbytes], non_blocking=True)
        self.record(torch.cuda.current_stream(device))
        return out

    def record(self, stream) -> None:
        """Record the event on ``stream``, after the work that reads the
        buffer was enqueued there."""
        if self.event is None:
            self.event = torch.cuda.Event()
        self.event.record(stream)


# per CUDA device: the staging buffers of idx/q and of the table, the
# table's device copy (both grown as needed; calls on one stream use them
# one after the other), and the bitmap (int32 words, all zero between
# calls: the kernel clears the bits it sets)
_STAGE: dict[int, _Staging] = {}
_TABLE: dict[int, _Staging] = {}
_TABLE_DEV: dict[int, torch.Tensor] = {}
_BITMAP: dict[int, torch.Tensor] = {}


@functools.cache
def _kernel():
    """``dt_dequant_scatter`` from the built library, with its C signature
    (pointers and the stream as c_void_p)."""
    fn = _cuda.load("dequant_scatter").dt_dequant_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch(cache: dict, device: torch.device, n: int, dtype
             ) -> torch.Tensor:
    """``cache``'s zeroed buffer of at least ``n`` elements on ``device``,
    grown (zeroed once) when a larger contribution arrives."""
    buf = cache.get(device.index)
    if buf is None or buf.numel() < n:
        buf = cache[device.index] = torch.zeros(max(n, 1), dtype=dtype,
                                                device=device)
    return buf


def fold_weight(weight, scale) -> float:
    """``w * scale`` as one f32 product (the JAX package folds the
    traced f32 weight and the f32 scale the same way), returned as the
    Python float of that f32 value."""
    return float(np.float32(weight) * np.float32(scale))


def _check(acc: torch.Tensor, idx, q) -> None:
    """Raise ValueError on a leaf the kernel does not take; idx and q are
    tensors or (staged from the host) numpy arrays."""
    if (acc.dtype != torch.float32 or acc.dim() != 1
            or not acc.is_contiguous()):
        raise ValueError(f"acc must be 1-D contiguous float32 (it is updated "
                         f"in place), got {acc.dtype} {tuple(acc.shape)}")
    if isinstance(idx, np.ndarray):
        ok = idx.dtype == np.int32 and q.dtype in (np.int8, np.float32)
    else:
        ok = idx.dtype == torch.int32 and q.dtype in _Q_DTYPES
    if not ok:
        raise ValueError(f"idx must be int32 and q int8 or float32, got "
                         f"{idx.dtype} and {q.dtype}")
    if (idx.ndim != 1 or tuple(q.shape) != tuple(idx.shape)
            or idx.shape[0] > acc.numel() or idx.shape[0] >= 1 << 31):
        raise ValueError(f"unsupported shapes: acc {tuple(acc.shape)}, idx "
                         f"{tuple(idx.shape)}, q {tuple(q.shape)}")


def contribution_layout(ns, ks, q_sizes) -> tuple[np.ndarray, np.ndarray,
                                                  int, int]:
    """The table of a contribution whose leaf i has ``ns[i]`` accumulator
    elements, ``ks[i]`` entries and q elements of ``q_sizes[i]`` bytes:
    ``(LEAF records, BLOCK records, idx entries, q bytes)``. Each leaf's
    entries start at a multiple of 4 and its q at a multiple of 16 bytes
    (the kernel's vector loads); its bitmap range starts at a word of its
    own; each block owns up to 1,024 consecutive entries of one leaf."""
    m = len(ns)
    table = np.zeros(m, LEAF)
    table["n"], table["k"] = ns, ks
    table["q_int8"] = [int(s == 1) for s in q_sizes]
    ks64 = np.asarray(ks, np.int64)
    pad_k = -(-ks64 // 4) * 4
    table["e0"] = np.concatenate([[0], np.cumsum(pad_k)[:-1]]) if m else 0
    qbytes = -(-(ks64 * np.asarray(q_sizes, np.int64)) // 16) * 16
    table["qb"] = np.concatenate([[0], np.cumsum(qbytes)[:-1]]) if m else 0
    words = -(-np.asarray(ns, np.int64) // 32)
    table["w0"] = np.concatenate([[0], np.cumsum(words)[:-1]]) if m else 0
    per_leaf = -(-ks64 // _PER_BLOCK)
    blocks = np.zeros(int(per_leaf.sum()), BLOCK)
    blocks["leaf"] = np.repeat(np.arange(m, dtype=np.int32), per_leaf)
    starts = np.concatenate([[0], np.cumsum(per_leaf)[:-1]]) if m else []
    blocks["j0"] = (np.arange(blocks.size) - np.repeat(starts, per_leaf)
                    ) * _PER_BLOCK
    return table, blocks, int(pad_k.sum()), int(qbytes.sum())


def bitmap_words(table: np.ndarray) -> int:
    """The bitmap words a contribution's table reaches."""
    if not table.size:
        return 0
    return int((table["w0"] + -(-table["n"] // 32)).max())


def _np(x) -> np.ndarray:
    """A host array (numpy, or a CPU tensor) as contiguous numpy."""
    return np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                                else x)


_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.float32): torch.float32}


def stage_contribution(leaves: Sequence, extra: Sequence = (),
                       device: torch.device | None = None) -> Contribution:
    """Stage one contribution's indexed leaves ``[(flat f32 accumulator,
    idx, q, sw)]`` (idx and q on the host: numpy arrays or CPU tensors;
    every accumulator on ``device``, by default the first one's) for one
    fold. ``extra`` host arrays (a contribution's dense-form q) ride in
    the same buffer and come back as tensors on the device in
    ``Contribution.extra``. For a CUDA device the bytes go through the
    device's pinned staging buffer and one non-blocking copy; for the CPU
    they are plain tensors."""
    if device is None:
        device = leaves[0][0].device if leaves else torch.device("cpu")
    idx_h = [_np(x[1]) for x in leaves]
    q_h = [_np(x[2]) for x in leaves]
    for (acc, _, _, _), idx, q in zip(leaves, idx_h, q_h):
        _check(acc, idx, q)
        if acc.device != device:
            raise ValueError("stage_contribution: accumulators on more "
                             "than one device")
    table, blocks, n_idx, n_q = contribution_layout(
        [x[0].numel() for x in leaves], [i.size for i in idx_h],
        [q.itemsize for q in q_h])
    table["sw"] = [np.float32(x[3]) for x in leaves]
    extra_h = [_np(x) for x in extra]
    offs, nbytes = [], 4 * n_idx + n_q
    for x in extra_h:
        offs.append(nbytes)
        nbytes = -(-(nbytes + x.nbytes) // 16) * 16
    cuda = device.type == "cuda"
    if cuda:
        stage = _STAGE.setdefault(device.index, _Staging())
        buf = stage.fill(nbytes)
    else:
        host = torch.empty(nbytes, dtype=torch.uint8)
        buf = host.numpy()
    ib = buf[:4 * n_idx].view(np.int32)
    for row, i, q in zip(table, idx_h, q_h):
        ib[row["e0"]:row["e0"] + i.size] = i
        qb = 4 * n_idx + int(row["qb"])
        buf[qb:qb + q.nbytes] = q.reshape(-1).view(np.uint8)
    for off, x in zip(offs, extra_h):
        buf[off:off + x.nbytes] = x.reshape(-1).view(np.uint8)
    dev_buf = stage.copy_to(device, nbytes) if cuda else host
    return Contribution(
        accs=[x[0] for x in leaves], table=table, blocks=blocks,
        idx=dev_buf[:4 * n_idx].view(torch.int32),
        q=dev_buf[4 * n_idx:4 * n_idx + n_q],
        extra=[dev_buf[off:off + x.nbytes].view(_TORCH_DTYPES[x.dtype])
               .view(x.shape) for off, x in zip(offs, extra_h)])


def _leaf_views(c: Contribution, i: int):
    """Leaf i's idx and q as tensors, read through the table."""
    row = c.table[i]
    k, e0, qb = int(row["k"]), int(row["e0"]), int(row["qb"])
    size = 1 if row["q_int8"] else 4
    q = c.q[qb:qb + k * size].view(torch.int8 if row["q_int8"]
                                   else torch.float32)
    return c.idx[e0:e0 + k], q


def dequant_scatter_contribution_plain(c: Contribution) -> None:
    """The plain version of a contribution's fold, in place: leaf by
    leaf, in table order, :func:`dequant_scatter_add_plain` on the idx
    and q the table places in the staged buffers."""
    for i, acc in enumerate(c.accs):
        idx, q = _leaf_views(c, i)
        dequant_scatter_add_plain(acc, idx, q, float(c.table[i]["sw"]))


def dequant_scatter_contribution_kernel(c: Contribution) -> None:
    """Fold a staged contribution with the CUDA kernel on the current
    stream, every accumulator in place: the table (with the accumulators'
    addresses and zeroed flags) in one copy, then the mark and scatter
    launches. Raises ValueError on anything the kernel does not take (a
    CPU tensor, or tensors on two devices) and RuntimeError if the launch
    fails. A contribution without entries launches nothing."""
    global launches
    devices = {t.device for t in (*c.accs, c.idx, c.q)}
    device = c.idx.device
    if len(devices) != 1 or device.type != "cuda":
        raise ValueError("dequant_scatter_contribution_kernel needs every "
                         "tensor on one CUDA device")
    if not c.accs or not c.blocks.size:
        return
    if c.idx.data_ptr() % 16 or c.q.data_ptr() % 16:
        raise ValueError("the staged idx and q must start 16-byte aligned")
    c.table["acc"] = [a.data_ptr() for a in c.accs]
    t_bytes = c.table.nbytes + c.blocks.nbytes
    stage = _TABLE.setdefault(device.index, _Staging())
    buf = stage.fill(t_bytes)
    buf[:c.table.nbytes] = c.table.view(np.uint8)
    buf[c.table.nbytes:] = c.blocks.view(np.uint8)
    table = _scratch(_TABLE_DEV, device, t_bytes, torch.uint8)
    bitmap = _scratch(_BITMAP, device, bitmap_words(c.table), torch.int32)
    stream = torch.cuda.current_stream(device)
    # the table's copy and the two launches, enqueued by the library
    err = _kernel()(stage.host.data_ptr(), table.data_ptr(), c.table.size,
                    c.blocks.size, c.idx.data_ptr(), c.q.data_ptr(),
                    bitmap.data_ptr(), device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_scatter_contribution_kernel: CUDA "
                           f"error {err} at launch")
    stage.record(stream)
    launches += 1
    devprof.kernel_cost(lambda: _cost(c.table))


def _cost(table: np.ndarray) -> tuple[int, int]:
    """One launch's (FLOPs, bytes) for the device observatory's cost
    probe, the count chip_smoke.py's bound uses: each entry's idx and q
    read once and one accumulator word read and written (8 B), a
    multiply and an add an entry."""
    k = table["k"].astype(np.int64)
    q_bytes = np.where(table["q_int8"], 1, 4)
    return int(2 * k.sum()), int((k * (4 + q_bytes + 8)).sum())


def dequant_scatter_contribution(c: Contribution) -> None:
    """Merge-facing entry (``delta.accumulate_delta``): the plain version
    for CPU accumulators, the kernel for CUDA ones; in place."""
    if all(a.device.type == "cpu" for a in c.accs) and \
            c.idx.device.type == "cpu":
        dequant_scatter_contribution_plain(c)
    else:
        dequant_scatter_contribution_kernel(c)


def dequant_scatter_kernel(acc: torch.Tensor, idx: torch.Tensor,
                           q: torch.Tensor, sw: float) -> torch.Tensor:
    """One leaf through the same kernel (a one-leaf contribution whose
    idx and q are already on the card), on the current stream; ``acc``
    is updated in place and returned. Raises ValueError on anything the
    kernel does not take (a CPU tensor included) and RuntimeError if the
    launch fails. An empty ``idx`` launches nothing."""
    if any(t.device.type != "cuda" or t.device != acc.device
           for t in (acc, idx, q)):
        raise ValueError("dequant_scatter_kernel needs every tensor on one "
                         "CUDA device")
    _check(acc, idx, q)
    if idx.numel() == 0:
        return acc
    idx, q = idx.contiguous(), q.contiguous()
    if idx.data_ptr() % 16:
        idx = idx.clone()
    if q.data_ptr() % 16:
        q = q.clone()
    table, blocks, _, _ = contribution_layout(
        [acc.numel()], [idx.numel()], [q.element_size()])
    table["sw"] = np.float32(sw)
    dequant_scatter_contribution_kernel(
        Contribution([acc], table, blocks, idx, q.view(torch.uint8), []))
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
    """One leaf: the plain version for a CPU accumulator, the kernel for
    a CUDA one; in place."""
    if acc.device.type == "cpu":
        return dequant_scatter_add_plain(acc, idx, q, sw)
    return dequant_scatter_kernel(acc, idx, q, sw)
