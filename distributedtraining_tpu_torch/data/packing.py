"""Greedy sequence packing into fixed ``[batch, seq_len]`` rows — a copy
of the JAX package's ``data/packing.py`` Python packer.

Output per row:
- input_ids:    packed tokens, zero-padded at the tail
- segment_ids:  which document each token belongs to (0-based; padding gets a
                fresh id so it attends to nothing useful)
- position_ids: restart at 0 per document (wpe correctness)
- loss_mask:    1.0 on real tokens whose *successor* is in the same document
                (cross-document next-token predictions are excluded), 0 on pad

These feed the models' segment-aware causal attention. Rows come from
the C++ packer (``native/packing.cpp``, the port's copy of the JAX
package's, through ``_pack_documents_native``); the Python loop of
``pack_documents(native=False)`` is its plain version, which the tests
hold it against. Where the C++ packer cannot be built, packing raises:
no path quietly takes the Python loop.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Iterator, Sequence

import numpy as np


def pack_documents(docs: Iterable[Sequence[int]], seq_len: int,
                   *, drop_remainder: bool = True,
                   native: bool = True) -> Iterator[dict]:
    """Greedy-pack token lists into rows of exactly ``seq_len``.

    Documents longer than seq_len are split. Yields one row dict at a time;
    callers batch rows (datasets.batch_iterator). ``native=True`` packs
    through the C++ packer (built at first use; raises when it cannot
    be); ``native=False`` runs the Python loop, the plain version."""
    if native:
        yield from _pack_documents_native(docs, seq_len,
                                          drop_remainder=drop_remainder)
        return
    ids = np.zeros((seq_len,), np.int32)
    seg = np.zeros((seq_len,), np.int32)
    pos = np.zeros((seq_len,), np.int32)
    mask = np.zeros((seq_len,), np.float32)
    fill = 0
    seg_id = 0

    def flush():
        nonlocal ids, seg, pos, mask, fill, seg_id
        if fill < seq_len:
            # padding tail gets its own segment id so pad positions attend to
            # no document tokens
            seg[fill:] = seg_id + 1
        row = {"input_ids": ids, "segment_ids": seg, "position_ids": pos,
               "loss_mask": mask}
        ids = np.zeros((seq_len,), np.int32)
        seg = np.zeros((seq_len,), np.int32)
        pos = np.zeros((seq_len,), np.int32)
        mask = np.zeros((seq_len,), np.float32)
        fill = 0
        seg_id = 0
        return row

    for doc in docs:
        doc = list(doc)
        while doc:
            space = seq_len - fill
            take = min(space, len(doc))
            chunk = doc[:take]
            doc = doc[take:]
            ids[fill:fill + take] = chunk
            seg[fill:fill + take] = seg_id
            pos[fill:fill + take] = np.arange(take)
            # label for position j is token j+1; valid while j+1 is in the
            # same segment
            mask[fill:fill + take - 1] = 1.0
            fill += take
            if fill == seq_len:
                yield flush()
            else:
                seg_id += 1
    if fill > 0 and not drop_remainder:
        # padding tail: distinct segment id, mask 0 (already zeros)
        yield flush()


# ---------------------------------------------------------------------------
# The C++ packer (native/packing.cpp through ctypes)
# ---------------------------------------------------------------------------

def _native_pack() -> ctypes.CDLL:
    """``dt_pack`` of the built library with its C signature; raises
    RuntimeError when the library cannot be built or loaded."""
    from .. import native
    lib = native.load("packing")
    lib.dt_pack.restype = ctypes.c_int64
    lib.dt_pack.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # tokens
        ctypes.POINTER(ctypes.c_int64),   # doc_lens
        ctypes.c_int64,                   # n_docs
        ctypes.c_int64,                   # seq_len
        ctypes.c_int,                     # drop_remainder
        ctypes.POINTER(ctypes.c_int32),   # ids
        ctypes.POINTER(ctypes.c_int32),   # seg
        ctypes.POINTER(ctypes.c_int32),   # pos
        ctypes.POINTER(ctypes.c_float),   # mask
        ctypes.c_int64,                   # rows_cap
    ]
    return lib


def _pack_documents_native(docs: Iterable[Sequence[int]], seq_len: int,
                           *, drop_remainder: bool,
                           chunk_tokens: int = 1 << 22) -> Iterator[dict]:
    """Buffer docs into ~chunk_tokens batches and hand each to the C++
    packer. Chunks are cut at row-aligned token counts, which may split a
    document mid-stream: output-identical because the packer treats a
    row boundary as a full reset (positions restart per chunk, seg_id
    back to 0, mask 0 on the row's last token), so a doc split exactly at
    a row boundary is indistinguishable from two docs. If those reset
    semantics ever change, this chunking must change with them (the
    chunked-streaming parity test guards it)."""
    lib = _native_pack()

    pending: list[np.ndarray] = []
    pending_tokens = 0

    def run(chunk: list[np.ndarray], drop: bool) -> Iterator[dict]:
        if not chunk:
            return
        tokens = np.ascontiguousarray(np.concatenate(chunk), dtype=np.int32)
        lens = np.asarray([len(c) for c in chunk], np.int64)
        cap = int(tokens.size // seq_len + 1)
        ids = np.empty((cap, seq_len), np.int32)
        seg = np.empty((cap, seq_len), np.int32)
        pos = np.empty((cap, seq_len), np.int32)
        mask = np.empty((cap, seq_len), np.float32)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        n = lib.dt_pack(p(tokens, ctypes.c_int32), p(lens, ctypes.c_int64),
                        len(chunk), seq_len, int(drop),
                        p(ids, ctypes.c_int32), p(seg, ctypes.c_int32),
                        p(pos, ctypes.c_int32), p(mask, ctypes.c_float), cap)
        if n < 0:  # defensive: capacity contract violated
            raise RuntimeError("native packer capacity error")
        for r in range(int(n)):
            # copies, not views: a retained view would pin the whole
            # [cap, seq_len] chunk buffer (~64 MB at default chunking)
            yield {"input_ids": ids[r].copy(), "segment_ids": seg[r].copy(),
                   "position_ids": pos[r].copy(),
                   "loss_mask": mask[r].copy()}

    for doc in docs:
        arr = np.asarray(doc, np.int32)
        pending.append(arr)
        pending_tokens += arr.size
        if pending_tokens >= chunk_tokens:
            # carve off complete rows; re-queue the tail tokens so row fill
            # state carries across chunk boundaries exactly like the loop
            total = pending_tokens
            keep = total - (total % seq_len)
            yield from _emit_chunk(run, pending, keep)
            pending = _chunk_tail(pending, keep)
            pending_tokens = sum(a.size for a in pending)
    yield from run(pending, drop_remainder)


def _emit_chunk(run, pending: list[np.ndarray], keep: int) -> Iterator[dict]:
    """Pack the first ``keep`` tokens of ``pending`` (a whole number of
    rows; drop_remainder is moot, there is no remainder)."""
    out: list[np.ndarray] = []
    need = keep
    for a in pending:
        if need <= 0:
            break
        take = min(need, a.size)
        out.append(a[:take])
        need -= take
    yield from run(out, True)


def _chunk_tail(pending: list[np.ndarray], keep: int) -> list[np.ndarray]:
    out: list[np.ndarray] = []
    skip = keep
    for a in pending:
        if skip >= a.size:
            skip -= a.size
            continue
        out.append(a[skip:])
        skip = 0
    return out
