"""Greedy sequence packing into fixed ``[batch, seq_len]`` rows — a copy
of the JAX package's ``data/packing.py`` Python packer.

Output per row:
- input_ids:    packed tokens, zero-padded at the tail
- segment_ids:  which document each token belongs to (0-based; padding gets a
                fresh id so it attends to nothing useful)
- position_ids: restart at 0 per document (wpe correctness)
- loss_mask:    1.0 on real tokens whose *successor* is in the same document
                (cross-document next-token predictions are excluded), 0 on pad

These feed the models' segment-aware causal attention. The JAX package
also ships a C++ packer (``native/packing.cpp``, behaviourally identical)
that belongs to it; the port does not load it and always runs this loop.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np


def pack_documents(docs: Iterable[Sequence[int]], seq_len: int,
                   *, drop_remainder: bool = True) -> Iterator[dict]:
    """Greedy-pack token lists into rows of exactly ``seq_len``.

    Documents longer than seq_len are split. Yields one row dict at a time;
    callers batch rows (datasets.batch_iterator)."""
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
