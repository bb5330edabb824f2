"""Tokenizers and corpora — copies of the JAX package's
``data/datasets.py`` pieces the training slice runs.

``ByteTokenizer``, ``WordTokenizer``, the deterministic synthetic corpus,
``shuffle_seed_for`` and ``batch_iterator`` give the same documents, ids
and packed batches as the JAX package for the same arguments. Only the
synthetic source is ported: ``source="auto"`` takes it (what the JAX
package falls back to without an HF cache); ``"wikitext"`` and
``"files:<glob>"`` raise.
"""

from __future__ import annotations

import collections
import hashlib
import re
from typing import Iterable, Iterator, Sequence

import numpy as np

from .packing import pack_documents


class ByteTokenizer:
    """UTF-8 bytes + 1 offset; id 0 is reserved as pad. vocab_size 257."""

    pad_id = 0
    vocab_size = 257

    def encode(self, text: str) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(max(i - 1, 0) for i in ids if i != 0).decode(
            "utf-8", errors="replace")


_WORDS = ("the of and to in is was for on that with as by at from it an be "
          "this are or his which their has had were been its not they but "
          "one all can more when time state also two first new only world "
          "year over system model train data loss weight merge chain score "
          "miner validator average delta network").split()


def text_corpus(*, split: str = "train", n_docs: int = 256,
                seed: int = 0, source: str = "auto") -> list[str]:
    """Document list: the offline synthetic corpus ("synthetic" or
    "auto"), deterministic per (split, seed). The HF wikitext and
    local-files sources are not ported and raise."""
    if source not in ("auto", "synthetic"):
        raise NotImplementedError(
            f"corpus source {source!r}: only the synthetic corpus is "
            "ported (ROADMAP 'Slices of the port', slice 7)")
    # synthetic: markov-ish word stream, deterministic per (split, seed)
    h = int(hashlib.sha256(f"{split}:{seed}".encode()).hexdigest()[:8], 16)
    rng = np.random.default_rng(h)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(20, 200))
        idx = rng.integers(0, len(_WORDS), size=n)
        # simple bigram bias: repeat previous word sometimes for structure
        words = [_WORDS[i] for i in idx]
        for j in range(1, n):
            if rng.random() < 0.15:
                words[j] = words[j - 1]
        docs.append(" ".join(words) + ".")
    return docs


# the ONE tokenization rule WordTokenizer fits and encodes with
_WORD_RE = re.compile(r"\w+|[^\w\s]")


class WordTokenizer:
    """Frequency-ranked word-level tokenizer fit on a corpus:
    deterministic, so every role fitting on the same corpus builds the
    identical vocab. Ids 0 (pad) and 1 (unknown) are reserved."""

    pad_id = 0
    _UNK = 1

    def __init__(self, docs: Iterable[str], *, vocab_size: int = 50257):
        counts: collections.Counter = collections.Counter()
        for d in docs:
            counts.update(_WORD_RE.findall(d))
        # stable rank: by (-count, word) so ties don't depend on dict order
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        self._id = {w: i + 2 for i, (w, _) in
                    enumerate(ranked[: vocab_size - 2])}
        self._word = {i: w for w, i in self._id.items()}
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [self._id.get(w, self._UNK) for w in _WORD_RE.findall(text)]

    def decode(self, ids) -> str:
        return " ".join(self._word.get(i, "<unk>") for i in ids
                        if i != self.pad_id)


def shuffle_seed_for(identity: str) -> int:
    """Stable per-identity shuffle seed: miners sharing a corpus see
    different batch orders."""
    digest = hashlib.sha256(identity.encode()).digest()
    return int.from_bytes(digest[:4], "little")


def batch_iterator(docs: Iterable[str], tokenizer, *, batch_size: int,
                   seq_len: int, repeat: bool = False,
                   max_vocab: int | None = None,
                   shuffle: bool = False, seed: int = 0) -> Iterator[dict]:
    """Tokenize -> pack -> batch. Yields dicts of ``[B, T]`` numpy arrays
    (``input_ids``, ``segment_ids``, ``position_ids`` int32, ``loss_mask``
    f32) ready for ``TrainEngine.place_batch``.

    ``shuffle=True`` permutes the document order with a fresh permutation
    per epoch (deterministic from ``seed``); eval paths keep the fixed
    order so scores stay comparable across rounds."""
    docs = list(docs)  # a one-shot iterator + repeat=True would spin
    rng = np.random.default_rng(seed) if shuffle else None

    def rows():
        while True:
            epoch_docs = docs
            if rng is not None:
                epoch_docs = [docs[i] for i in rng.permutation(len(docs))]
            token_docs = (tokenizer.encode(d) for d in epoch_docs)
            if max_vocab is not None:
                token_docs = ([t % max_vocab for t in d] for d in token_docs)
            yield from pack_documents(token_docs, seq_len)
            if not repeat:
                return

    buf = []
    for row in rows():
        buf.append(row)
        if len(buf) == batch_size:
            yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}
            buf = []
