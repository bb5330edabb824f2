"""Tokenizers and corpora — a copy of the JAX package's
``data/datasets.py``.

``ByteTokenizer``, ``WordTokenizer``, ``load_tokenizer``, the corpora of
``text_corpus`` (synthetic, ``files:<glob>``, ``wikitext`` and
``auto``), ``shuffle_seed_for`` and ``batch_iterator`` give the same
documents, ids and packed batches as the JAX package for the same
arguments and files. Two differences, both about the network: the
wikitext lookup and the HF tokenizer read only the local caches and
never try the Hub (``"auto"`` then takes the synthetic corpus at once,
where the JAX package's lookup retries the Hub first), and a tokenizer
that cannot be loaded falls back to ``ByteTokenizer`` with a warning
that names it.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import os
import re
import sys
from typing import Iterable, Iterator, Sequence

import numpy as np

from .packing import pack_documents

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """UTF-8 bytes + 1 offset; id 0 is reserved as pad. vocab_size 257."""

    pad_id = 0
    vocab_size = 257

    def encode(self, text: str) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(max(i - 1, 0) for i in ids if i != 0).decode(
            "utf-8", errors="replace")


def load_tokenizer(name: str = "gpt2"):
    """The HF tokenizer ``name`` (a local directory or a name in the
    local HF cache; nothing is fetched) when ``transformers`` can load
    it, else ``ByteTokenizer``, with a warning."""
    try:
        from transformers import AutoTokenizer
        with _hub_offline():
            tok = AutoTokenizer.from_pretrained(name, local_files_only=True)

        class _Wrap:
            vocab_size = len(tok)
            pad_id = tok.pad_token_id or 0

            def encode(self, text):
                return tok.encode(text)

            def decode(self, ids):
                return tok.decode(ids)

        return _Wrap()
    except Exception as e:
        logger.warning("tokenizer %r could not be loaded from the local "
                       "files (%s: %s); using ByteTokenizer", name,
                       type(e).__name__, e)
        return ByteTokenizer()


@contextlib.contextmanager
def _hub_offline():
    """The HF libraries in offline mode for the block: ``datasets`` and
    ``huggingface_hub`` (imported by the caller's import of ``datasets``
    or ``transformers``) read their caches only and raise at once where
    the Hub would be asked. Their module-level switches are read at call
    time; the environment's are set too, for a module imported inside
    the block."""
    keys = ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE")
    mods = [m for m in (sys.modules.get("huggingface_hub.constants"),
                        sys.modules.get("datasets.config")) if m is not None]
    saved = [(m, {k: getattr(m, k) for k in keys if hasattr(m, k)})
             for m in mods]
    env = {k: os.environ.get(k) for k in keys}
    try:
        for m, old in saved:
            for k in old:
                setattr(m, k, True)
        os.environ.update({k: "1" for k in keys})
        yield
    finally:
        for m, old in saved:
            for k, v in old.items():
                setattr(m, k, v)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_WORDS = ("the of and to in is was for on that with as by at from it an be "
          "this are or his which their has had were been its not they but "
          "one all can more when time state also two first new only world "
          "year over system model train data loss weight merge chain score "
          "miner validator average delta network").split()


def text_corpus(*, split: str = "train", n_docs: int = 256,
                seed: int = 0, source: str = "auto") -> list[str]:
    """Document list. ``source="wikitext"`` reads HF wikitext-103 from
    the local ``datasets`` cache (raises without one, or without
    ``datasets``); ``"synthetic"`` is the offline corpus, deterministic
    per (split, seed); ``"files:<glob>"`` reads local text files;
    ``"auto"`` takes wikitext from the cache, else the synthetic
    corpus."""
    if source.startswith("files:"):
        return _files_corpus(source[len("files:"):], split=split,
                             n_docs=n_docs)
    if source in ("auto", "wikitext"):
        try:
            from datasets import load_dataset
            with _hub_offline():
                ds = load_dataset("wikitext", "wikitext-103-v1",
                                  split=split,
                                  download_mode="reuse_cache_if_exists")
            texts = [t for t in ds["text"][: n_docs * 4] if t.strip()]
            if texts:
                return texts[:n_docs]
        except Exception:
            if source == "wikitext":
                raise
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


def _files_corpus(pattern: str, *, split: str, n_docs: int) -> list[str]:
    """Paragraph documents from local text files matching a glob.
    Deterministic: files sorted by path, paragraphs in file order, and
    the train/test split a stable 9:1 interleave by paragraph index, so
    the two splits never share a document."""
    import glob as _glob

    paths = sorted(p for p in _glob.glob(pattern, recursive=True)
                   if os.path.isfile(p))
    if not paths:
        raise FileNotFoundError(f"files corpus: nothing matches {pattern!r}")
    docs: list[str] = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            continue
        for para in text.split("\n\n"):
            para = para.strip()
            # a one-line header teaches nothing and wastes a packed
            # row boundary
            if len(para) >= 200:
                docs.append(para)
    if not docs:
        raise ValueError(f"files corpus: no >=200-char paragraphs under "
                         f"{pattern!r}")
    keep = (lambda i: i % 10 != 9) if split == "train" else \
           (lambda i: i % 10 == 9)
    return [d for i, d in enumerate(docs) if keep(i)][:n_docs]


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
