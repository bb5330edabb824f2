"""Byte-level BPE trained on a local corpus — a copy of the JAX
package's ``data/bpe.py``.

The reference tokenizes with the published GPT-2 BPE. This package
fetches nothing, but the algorithm is local: train the same byte-level
BPE (the ``tokenizers`` Rust trainer HF itself uses) on whatever real
text the machine has. The result has a 32k subword vocabulary, a
Zipfian id distribution over the embedding table and multi-byte merges:
what the big-vocabulary loss paths (``ops/losses.py``,
``ops/fused_ce.py``) exist to serve.

Determinism: the trainer is count-based over a sorted file list, so
every role training on the same corpus builds the identical vocab, and
the saved ``tokenizer.json`` bytes equal the JAX package's for the same
documents or files. Roles sharing a ``--work-dir`` share the saved file
and skip retraining. ``tokenizers`` is imported inside ``train`` and
``load`` only.
"""

from __future__ import annotations

import glob as _glob
import logging
import os
from typing import Iterable, Sequence

logger = logging.getLogger(__name__)

# the default training corpus: real English prose shipped with the OS
# (package READMEs, licenses, changelogs)
DEFAULT_CORPUS_GLOBS = (
    "/usr/share/doc/**/*",
    "/usr/share/common-licenses/*",
)
_SKIP_SUFFIXES = (".gz", ".png", ".jpg", ".html", ".css", ".js", ".gif",
                  ".svg", ".ico", ".pdf", ".zip")


def corpus_files(globs: Sequence[str] = DEFAULT_CORPUS_GLOBS,
                 *, max_bytes: int = 64 * 1024 * 1024) -> list[str]:
    """Sorted plain-text file list under the given globs, size-capped."""
    paths = []
    total = 0
    for pattern in globs:
        for p in sorted(_glob.glob(pattern, recursive=True)):
            if not os.path.isfile(p) or p.lower().endswith(_SKIP_SUFFIXES):
                continue
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            if total + size > max_bytes:
                return paths
            paths.append(p)
            total += size
    return paths


class BPETokenizer:
    """The tokenizer protocol (encode/decode/vocab_size/pad_id) around a
    byte-level BPE. Id 0 is the pad token, as for every tokenizer here
    (``data/packing.py`` pads rows with 0)."""

    pad_id = 0

    def __init__(self, tok):
        self._tok = tok
        self.vocab_size = tok.get_vocab_size()

    # -- training / persistence ---------------------------------------------
    @classmethod
    def train(cls, *, vocab_size: int = 32000,
              files: Sequence[str] | None = None,
              docs: Iterable[str] | None = None,
              save_path: str | None = None) -> "BPETokenizer":
        """Train on local ``files`` (default: ``corpus_files()``) or an
        explicit document iterable. ``save_path`` persists tokenizer.json
        for instant reload (:meth:`load`)."""
        from tokenizers import Tokenizer, models, pre_tokenizers, trainers
        from tokenizers.decoders import ByteLevel as ByteLevelDecoder

        tok = Tokenizer(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = ByteLevelDecoder()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size,
            special_tokens=["<|pad|>"],      # id 0 (the pad contract)
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False)
        if docs is not None:
            tok.train_from_iterator(docs, trainer)
        else:
            files = list(files) if files is not None else corpus_files()
            if not files:
                raise FileNotFoundError("BPE training: no corpus files")
            tok.train(files, trainer)
        self = cls(tok)
        logger.info("BPE trained: %d tokens (requested %d)",
                    self.vocab_size, vocab_size)
        if save_path:
            os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                        exist_ok=True)
            # atomic publish: roles of one deployment (and the ranks of a
            # world) start together against a shared work_dir, and
            # train_or_load's exists-check must never see a half-written
            # tokenizer.json (training is deterministic, so concurrent
            # trainers replace it with the identical file)
            tmp = f"{save_path}.tmp.{os.getpid()}"
            tok.save(tmp)
            os.replace(tmp, save_path)
        return self

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        from tokenizers import Tokenizer
        return cls(Tokenizer.from_file(path))

    @classmethod
    def train_or_load(cls, path: str, *, vocab_size: int = 32000,
                      files: Sequence[str] | None = None) -> "BPETokenizer":
        """Load ``path`` when present, else train and save there: roles
        sharing a work_dir train once; roles that do not still converge
        on the identical vocab (deterministic trainer, sorted files)."""
        if os.path.exists(path):
            return cls.load(path)
        return cls.train(vocab_size=vocab_size, files=files, save_path=path)

    # -- protocol ------------------------------------------------------------
    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text).ids

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids if i != self.pad_id])
