"""Composition of the port's roles — the miner's and the averager's half
of the JAX package's ``neurons/common.py`` (``Components`` and
``build``): the model, the ``TrainEngine``, the ``memory`` or ``local``
transport, the local chain and address store, the tokenizer, and the
train, self-eval and held-out batch streams, driven by ``RunConfig``.

The device is the card unless the caller asks for the CPU the way the JAX
roles do: ``DT_FORCE_PLATFORM=cpu`` in the environment. Without it,
everything is placed on ``cuda``, and building raises if there is none.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Iterable

from ..chain import LocalAddressStore, LocalChain
from ..config import RunConfig
from ..data.datasets import (ByteTokenizer, WordTokenizer, batch_iterator,
                             shuffle_seed_for, text_corpus)
from ..engine.train import TrainEngine, default_optimizer
from ..models import gpt2
from ..transport import InMemoryTransport, LocalFSTransport

logger = logging.getLogger(__name__)


def resolve_role_device() -> str:
    """``"cpu"`` when ``DT_FORCE_PLATFORM=cpu``, else ``"cuda"`` (which
    the engine then requires); any other value raises."""
    val = os.environ.get("DT_FORCE_PLATFORM", "").strip().lower()
    if val in ("", "cuda", "gpu"):
        return "cuda"
    if val == "cpu":
        return "cpu"
    raise ValueError(f"DT_FORCE_PLATFORM={val!r}: expected cpu or cuda")


@dataclasses.dataclass
class Components:
    cfg: RunConfig
    model: Any
    model_cfg: Any
    engine: TrainEngine
    transport: Any
    chain: Any
    address_store: Any
    tokenizer: Any

    def train_batches(self, *, repeat: bool = True) -> Iterable[dict]:
        """The shuffled packed train stream (per-hotkey order), behind
        the look-ahead thread when ``--prefetch-depth`` > 0."""
        docs = text_corpus(split="train", source=self.cfg.dataset,
                           n_docs=self.cfg.n_docs)
        it = batch_iterator(docs, self.tokenizer,
                            batch_size=self.cfg.batch_size,
                            seq_len=self.cfg.seq_len, repeat=repeat,
                            max_vocab=self.model_cfg.vocab_size,
                            shuffle=True,
                            seed=shuffle_seed_for(self.cfg.hotkey))
        if self.cfg.prefetch_depth > 0:
            from ..data.prefetch import prefetch
            it = prefetch(it, depth=self.cfg.prefetch_depth)
        return it

    _test_docs_cache = None

    def _test_docs(self) -> list[str]:
        if self._test_docs_cache is None:
            self._test_docs_cache = text_corpus(
                split="test", source=self.cfg.dataset,
                n_docs=max(256, self.cfg.n_docs // 8))
        return self._test_docs_cache

    def _batches_over(self, docs) -> Callable[[], Iterable[dict]]:
        cfg = self.cfg

        def factory():
            it = batch_iterator(docs, self.tokenizer,
                                batch_size=cfg.batch_size,
                                seq_len=cfg.eval_seq_len,
                                max_vocab=self.model_cfg.vocab_size)
            for i, b in enumerate(it):
                if i >= cfg.eval_batches:
                    break
                yield b

        return factory

    def eval_batches(self) -> Callable[[], Iterable[dict]]:
        """The server-side held-out shard (the averager's publish guard,
        validator scoring): the front half of the test split, disjoint
        from the miners' self-eval shard."""
        docs = self._test_docs()
        return self._batches_over(docs[: max(1, len(docs) // 2)]
                                  if len(docs) >= 4 else docs)

    def miner_val_batches(self) -> Callable[[], Iterable[dict]]:
        """The miner's self-eval shard: a per-hotkey rotation of the back
        half of the test split, disjoint from the validators' shard."""
        docs = self._test_docs()
        if len(docs) < 4:
            logger.warning(
                "test split too small (%d docs) to give the miner a "
                "disjoint self-eval shard; guard evals will share the "
                "validator's data", len(docs))
            tail = docs
        else:
            tail = docs[len(docs) // 2:]
        off = shuffle_seed_for(self.cfg.hotkey) % len(tail)
        return self._batches_over(tail[off:] + tail[:off])


def build(cfg: RunConfig) -> Components:
    """The role's components. Raises NotImplementedError for a flag
    value the port has not brought over (``RunConfig.check_ported``)."""
    device = resolve_role_device()
    cfg.check_ported(device)
    if cfg.model not in gpt2.PRESETS:
        raise NotImplementedError(
            f"--model {cfg.model}: the port has the GPT-2 presets "
            f"{sorted(gpt2.PRESETS)}; Llama is slice 7")
    model_cfg = gpt2.PRESETS[cfg.model]
    if cfg.logits_dtype:
        model_cfg = dataclasses.replace(model_cfg,
                                        logits_dtype=cfg.logits_dtype)
    model, model_cfg = gpt2.make_model(model_cfg)
    engine = TrainEngine(
        model,
        optimizer=default_optimizer(cfg.learning_rate,
                                    grad_clip=cfg.grad_clip,
                                    weight_decay=cfg.weight_decay),
        fused_loss=cfg.fused_loss, accum_steps=cfg.accum_steps,
        device=device)
    if cfg.backend == "memory":
        transport = InMemoryTransport()
    else:
        transport = LocalFSTransport(os.path.join(cfg.work_dir, "artifacts"))
    chain_dir = os.path.join(cfg.work_dir, "chain")
    chain = LocalChain(chain_dir, my_hotkey=cfg.hotkey,
                       epoch_length=cfg.epoch_length,
                       vpermit_stake_limit=cfg.vpermit_stake_limit)
    address_store = LocalAddressStore(chain_dir)
    if cfg.tokenizer == "byte" or (cfg.tokenizer == "auto"
                                   and model_cfg.vocab_size < 50257):
        tokenizer = ByteTokenizer()
    elif cfg.tokenizer == "word":
        # corpus-fit word vocab, deterministic per corpus: every role of a
        # deployment rebuilds the identical mapping
        tokenizer = WordTokenizer(
            text_corpus(split="train", source=cfg.dataset),
            vocab_size=model_cfg.vocab_size)
    else:
        raise NotImplementedError(
            f"--tokenizer {cfg.tokenizer} at vocab {model_cfg.vocab_size}: "
            f"the HF and BPE tokenizers are not ported; use --tokenizer "
            f"word or byte")
    return Components(cfg=cfg, model=model, model_cfg=model_cfg,
                      engine=engine, transport=transport, chain=chain,
                      address_store=address_store, tokenizer=tokenizer)
