"""Speculative decoding: a draft proposes, the target verifies — the port
of the JAX package's ``engine/speculative.py``.

A small DRAFT model proposes ``K`` tokens a slot, the TARGET scores all
``K + 1`` positions in one batched verify forward (engine/serve.py), and
the longest prefix the target agrees with commits. The serving sampler is
a counter PRNG: the token a request emits at stream index *t* is a
function of ``(logits_t, fold_in(PRNGKey(seed), t))`` alone, so the
verify pass computes at every drafted position exactly the token the
plain decode path would pick there, and acceptance is prefix matching
against those picks. Output equals the spec-off stream, greedy or
sampled; a round that accepts nothing is one plain decode step.

Two drafters share one duck-typed protocol (``ready`` /
``propose(slots)`` / ``commit(rid, known)`` / ``drop(rid)`` /
``flush()`` / ``check()`` / ``close()``):

- :class:`DraftEngine`: the small model with its OWN slot-aligned paged
  KV pool (trash page 0, the same ladders and refcounts as the target's,
  private pages only: the draft never shares or copies). Its decode steps
  attend through the decode kernel on the card (counted apart from the
  target's in ``step_dispatches``), its catch-up prefills through the
  flash forward (``prefill_dispatches``). Rejected draft rows roll back
  by LENGTH bookkeeping (``commit`` truncates the ingested-token list to
  the verified prefix), never by copy. A revision watcher may ride along:
  a new draft revision installs between steps and flushes all draft KV.
- :class:`ScriptedDraftSource`: proposals from a pure function of the
  request, no model and no KV (tests force exact 0-accept or all-accept
  rounds with it).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..models import bind, draft_compat, resolve_device
from ..utils import devprof
from .serve import (DEFAULT_PAGE_SIZE, BucketLadder, PagePool, State,
                    _full_prefill, _kv_pages, _lane_seed, _layer_keys,
                    _pick, _scatter_kv, kv_heads, position_cap)

logger = logging.getLogger(__name__)


def compat_reason(draft_model, target_cfg) -> str | None:
    """Why ``draft_model`` cannot draft for a target with ``target_cfg``
    (None = compatible): the drafter family's ``draft_compat``. The real
    vocabularies must be equal, so a GPT-2 drafter may draft for a Llama
    target (and the other way round) over one tokenizer."""
    return draft_compat(draft_model.cfg, target_cfg)


@dataclasses.dataclass
class _DraftState:
    """Per-request draft cache bookkeeping. ``toks[i]`` is the token
    whose KV row sits at draft position *i*; ``stable`` counts the
    leading rows already confirmed against committed output. Rollback =
    truncating ``toks`` (the rows beyond stay, masked by length, and are
    overwritten when those positions are fed again)."""
    pages: list = dataclasses.field(default_factory=list)
    toks: list = dataclasses.field(default_factory=list)
    stable: int = 0


class DraftEngine:
    """The small model as a proposal machine over its own paged KV pool.
    Mirrors GenerationEngine's geometry (trash page 0, page-aligned
    capacity, power-of-two ladders); holds one :class:`_DraftState` per
    live request id, created at the first propose and dropped when the
    serving engine releases the slot."""

    def __init__(self, model, params: State | None = None, *,
                 device="cuda",
                 revision: str | None = None,
                 max_slots: int = 8,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 pool_pages: int = 0,
                 max_seq_len: int = 0,
                 watcher=None):
        if max_slots < 1 or page_size < 1:
            raise ValueError("max_slots and page_size must be >= 1")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = dataclasses.replace(model.cfg, remat=False,
                                       scan_blocks=False)
        self.page_size = page_size
        self.max_slots = max_slots
        self.watcher = watcher
        cap = position_cap(self.cfg)
        self.max_seq_len = (min(max_seq_len or cap, cap)
                            // page_size) * page_size
        if self.max_seq_len < page_size:
            raise ValueError(f"draft max_seq_len {self.max_seq_len} < "
                             f"page_size {page_size}")
        self.pages_per_slot = self.max_seq_len // page_size
        self.pool_pages = pool_pages or (
            1 + self.max_slots * self.pages_per_slot)
        self._slot_ladder = BucketLadder(max_slots)
        self._page_ladder = BucketLadder(self.pages_per_slot)
        self._net = None
        self.revision: str | None = None
        self._layers: list[str] | None = None
        self._kv: tuple[torch.Tensor, torch.Tensor] | None = None
        self.pool: PagePool | None = None
        self._states: dict[int, _DraftState] = {}
        self.flush_count = 0
        # forwards by kind: one-query steps, context prefills
        self.step_dispatches = 0
        self.prefill_dispatches = 0
        # set by GenerationEngine when tracing is on: cold catch-up
        # prefills ("spec_draft") land on the request timelines
        self.trace = None
        if params is not None:
            self.install_params(params, revision=revision)

    # -- weights ------------------------------------------------------------
    @property
    def ready(self) -> bool:
        return self._net is not None

    def install_params(self, params: State, *,
                       revision: str | None = None) -> None:
        """Bind a draft revision and flush every draft state (draft KV
        is a function of the draft weights)."""
        placed = {k: v.to(self.device) for k, v in params.items()}
        net = bind(self.cfg, placed)
        if self._layers is None:
            self._layers = _layer_keys(placed)
            self._init_kv()
        self._net = net
        self.revision = revision
        self.flush()

    def _init_kv(self) -> None:
        cfg = self.cfg
        shape = (len(self._layers), self.pool_pages, self.page_size,
                 kv_heads(cfg), cfg.head_dim)
        dt = cfg.compute_dtype()
        self._kv = (torch.zeros(shape, dtype=dt, device=self.device),
                    torch.zeros(shape, dtype=dt, device=self.device))
        self.pool = PagePool(self.pool_pages)

    # -- state lifecycle ----------------------------------------------------
    def drop(self, rid: int) -> None:
        st = self._states.pop(rid, None)
        if st is not None and self.pool is not None:
            for p in st.pages:
                self.pool.decref(p)

    def flush(self) -> None:
        """Drop every draft state and release its pages; live requests
        re-prefill their draft context at the next propose."""
        for rid in list(self._states):
            self.drop(rid)
        self.flush_count += 1

    def commit(self, rid: int, known: Sequence[int]) -> None:
        """Reconcile the draft cache with the committed stream (prompt +
        emitted tokens): keep the longest prefix of ingested tokens equal
        to it, truncate the rest."""
        st = self._states.get(rid)
        if st is None:
            return
        i, n = st.stable, min(len(st.toks), len(known))
        while i < n and st.toks[i] == known[i]:
            i += 1
        del st.toks[i:]
        st.stable = i

    def check(self) -> None:
        """Draft-pool accounting audit: every referenced page is owned by
        exactly one live draft state."""
        if self.pool is None:
            return
        expected: dict[int, int] = {}
        for st in self._states.values():
            for p in st.pages:
                expected[p] = expected.get(p, 0) + 1
        self.pool.check(expected)

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.close()
        self.flush()

    # -- forwards -------------------------------------------------------------
    def _ensure_pages(self, st: _DraftState, need: int) -> bool:
        while len(st.pages) < need:
            got = self.pool.alloc(1)
            if got is None:
                return False
            st.pages.extend(got)
        return True

    def _prefill_state(self, st: _DraftState, toks: list) -> None:
        """Draft context prefill (cold start, after a flush): the
        committed tokens through the draft forward, the KV paged out. No
        pick: the committed stream already names every next token up to
        the live position."""
        P = self.page_size
        mp = self._page_ladder.bucket_for((len(toks) + P - 1) // P)
        devprof.call("serve.draft", _full_prefill, self._net, self._kv, toks,
                     st.pages, P, self._page_ladder, bucket=f"p{mp}")
        self.prefill_dispatches += 1
        st.toks = list(toks)
        st.stable = len(st.toks)   # prefill ingests committed tokens only

    @torch.no_grad()
    def _step_batch(self, jobs: list[dict], feeds: list[int],
                    idx_off: list[int]) -> list[int]:
        """One batched draft step over ``jobs``: feed token *i* of each
        job at its state's current length, write the KV row, return the
        seeded picks. ``idx_off[i]`` is the stream index the pick is a
        candidate for: the key the target's verify uses there, so sampled
        drafts share the verifier's random numbers."""
        P = self.page_size
        sb = self._slot_ladder.bucket_for(len(jobs))
        pb = self._page_ladder.bucket_for(
            max(len(j["st"].toks) // P + 1 for j in jobs))
        tables = np.zeros((sb, pb), np.int32)
        seq_lens = np.zeros((sb,), np.int32)
        tokens = np.zeros((sb, 1), np.int64)
        temps = np.zeros((sb,), np.float32)
        top_ps = np.ones((sb,), np.float32)
        seeds = np.zeros((sb,), np.int64)
        tok_idx = np.zeros((sb,), np.int64)
        for i, j in enumerate(jobs):
            st, req = j["st"], j["slot"].req
            row = st.pages[:pb]
            tables[i, :len(row)] = row
            seq_lens[i] = len(st.toks)
            tokens[i, 0] = feeds[i]
            temps[i] = req.temperature
            top_ps[i] = req.top_p
            seeds[i] = _lane_seed(req.seed)
            tok_idx[i] = idx_off[i]
        dev = self.device

        def step():
            tables_t = torch.from_numpy(tables).to(dev)
            lens_t = torch.from_numpy(seq_lens).to(dev)
            logits, kvs = self._net(torch.from_numpy(tokens).to(dev),
                                    position_ids=lens_t[:, None].long(),
                                    kv_pages=_kv_pages(self._kv),
                                    page_tables=tables_t, kv_lens=lens_t,
                                    sow_kv=True)
            lens_l = lens_t.long()
            page_idx = tables_t.long().gather(1, (lens_l // P)[:, None])
            _scatter_kv(self._kv, kvs, page_idx, (lens_l % P)[:, None])
            return _pick(logits[:, -1, :self.cfg.vocab_size], temps,
                         top_ps, seeds, tok_idx)

        # the device observatory's serve.draft (the JAX bucket)
        picks = devprof.call("serve.draft", step, bucket=f"{sb}x{pb}")
        self.step_dispatches += 1
        for i, j in enumerate(jobs):
            j["st"].toks.append(int(feeds[i]))
        return picks

    def propose(self, slots: Sequence) -> dict[int, list[int]]:
        """Propose up to ``slot.spec_window`` tokens for each slot: catch
        the draft cache up to the committed stream (a prefill when cold,
        batched one-token steps for the steady-state gap of 0 or 1), then
        the proposal loop, one draft step over all still-proposing slots
        at a time. A slot the draft pool or position capacity cannot
        carry drops out (its lane verifies as plain decode)."""
        if self._net is None:
            return {}
        jobs: list[dict] = []
        for slot in slots:
            k = int(getattr(slot, "spec_window", 0))
            if k <= 0:
                continue
            known = list(slot.req.prompt) + list(slot.req.tokens)
            tgt_len = slot.seq_len
            if tgt_len + k > self.max_seq_len or tgt_len >= len(known):
                continue
            st = self._states.get(slot.req.rid)
            if st is None:
                st = self._states[slot.req.rid] = _DraftState()
            if st.toks[:st.stable] != known[:st.stable]:
                # desync (unreachable under the drop/commit discipline):
                # rebuild rather than propose garbage
                st.toks = []
                st.stable = 0
            if not self._ensure_pages(st, (tgt_len + k) // self.page_size
                                      + 1):
                continue
            if len(st.toks) < tgt_len and \
                    tgt_len - len(st.toks) > self.page_size:
                st.toks = []
                st.stable = 0
            if not st.toks and tgt_len > 0:
                t0 = time.perf_counter()
                self._prefill_state(st, known[:tgt_len])
                if self.trace is not None:
                    self.trace.stage(
                        slot.req.rid, "spec_draft", tokens=tgt_len,
                        dur_ms=round((time.perf_counter() - t0) * 1e3, 3))
            jobs.append({"slot": slot, "st": st, "known": known, "k": k,
                         "out": []})
        if not jobs:
            return {}
        # catch-up: feed the committed tokens the draft cache lacks
        while True:
            lag = [j for j in jobs if len(j["st"].toks) < j["slot"].seq_len]
            if not lag:
                break
            self._step_batch(
                lag, [j["known"][len(j["st"].toks)] for j in lag],
                [0] * len(lag))
        # proposal loop: step s proposes the candidate for stream index
        # len(req.tokens) + s, feeding last_tok first, then its own pick
        max_k = max(j["k"] for j in jobs)
        for s in range(max_k):
            live = [j for j in jobs if s < j["k"]]
            if not live:
                break
            feeds = [j["known"][j["slot"].seq_len] if s == 0
                     else j["out"][-1] for j in live]
            idx = [len(j["slot"].req.tokens) + s for j in live]
            picks = self._step_batch(live, feeds, idx)
            for i, j in enumerate(live):
                j["out"].append(int(picks[i]))
        return {j["slot"].req.rid: j["out"] for j in jobs}


class ScriptedDraftSource:
    """Host-side drafter: proposals come from ``fn(req, k) -> tokens``
    with no model, no KV and no device work (exact 0-accept or
    all-accept rounds in tests). ``commit``/``drop``/``flush`` have
    nothing to roll back."""

    def __init__(self, fn: Callable[[Any, int], Sequence[int]], *,
                 revision: str | None = "scripted"):
        self._fn = fn
        self.revision = revision
        self.ready = True

    def propose(self, slots: Sequence) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for slot in slots:
            k = int(getattr(slot, "spec_window", 0))
            if k <= 0:
                continue
            toks = [int(t) for t in self._fn(slot.req, k)][:k]
            if toks:
                out[slot.req.rid] = toks
        return out

    def commit(self, rid: int, known: Sequence[int]) -> None:
        pass

    def drop(self, rid: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def check(self) -> None:
        pass

    def close(self) -> None:
        pass
