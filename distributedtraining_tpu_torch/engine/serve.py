"""Serving plane: continuous-batching greedy generation over a paged KV
cache — the port of the JAX package's ``engine/serve.py`` (its greedy,
unified subset).

- **Paged KV cache.** One page pool per process, ``[layers, pages,
  page_size, kv_heads, head_dim]``, with per-slot page tables; page 0 is
  the trash page that padded lanes and padded table entries point at. A
  sequence owns exactly the pages its length needs; decode attends each
  slot's own pages through its table (ops/paged_attention.py: the CUDA
  kernel on the card, its plain version on the CPU). Page exhaustion
  preempts the youngest sequence back to the queue (deterministic under
  greedy decode).
- **Continuous batching.** Every step admits queued requests into free
  slots, decodes one token for every active slot, and evicts finished
  sequences at once.
- **Bucketed shapes.** Prompts pad to a power-of-two page ladder and
  decode batches to (slot, page) buckets, the JAX package's ladders. The
  JAX engine also pads a batch up to an already-compiled bigger bucket;
  the eager port has nothing compiled to reuse and takes the exact fit.
- **Hot swap.** Between steps the engine takes a staged ``(revision,
  state)`` from its watcher (any object with ``take_pending()`` and
  ``close()``) and rebinds its weights to it without a copy. Policy
  "drain": in-flight sequences finish on the revision they started on,
  admission pauses until they do; "restart": in-flight prompts requeue
  on the new revision.

What the slice does not carry is refused, never approximated: sampled
decode, the prefix cache, speculative drafting, disaggregated phases,
request traces and the transport-backed revision watcher raise
NotImplementedError naming their ROADMAP item.

Metrics go to utils/obs.py as ``serve.*``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import threading
import time
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Sequence

import numpy as np
import torch

from ..models.gpt2 import GPT2, bind, resolve_device
from ..utils import obs

logger = logging.getLogger(__name__)

State = Mapping[str, torch.Tensor]

DEFAULT_PAGE_SIZE = 16

_SERVING_ITEM = "ROADMAP 'Slices of the port': slice 6, serving completeness"

_LIVE_FRONTENDS: "weakref.WeakSet[ServeHTTPFrontend]" = weakref.WeakSet()


def live_frontends() -> list["ServeHTTPFrontend"]:
    """Frontends with a listening socket (test hygiene guards)."""
    return list(_LIVE_FRONTENDS)


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({_SERVING_ITEM})")


# ---------------------------------------------------------------------------
# Requests and slots
# ---------------------------------------------------------------------------

_RID = itertools.count()


@dataclasses.dataclass
class ServeRequest:
    """One generation request's lifecycle. ``tokens`` accumulates the
    GENERATED ids; ``revision`` is the base revision that decoded the
    finished output."""
    prompt: list
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    tokens: list = dataclasses.field(default_factory=list)
    status: str = "queued"      # queued | active | done | truncated
    revision: str | None = None
    submitted_t: float = dataclasses.field(default_factory=time.time)
    done_evt: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> bool:
        return self.done_evt.wait(timeout)


@dataclasses.dataclass
class _Slot:
    req: ServeRequest
    pages: list          # page-pool indices this sequence owns
    seq_len: int         # tokens currently in the KV cache
    last_tok: int        # next input token (already emitted)
    order: int           # admission order (preemption picks the youngest)
    last_emit_t: float = 0.0


# ---------------------------------------------------------------------------
# Bucket ladder and page pool
# ---------------------------------------------------------------------------

class BucketLadder:
    """Power-of-two ladder up to ``top``, then multiples of ``top``."""

    def __init__(self, top: int):
        if top < 1:
            raise ValueError(f"ladder top must be >= 1, got {top}")
        buckets = []
        b = 1
        while b < top:
            buckets.append(b)
            b *= 2
        buckets.append(top)
        self.buckets = tuple(buckets)

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"need >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top


class PagePool:
    """Refcounted page accounting over pool indices ``1..pool_pages-1``
    (page 0 is the trash page and is never allocated)."""

    def __init__(self, pool_pages: int):
        self.total = pool_pages - 1
        self._free: list[int] = list(range(1, pool_pages))
        self._refs: dict[int, int] = {}

    @property
    def free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if len(self._free) < n:
            return None
        out = self._free[:n]
        del self._free[:n]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, page: int) -> None:
        self._refs[page] += 1

    def decref(self, page: int) -> None:
        left = self._refs[page] - 1
        if left:
            self._refs[page] = left
        else:
            del self._refs[page]
            self._free.append(page)

    def refs(self, page: int) -> int:
        return self._refs.get(page, 0)

    def check(self, expected: dict[int, int] | None = None) -> None:
        """Conservation: every allocatable page is free or referenced,
        never both; with ``expected``, the refcounts match exactly."""
        if len(self._free) + len(self._refs) != self.total:
            raise AssertionError(
                f"page leak: {len(self._free)} free + {len(self._refs)} "
                f"referenced != {self.total} total")
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError(f"non-positive refcount in {self._refs}")
        if set(self._free) & set(self._refs):
            raise AssertionError("page simultaneously free and referenced")
        if expected is not None and expected != self._refs:
            raise AssertionError(
                f"refcount drift: engine expects {expected}, pool holds "
                f"{self._refs}")


# ---------------------------------------------------------------------------
# Reference oracle
# ---------------------------------------------------------------------------

@torch.no_grad()
def reference_generate(model, params: State, prompt: Sequence[int],
                       max_new_tokens: int, *, eos_id: int | None = None
                       ) -> list[int]:
    """The O(T^2) correctness oracle: greedy argmax over a FULL forward
    of the growing sequence per token (right-padded to a multiple of 16
    and masked), no cache, nothing shared with the engine's decode path.
    Runs on the device ``params`` lie on."""
    net = bind(model, params)
    cfg = net.cfg
    device = net.wte.device
    toks = [int(t) for t in prompt]
    total = len(toks) + max_new_tokens
    t_pad = ((total + 15) // 16) * 16
    buf = torch.zeros((1, t_pad), dtype=torch.int64, device=device)
    buf[0, :len(toks)] = torch.tensor(toks, device=device)
    pos = torch.arange(t_pad, device=device)[None, :]
    cur = len(toks)
    out: list[int] = []
    for _ in range(max_new_tokens):
        amask = (pos < cur).to(torch.int32)
        logits = net(buf, attention_mask=amask)
        nxt = int(torch.argmax(logits[0, cur - 1, :cfg.vocab_size]))
        buf[0, cur] = nxt
        out.append(nxt)
        cur += 1
        if eos_id is not None and nxt == eos_id:
            break
    return out


def _layer_keys(state: State) -> list[str]:
    """Transformer block prefixes of a state dict, in layer order
    (``h_0..`` for GPT-2)."""
    found = sorted({(int(k.split(".")[0][2:]), k.split(".")[0])
                    for k in state
                    if k.startswith("h_") and k.split(".")[0][2:].isdigit()})
    if not found:
        raise ValueError("no transformer block keys (h_*) in the state; "
                         "is this an unrolled GPT-2 base?")
    return [k for _, k in found]


class BaseRevisionWatcher:
    """The transport-backed revision watcher is not ported yet: the
    engine hot-swaps from any object with ``take_pending()``/``close()``;
    one that polls a transport needs the ported transport and
    serialization planes."""

    def __init__(self, *args, **kwargs):
        raise _unsupported("BaseRevisionWatcher over a transport")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class GenerationEngine:
    """Continuous-batching greedy decoder over a paged KV cache.

    ``model`` is a GPT2 (its config is what counts: the engine builds its
    own copy and binds ``params``, a state dict, to it); ``device`` is
    where the pool lives and the forward runs, ``"cuda"`` unless the
    caller asks for the CPU. Thread contract: ``submit`` is thread-safe;
    ``step`` is driven from ONE thread (``ServeLoop`` or the caller)."""

    def __init__(self, model: GPT2, params: State | None = None, *,
                 device="cuda",
                 revision: str | None = None,
                 max_slots: int = 8,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 pool_pages: int = 0,
                 max_seq_len: int = 0,
                 max_new_tokens: int = 64,
                 eos_id: int | None = None,
                 swap_policy: str = "drain",
                 watcher=None,
                 max_queue: int = 0,
                 prefix_cache: bool = False,
                 debug_invariants: bool = False,
                 draft=None,
                 trace: bool = False,
                 phase: str = "unified"):
        if prefix_cache:
            raise _unsupported("prefix_cache=True")
        if draft is not None:
            raise _unsupported("speculative decoding (draft=)")
        if phase != "unified":
            raise _unsupported(f"phase={phase!r}")
        if trace:
            raise _unsupported("trace=True (request traces)")
        if swap_policy not in ("drain", "restart"):
            raise ValueError(f"swap_policy must be drain|restart, "
                             f"got {swap_policy!r}")
        if watcher is not None and not (hasattr(watcher, "take_pending")
                                        and hasattr(watcher, "close")):
            raise TypeError("watcher needs take_pending() and close()")
        if max_slots < 1 or page_size < 1:
            raise ValueError("max_slots and page_size must be >= 1")
        self.device = resolve_device(device)
        cfg = dataclasses.replace(model.cfg, remat=False, scan_blocks=False)
        self.cfg = cfg
        self.model: GPT2 | None = None
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.swap_policy = swap_policy
        self.watcher = watcher
        cap = cfg.n_positions
        # page-align DOWN so no prefill bucket exceeds the position
        # capacity
        self.max_seq_len = (min(max_seq_len or cap, cap)
                            // page_size) * page_size
        if self.max_seq_len < page_size:
            raise ValueError(f"max_seq_len {self.max_seq_len} < page_size "
                             f"{page_size}")
        self.pages_per_slot = self.max_seq_len // page_size
        self.pool_pages = pool_pages or (
            1 + self.max_slots * self.pages_per_slot)
        if self.pool_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"pool_pages {self.pool_pages} cannot hold even one "
                f"max-length sequence ({self.pages_per_slot} pages) + "
                "the trash page")
        self._slot_ladder = BucketLadder(max_slots)
        # one ladder serves decode context pages and prefill lengths
        self._page_ladder = BucketLadder(self.pages_per_slot)

        self.revision: str | None = None
        self._layers: list[str] | None = None
        self._kv: tuple[torch.Tensor, torch.Tensor] | None = None
        self.pool: PagePool | None = None
        self.max_queue = max_queue
        self.debug_invariants = debug_invariants
        self.shed_count = 0
        self._active: list[_Slot] = []
        self._queue: deque[ServeRequest] = deque()
        self._qlock = threading.Lock()
        self._work_evt = threading.Event()
        self._pending_swap: tuple[str | None, State] | None = None
        # set on preemption, cleared when a slot finishes: admission
        # would otherwise re-take the pages growth just freed
        self._admit_hold = False
        self._order = itertools.count()
        self._tok_rate_ema: float | None = None
        self.steps = 0
        self.decode_dispatches = 0   # decode forwards run (one per step
        #                              with an active batch)
        self.tokens_emitted = 0
        if params is not None:
            self.install_params(params, revision=revision)

    # -- weights ------------------------------------------------------------
    def install_params(self, params: State, *,
                       revision: str | None = None) -> None:
        """Bind a base revision as the serving weights (boot and swap):
        the engine's model copy takes the state's tensors (moved to the
        engine's device) without copying them on the device."""
        placed = {k: v.to(self.device) for k, v in params.items()}
        model = bind(self.cfg, placed)      # raises on a foreign state
        if self._layers is None:
            self._layers = _layer_keys(placed)
            self._init_kv()
        self.model = model
        self.revision = revision

    def _init_kv(self) -> None:
        cfg = self.cfg
        shape = (len(self._layers), self.pool_pages, self.page_size,
                 cfg.n_head, cfg.head_dim)
        dt = cfg.compute_dtype()
        self._kv = (torch.zeros(shape, dtype=dt, device=self.device),
                    torch.zeros(shape, dtype=dt, device=self.device))
        self.pool = PagePool(self.pool_pages)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: int | None = None, *,
               temperature: float = 0.0) -> ServeRequest:
        """Queue one greedy generation request (thread-safe). Prompts
        longer than the cache capacity are rejected up front; sampling
        (``temperature > 0``) is refused."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0.0:
            raise _unsupported("sampled decode (temperature > 0)")
        n_new = max_new_tokens if max_new_tokens is not None \
            else self.max_new_tokens
        if len(prompt) + n_new > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({n_new}) "
                f"exceeds max_seq_len {self.max_seq_len}")
        req = ServeRequest(prompt=prompt, max_new_tokens=n_new)
        with self._qlock:
            self._queue.append(req)
        obs.count("serve.requests")
        self._work_evt.set()
        return req

    def _pop_queued(self) -> ServeRequest | None:
        with self._qlock:
            return self._queue.popleft() if self._queue else None

    def _requeue_front(self, req: ServeRequest) -> None:
        req.tokens.clear()
        req.status = "queued"
        with self._qlock:
            self._queue.appendleft(req)

    @property
    def queue_depth(self) -> int:
        with self._qlock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def idle(self) -> bool:
        return not self._active and self.queue_depth == 0

    @property
    def tokens_per_sec(self) -> float:
        return self._tok_rate_ema or 0.0

    # -- admission control --------------------------------------------------
    def admission_state(self) -> tuple[str, float]:
        """``("ok", 0)`` admits; ``("drain", s)`` while a drain-policy
        swap finishes in-flight sequences (503); ``("shed", s)`` when the
        queue sits at ``max_queue`` (429). ``s`` is a Retry-After
        estimate in seconds."""
        if self.swap_policy == "drain" and self._pending_swap is not None \
                and self._active:
            return "drain", self._retry_after()
        if self.max_queue and self.queue_depth >= self.max_queue:
            return "shed", self._retry_after()
        return "ok", 0.0

    def _retry_after(self) -> float:
        depth = max(self.queue_depth, 1)
        tps = self.tokens_per_sec
        est = depth * self.max_new_tokens / tps if tps > 0 else 1.0
        return min(max(est, 1.0), 30.0)

    def wait_for_work(self, timeout: float) -> bool:
        """Block until a request arrives (ServeLoop's idle parking)."""
        got = self._work_evt.wait(timeout)
        if got:
            self._work_evt.clear()
        return got

    # -- paging -------------------------------------------------------------
    def _release(self, slot: _Slot) -> None:
        for p in slot.pages:
            self.pool.decref(p)
        slot.pages = []

    def _finish(self, slot: _Slot, status: str) -> None:
        self._admit_hold = False
        self._release(slot)
        slot.req.status = status
        slot.req.revision = self.revision
        slot.req.done_evt.set()
        self._active.remove(slot)
        if status == "truncated":
            obs.count("serve.truncated")

    def _preempt_one(self, protect: _Slot | None = None) -> bool:
        """Free the youngest active slot's pages and requeue its request
        (greedy decode regenerates identically)."""
        victims = [s for s in self._active if s is not protect]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.order)
        self._release(victim)
        self._active.remove(victim)
        self._requeue_front(victim.req)
        self._admit_hold = True
        obs.count("serve.preempted")
        logger.info("preempted request %d (page pool exhausted)",
                    victim.req.rid)
        return True

    # -- hot swap -----------------------------------------------------------
    def _maybe_swap(self) -> None:
        if self.watcher is not None:
            staged = self.watcher.take_pending()
            if staged is not None:
                self._pending_swap = staged   # latest staged revision wins
        if self._pending_swap is None:
            return
        if self.swap_policy == "restart" and self._active:
            for slot in list(self._active):
                self._release(slot)
                self._active.remove(slot)
                self._requeue_front(slot.req)
                obs.count("serve.swap_restarts")
        if self._active:
            return   # drain: finish in-flight on their revision first
        rev, params = self._pending_swap
        t0 = time.perf_counter()
        self.install_params(params, revision=rev)
        self._pending_swap = None
        obs.observe("serve.swap_stall_ms",
                    (time.perf_counter() - t0) * 1e3)
        obs.count("serve.swaps")
        logger.info("hot-swapped base to revision %s", rev)

    # -- scheduling ---------------------------------------------------------
    def _admit(self) -> None:
        while (self._pending_swap is None or self.swap_policy == "restart") \
                and not (self._admit_hold and self._active) \
                and len(self._active) < self.max_slots:
            req = self._pop_queued()
            if req is None:
                return
            if not self._admit_one(req):
                return

    def _admit_one(self, req: ServeRequest) -> bool:
        """Allocate the prompt's pages and prefill; on pool exhaustion
        the request goes back to the queue front."""
        pages = self.pool.alloc(len(req.prompt) // self.page_size + 1)
        if pages is None:
            self._requeue_front(req)
            return False
        obs.observe("serve.queue_age_ms",
                    max(0.0, (time.time() - req.submitted_t) * 1e3))
        self._prefill(req, pages)
        return True

    @torch.no_grad()
    def _prefill(self, req: ServeRequest, pages: list) -> None:
        """Full-prompt forward at the prompt's page bucket, padding
        masked; its (k, v) land in the slot's pages (padded rows beyond
        the allocated pages land on trash page 0)."""
        P = self.page_size
        plen = len(req.prompt)
        mp = self._page_ladder.bucket_for((plen + P - 1) // P)
        t_bucket = mp * P
        dev = self.device
        toks = np.zeros((1, t_bucket), np.int64)
        toks[0, :plen] = req.prompt
        page_row = np.zeros((mp,), np.int64)
        row = pages[:mp]
        page_row[:len(row)] = row
        amask = (np.arange(t_bucket)[None, :] < plen).astype(np.int32)
        t0 = time.perf_counter()
        logits, kvs = self.model(
            torch.from_numpy(toks).to(dev),
            attention_mask=torch.from_numpy(amask).to(dev), sow_kv=True)
        k_pages, v_pages = self._kv
        idx = torch.from_numpy(page_row).to(dev)
        for layer, (k, v) in enumerate(kvs):
            # [1, T, H, D] -> [mp, P, H, D], in place into this layer's pool
            k_pages[layer].index_copy_(0, idx, k[0].reshape(mp, P,
                                                            *k.shape[2:]))
            v_pages[layer].index_copy_(0, idx, v[0].reshape(mp, P,
                                                            *v.shape[2:]))
        nxt = int(torch.argmax(logits[0, plen - 1, :self.cfg.vocab_size]))
        dur_ms = (time.perf_counter() - t0) * 1e3
        obs.observe("serve.prefill_ms", dur_ms)
        obs.count("serve.prefills")
        req.status = "active"
        slot = _Slot(req=req, pages=pages, seq_len=plen, last_tok=nxt,
                     order=next(self._order))
        self._active.append(slot)
        self._emit(slot, nxt)

    def _emit(self, slot: _Slot, tok: int) -> None:
        slot.req.tokens.append(tok)
        self.tokens_emitted += 1
        obs.count("serve.tokens")
        # TTFT = submit (wall clock) -> first token, queue wait included;
        # TPOT = the wall gap between this slot's consecutive tokens
        now = time.perf_counter()
        if len(slot.req.tokens) == 1:
            obs.observe("serve.ttft_ms",
                        max(0.0, (time.time() - slot.req.submitted_t) * 1e3))
        elif slot.last_emit_t:
            obs.observe("serve.tpot_ms", (now - slot.last_emit_t) * 1e3)
        slot.last_emit_t = now
        if (self.eos_id is not None and tok == self.eos_id) or \
                len(slot.req.tokens) >= slot.req.max_new_tokens:
            self._finish(slot, "done")
        elif slot.seq_len >= self.max_seq_len:
            # submit()'s length check makes this unreachable; a hard stop
            self._finish(slot, "truncated")

    def _grow(self) -> None:
        """Ensure every active slot owns the page this step's write
        lands in; under pool pressure preempt the youngest, and as the
        last resort cut a sequence short."""
        P = self.page_size
        for slot in list(self._active):
            while slot in self._active:
                need = slot.seq_len // P + 1
                if len(slot.pages) >= need:
                    break
                got = self.pool.alloc(1)
                if got is not None:
                    slot.pages.extend(got)
                elif not self._preempt_one(protect=slot):
                    self._finish(slot, "truncated")

    @torch.no_grad()
    def _decode_plain(self) -> int:
        """One greedy decode step over the active batch: the forward
        attends the pool through the page tables, THEN the step's fresh
        (k, v) are written into the pool in place (index_put_ on the
        pool tensor, where the JAX package's ``.at[].set`` relies on
        buffer donation). The order matters: the attention folds the
        fresh column in itself, so writing first would count it twice."""
        active = self._active
        if not active:
            return 0
        P = self.page_size
        need_pages = max(s.seq_len // P + 1 for s in active)
        sb = self._slot_ladder.bucket_for(len(active))
        pb = self._page_ladder.bucket_for(need_pages)
        tables = np.zeros((sb, pb), np.int32)
        seq_lens = np.zeros((sb,), np.int32)
        tokens = np.zeros((sb, 1), np.int64)
        for i, slot in enumerate(active):
            row = slot.pages[:pb]
            tables[i, :len(row)] = row
            seq_lens[i] = slot.seq_len
            tokens[i, 0] = slot.last_tok
        dev = self.device
        tables_t = torch.from_numpy(tables).to(dev)
        lens_t = torch.from_numpy(seq_lens).to(dev)
        k_pages, v_pages = self._kv
        kv_pages = [(k_pages[i], v_pages[i]) for i in range(len(self._layers))]
        logits, kvs = self.model(torch.from_numpy(tokens).to(dev),
                                 position_ids=lens_t[:, None].long(),
                                 kv_pages=kv_pages, page_tables=tables_t,
                                 kv_lens=lens_t, sow_kv=True)
        self.decode_dispatches += 1
        lens_l = lens_t.long()
        page_idx = tables_t.long().gather(1, (lens_l // P)[:, None])[:, 0]
        off = lens_l % P
        new_k = torch.stack([k[:, 0] for k, _ in kvs])   # [L, B, H, D]
        new_v = torch.stack([v[:, 0] for _, v in kvs])
        k_pages[:, page_idx, off] = new_k
        v_pages[:, page_idx, off] = new_v
        nxt = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                           dim=-1).tolist()
        emitted = 0
        for i, slot in enumerate(list(active)):
            slot.seq_len += 1
            slot.last_tok = nxt[i]
            self._emit(slot, nxt[i])
            emitted += 1
        return emitted

    def step(self) -> dict:
        """One scheduler iteration: swap check, admission, growth, one
        decode step over the active batch. Returns step stats."""
        if self.model is None:
            raise RuntimeError("no base installed; call install_params "
                               "(or attach a watcher that stages one)")
        t0 = time.perf_counter()
        self._maybe_swap()
        self._admit()
        self._grow()
        emitted = self._decode_plain()
        dur = time.perf_counter() - t0
        self.steps += 1
        obs.observe("serve.step_ms", dur * 1e3)
        if emitted:
            obs.observe("serve.token_ms", dur * 1e3)
            rate = emitted / max(dur, 1e-9)
            self._tok_rate_ema = rate if self._tok_rate_ema is None else (
                self._tok_rate_ema + 0.2 * (rate - self._tok_rate_ema))
            obs.gauge("serve.tokens_per_sec", self._tok_rate_ema)
        obs.gauge("serve.queue_depth", self.queue_depth)
        obs.gauge("serve.active_slots", len(self._active))
        obs.gauge("serve.free_pages", self.pool.free)
        if self.debug_invariants:
            self._check_invariants()
        return {"emitted": emitted, "active": len(self._active),
                "queued": self.queue_depth, "step_ms": dur * 1e3,
                "revision": self.revision}

    def _check_invariants(self) -> None:
        """Every referenced page is held by exactly one active slot."""
        expected: dict[int, int] = {}
        for slot in self._active:
            for p in slot.pages:
                expected[p] = expected.get(p, 0) + 1
        self.pool.check(expected)

    # -- conveniences -------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int | None = None,
                 *, max_steps: int = 100_000) -> list[list[int]]:
        """Submit a batch and drive the scheduler to completion."""
        reqs = [self.submit(p, max_new_tokens) for p in prompts]
        for _ in range(max_steps):
            if all(r.done_evt.is_set() for r in reqs):
                break
            self.step()
        else:
            raise RuntimeError("generation did not converge in "
                               f"{max_steps} steps")
        return [list(r.tokens) for r in reqs]

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.close()
        for slot in list(self._active):
            self._finish(slot, "truncated")
        with self._qlock:
            drained = list(self._queue)
            self._queue.clear()
        for req in drained:
            req.status = "truncated"
            req.done_evt.set()


# ---------------------------------------------------------------------------
# Serve loop + HTTP frontend
# ---------------------------------------------------------------------------

class ServeLoop:
    """Drives ``engine.step()`` on a daemon thread (named ``serve-loop``)
    so HTTP handler threads only touch the thread-safe ``submit`` path.
    Parks on the engine's work event when idle. A failed step is logged
    and the loop carries on: callers check request outcomes."""

    def __init__(self, engine: GenerationEngine, *,
                 idle_poll_s: float = 0.2):
        self.engine = engine
        self.idle_poll_s = idle_poll_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ServeLoop":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="serve-loop", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self.engine.idle:
                    self.engine.wait_for_work(self.idle_poll_s)
                    continue
                self.engine.step()
            except Exception:
                logger.exception("serve loop step failed")
                self._stop.wait(0.5)

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)


class ServeHTTPFrontend:
    """Stdlib JSON frontend (127.0.0.1 by default, daemon threads).

    - ``POST /generate`` ``{"tokens": [...]}`` plus optional
      ``max_new_tokens`` — blocks until the request finishes (or
      ``timeout_s``) and returns the generated tokens, status and the
      base revision served. A request the slice does not carry (e.g.
      ``temperature > 0``) is a 400 naming what is missing.
    - ``GET /healthz`` — queue depth, active slots, revision, tokens/sec.
    """

    def __init__(self, engine: GenerationEngine, port: int = 0, *,
                 host: str = "127.0.0.1", timeout_s: float = 120.0):
        self.engine = engine
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        if self._server is not None:
            return self.port
        fe = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("serve_http: " + fmt, *args)

            def _send(self, code: int, obj,
                      headers: dict | None = None) -> None:
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?", 1)[0] != "/healthz":
                    self._send(404, {"error": "not found"})
                    return
                e = fe.engine
                reg = obs.registry()
                out = {"ok": True, "queue_depth": e.queue_depth,
                       "active": e.active_count, "revision": e.revision,
                       "tokens_per_sec": e.tokens_per_sec,
                       "max_queue": e.max_queue, "shed": e.shed_count,
                       "phase": "unified"}
                for key, metric in (("ttft_ms_p95", "serve.ttft_ms"),
                                    ("tpot_ms_p95", "serve.tpot_ms"),
                                    ("q_age_ms_p95", "serve.queue_age_ms")):
                    h = reg.peek(metric)
                    if h is not None and h.count:
                        out[key] = h.percentiles((95.0,))["p95"]
                self._send(200, out)

            def do_POST(self):  # noqa: N802
                if self.path.split("?", 1)[0] != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                state, retry = fe.engine.admission_state()
                if state != "ok":
                    if state == "shed":
                        fe.engine.shed_count += 1
                        obs.count("serve.shed")
                        code, msg = 429, "overloaded"
                    else:
                        obs.count("serve.drain_rejects")
                        code, msg = 503, "draining for base swap"
                    self._send(code, {"error": msg, "retry_after_s": retry},
                               {"Retry-After": str(max(1, int(retry)))})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    toks = payload.get("tokens")
                    if not isinstance(toks, list) or not toks:
                        raise ValueError("need a non-empty 'tokens' list")
                    req = fe.engine.submit(
                        toks, payload.get("max_new_tokens"),
                        temperature=float(payload.get("temperature", 0.0)))
                except (ValueError, TypeError, NotImplementedError,
                        json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                if not req.wait(fe.timeout_s):
                    self._send(504, {"error": "generation timed out",
                                     "rid": req.rid})
                    return
                self._send(200, {"rid": req.rid, "tokens": req.tokens,
                                 "status": req.status,
                                 "revision": req.revision})

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"serve-http-{self.port}",
                                        daemon=True)
        self._thread.start()
        _LIVE_FRONTENDS.add(self)
        logger.info("serving generation on http://%s:%d/generate",
                    self.host, self.port)
        return self.port

    @property
    def running(self) -> bool:
        return self._server is not None

    def close(self) -> None:
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        _LIVE_FRONTENDS.discard(self)
