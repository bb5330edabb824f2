"""Serving plane: continuous-batching generation over a paged KV cache —
the port of the JAX package's ``engine/serve.py`` (its unified engine).

- **Paged KV cache.** One page pool per process, ``[layers, pages,
  page_size, kv_heads, head_dim]``, with per-slot page tables; page 0 is
  the trash page that padded lanes and padded table entries point at. A
  sequence owns exactly the pages its length needs. Attention reads each
  slot's pages through its table (ops/paged_attention.py: on the card
  the decode kernel for one query a slot and the window kernel for more,
  their plain versions on the CPU); full prefills run the flash forward
  (ops/flash_attention.py). Page exhaustion evicts unshared prefix-cache
  pages first, then preempts the youngest sequence back to the queue.
- **Continuous batching.** Every step admits queued requests into free
  slots, decodes one token (or verifies a drafted window) for every
  active slot, and finishes sequences at once.
- **Bucketed shapes.** Prompts pad to a power-of-two page ladder and
  decode batches to (slot, page) buckets, the JAX package's ladders. The
  JAX engine also pads a batch up to an already-compiled bigger bucket;
  the eager port has nothing compiled to reuse and takes the exact fit.
- **Sampled decode.** Per-request ``temperature`` / ``top_p`` / ``seed``;
  token *t* of a request is drawn with the key ``fold_in(PRNGKey(seed),
  t)`` (utils/prng.py, the JAX package's threefry bits), so a stream
  depends only on (seed, position), never on the batch. Temperature 0
  is greedy argmax.
- **Prefix cache.** Prompt pages are indexed by chain digest
  (:class:`PrefixCache`); a later prompt maps the cached pages, prefills
  only its suffix through the window kernel, and copies a shared page
  before any write lands in it (copy-on-write). A page frees at refcount
  0; eviction is LRU over pages only the cache holds.
- **Speculative decoding** (``draft=``, engine/speculative.py): a drafter
  proposes up to ``draft_k`` tokens a slot, one verify forward scores
  every slot's ``draft_k + 1`` window, and each slot commits the longest
  prefix of proposals equal to the target's own picks, plus the target's
  pick at the first difference. The picks are the plain path's tokens,
  so the output equals the spec-off stream.
- **Hot swap.** Between steps the engine takes a staged ``(revision,
  state)`` from its watcher (:class:`BaseRevisionWatcher` over a
  transport, or any object with ``take_pending()`` and ``close()``) and
  rebinds its weights to it without a copy. Policy "drain": in-flight
  sequences finish on the revision they started on, admission pauses
  until they do; "restart": in-flight prompts requeue on the new
  revision. A swap flushes the prefix cache.
- **Request traces** (``trace=True``, the default; utils/reqtrace.py):
  per-request stage timelines, tail exemplars frozen into the flight
  recorder, and the SLO burn-rate feed (engine/health.py).
- **Disaggregated workers** (``phase=``, engine/kv_transfer.py): a
  "prefill" worker runs each request's prefill, exports its KV pages
  (``kv_exporter``) and finishes it as ``prefilled`` with the manifest
  ref and its first token; a "decode" worker admits a request that
  carries ``kv_ref`` on adopted pages (``kv_adopter``) and emits the
  prefill worker's first token verbatim. Any transfer defect, a geometry
  skew or another base revision falls back to the local prefill,
  counted in ``kv_reprefills`` (and ``kv_rev_mismatch``).

Metrics go to utils/obs.py as ``serve.*``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import re
import threading
import time
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..models import bind, params_from_numpy, resolve_device
from ..utils import devprof, flight, obs, prng, reqtrace
from .kv_transfer import dtype_name

logger = logging.getLogger(__name__)

State = Mapping[str, torch.Tensor]

DEFAULT_PAGE_SIZE = 16

_LIVE_FRONTENDS: "weakref.WeakSet[ServeHTTPFrontend]" = weakref.WeakSet()


def live_frontends() -> list["ServeHTTPFrontend"]:
    """Frontends with a listening socket (test hygiene guards)."""
    return list(_LIVE_FRONTENDS)


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
    temperature: float = 0.0    # 0 = greedy
    top_p: float = 1.0          # nucleus mass; 1.0 = full distribution
    seed: int = 0               # the request's PRNG stream root
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    tokens: list = dataclasses.field(default_factory=list)
    status: str = "queued"      # queued | active | done | truncated
    #                             | prefilled (prefill-phase worker)
    revision: str | None = None
    # content-addressable identity (utils/reqtrace.py), from the
    # X-DT-Request-Id header or minted by submit()
    request_id: str | None = None
    # disaggregated serving: on a decode worker, the manifest ref of the
    # KV to adopt; on a prefill worker, the ref published at finish.
    # ``first_token`` rides with it: the prefill worker's first token,
    # which the decode worker emits verbatim
    kv_ref: str | None = None
    first_token: int | None = None
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
    spec_window: int = 0  # drafts allowed this step (set by _grow)
    # lazy trace accumulators: the per-token path bumps these, and
    # _trace_flush folds them into the request's timeline as one span
    tr_decode_n: int = 0
    tr_decode_t0: float = 0.0
    tr_decode_t1: float = 0.0
    tr_tpot_sum: float = 0.0
    tr_tpot_n: int = 0


# ---------------------------------------------------------------------------
# Bucket ladder, page pool, prefix cache
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
    (page 0 is the trash page and is never allocated). Every owner of a
    page (an active slot's table, a prefix-cache entry) holds one
    reference; a page is free again only at refcount 0."""

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


class PrefixCache:
    """Content-addressed prompt-prefix index over the page pool (the JAX
    package's, digests included).

    Page *i* of a prompt is keyed ``(digest(pages[:i]), tokens(page
    i))``: a page is reusable only when everything before it matched too.
    FULL pages (``page_size`` tokens) continue the chain; a PARTIAL tail
    page is terminal (a later prompt may reuse its overlapping head rows;
    the rest stay masked behind ``kv_lens`` until copy-on-write makes the
    page private). Each entry holds one pool reference; eviction (LRU)
    only frees a page whose cache reference is the last one. A match
    stops one token short of the prompt: at least one token must run
    through prefill to give the first next-token logits."""

    ROOT = b"pfx-root"

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.P = page_size
        # (parent_digest, token_tuple) -> page; dict order is the LRU
        # order (hits re-insert at the back)
        self._entries: dict[tuple, int] = {}
        self._kids: dict[bytes, list[tuple]] = {}
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.pages_shared = 0

    @staticmethod
    def _digest(parent: bytes, tokens: tuple) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(tokens, np.int64).tobytes())
        return h.digest()

    def __len__(self) -> int:
        return len(self._entries)

    def pages(self) -> list[int]:
        return list(self._entries.values())

    def _touch(self, key: tuple) -> None:
        self._entries[key] = self._entries.pop(key)

    def match(self, prompt: list) -> tuple[list[int], int]:
        """Longest reusable page run for ``prompt``: ``(pages, matched
        tokens)``, ``matched <= len(prompt) - 1``; the last page may be
        partly matched. Takes no references."""
        P = self.P
        limit = len(prompt) - 1
        pages: list[int] = []
        matched = 0
        h = self.ROOT
        while matched < limit:
            want = prompt[matched:matched + min(P, limit - matched)]
            best_key, best_overlap = None, 0
            for key in self._kids.get(h, ()):
                if key not in self._entries:
                    continue
                n = 0
                for a, b in zip(want, key[1]):
                    if a != b:
                        break
                    n += 1
                if n > best_overlap:
                    best_key, best_overlap = key, n
            if best_key is None:
                break
            pages.append(self._entries[best_key])
            self._touch(best_key)
            matched += best_overlap
            if best_overlap == P == len(best_key[1]):
                h = self._digest(h, best_key[1])
                continue
            break   # partial page use is terminal
        return pages, matched

    def register(self, prompt: list, slot_pages: list) -> None:
        """Index a freshly prefilled prompt's pages. Each NEW entry takes
        one pool reference; a key already cached is only touched (an
        identical prompt keeps finding the original entry)."""
        P = self.P
        h = self.ROOT
        for i in range(0, len(prompt), P):
            toks = tuple(prompt[i:i + P])
            key = (h, toks)
            if key in self._entries:
                self._touch(key)
            else:
                page = slot_pages[i // P]
                self._entries[key] = page
                self._kids.setdefault(h, []).append(key)
                self.pool.incref(page)
            if len(toks) < P:
                break
            h = self._digest(h, toks)

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry whose cache reference is
        the last reference; False when every entry is shared."""
        for key, page in self._entries.items():
            if self.pool.refs(page) == 1:
                del self._entries[key]
                kids = self._kids[key[0]]
                kids.remove(key)
                if not kids:
                    del self._kids[key[0]]
                self.pool.decref(page)
                obs.count("serve.prefix_evictions")
                return True
        return False

    def flush(self) -> None:
        """Drop every entry and release its reference (a base swap makes
        all cached KV stale; pages live slots still map survive on their
        own references)."""
        for page in self._entries.values():
            self.pool.decref(page)
        self._entries.clear()
        self._kids.clear()
        obs.count("serve.prefix_flushes")


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _sample_from_logits(logits: torch.Tensor, temps: torch.Tensor,
                        top_ps: torch.Tensor, seeds: torch.Tensor,
                        tok_idx: torch.Tensor) -> torch.Tensor:
    """Seeded temperature / top-p sampling over ``[B, V]`` f32 logits,
    the JAX package's ``_sample_from_logits``: lane *b*'s key is
    ``fold_in(PRNGKey(seeds[b]), tok_idx[b])``; the scaled logits are
    ranked (stable), the tokens after the ``top_ps[b]`` mass are masked
    (the top token always stays), and ``categorical`` picks a rank.
    ``temps[b] == 0`` lanes take the argmax. Returns int32 ``[B]``."""
    greedy = torch.argmax(logits, dim=-1)
    keys = prng.fold_in(prng.prng_key(seeds), tok_idx)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranked = torch.gather(scaled, -1, order)
    e = torch.exp(ranked - ranked.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    ranked = torch.where(keep, ranked, float("-inf"))
    pick = prng.categorical(keys, ranked)
    sampled = torch.gather(order, -1, pick[:, None])[:, 0]
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


def _pick(logits: torch.Tensor, temps, top_ps, seeds, tok_idx
          ) -> list[int]:
    """The next token of each row of ``logits [N, V]``: argmax for the
    rows with temperature 0, :func:`_sample_from_logits` for the rest,
    which only those rows run (numpy lane parameters; what the JAX
    program computes for every lane and discards for greedy ones)."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size:
        dev = logits.device
        sel = torch.from_numpy(rows).to(dev)
        out[sel] = _sample_from_logits(
            logits[sel], torch.from_numpy(temps[rows]).to(dev),
            torch.from_numpy(np.asarray(top_ps, np.float32)[rows]).to(dev),
            torch.from_numpy(np.asarray(seeds, np.int64)[rows]).to(dev),
            torch.from_numpy(np.asarray(tok_idx, np.int64)[rows]).to(dev))
    return out.tolist()


def _lane_seed(seed: int) -> int:
    """A request's seed as the 31-bit lane value the JAX engine passes."""
    return int(seed) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Reference oracle, templates
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


def host_param_template(model) -> dict:
    """Shape-only host tree in the model's param structure, the template
    ``Transport.fetch_base`` wants (the JAX package builds it with
    ``jax.eval_shape``; here it comes from the model's state-dict
    shapes)."""
    from .train import _wire_template
    return _wire_template(model)


def _layer_keys(state: State) -> list[str]:
    """Transformer block prefixes of a state dict, in layer order
    (``h_0..`` for GPT-2, ``layer_0..`` for Llama)."""
    found = set()
    for k in state:
        m = re.fullmatch(r"(h_|layer_)(\d+)", k.split(".")[0])
        if m:
            found.add((int(m.group(2)), m.group(0)))
    if not found:
        raise ValueError("no transformer block keys (h_*/layer_*) in the "
                         "state; is this an unrolled GPT-2/Llama base?")
    return [k for _, k in sorted(found)]


def position_cap(cfg) -> int:
    """The positions a config can encode: GPT-2's ``n_positions``, a
    Llama's ``max_seq_len``."""
    return getattr(cfg, "n_positions", None) or getattr(cfg,
                                                        "max_seq_len", 0)


def kv_heads(cfg) -> int:
    """The heads a KV pool stores: a GQA model's ``n_kv_head``, else
    ``n_head``."""
    return getattr(cfg, "n_kv_head", None) or cfg.n_head


def _kv_pages(kv: tuple[torch.Tensor, torch.Tensor]) -> list:
    """One ``(k_pages, v_pages)`` pool slice a layer, the model's
    ``kv_pages`` argument."""
    k_pages, v_pages = kv
    return [(k_pages[i], v_pages[i]) for i in range(k_pages.shape[0])]


def _scatter_kv(kv, kvs, page_idx: torch.Tensor, off: torch.Tensor
                ) -> None:
    """Write a forward's fresh ``(k, v)`` (one ``[B, W, H, D]`` pair a
    layer) into the pool at ``page_idx [B, W]``, ``off [B, W]``, in
    place (the JAX package's ``.at[:, page_idx, off].set``). Duplicate
    targets fall only on trash page 0."""
    k_pages, v_pages = kv
    k_pages[:, page_idx, off] = torch.stack([k for k, _ in kvs])
    v_pages[:, page_idx, off] = torch.stack([v for _, v in kvs])


@torch.no_grad()
def _full_prefill(net, kv, tokens: Sequence[int], pages: list, P: int,
                  ladder: BucketLadder) -> torch.Tensor:
    """Full-prompt forward at the prompt's page bucket through the flash
    forward (the prompt is segment 1 and the padding segment 0: for the
    prompt's rows, the padding mask), its (k, v) written into ``pages``
    of the pool ``kv`` (padded rows past the pages on trash page 0).
    Returns the logits ``[1, T, V]``."""
    n = len(tokens)
    mp = ladder.bucket_for((n + P - 1) // P)
    t_bucket = mp * P
    dev = kv[0].device
    toks = np.zeros((1, t_bucket), np.int64)
    toks[0, :n] = tokens
    page_row = np.zeros((mp,), np.int64)
    row = pages[:mp]
    page_row[:len(row)] = row
    segs = (np.arange(t_bucket)[None, :] < n).astype(np.int32)
    logits, kvs = net(torch.from_numpy(toks).to(dev),
                      segment_ids=torch.from_numpy(segs).to(dev),
                      sow_kv=True)
    k_pages, v_pages = kv
    idx = torch.from_numpy(page_row).to(dev)
    for layer, (k, v) in enumerate(kvs):
        # [1, T, H, D] -> [mp, P, H, D], in place into this layer's pool
        k_pages[layer].index_copy_(0, idx, k[0].reshape(mp, P, *k.shape[2:]))
        v_pages[layer].index_copy_(0, idx, v[0].reshape(mp, P, *v.shape[2:]))
    return logits


# ---------------------------------------------------------------------------
# Base-revision watcher (the transport subscription)
# ---------------------------------------------------------------------------

class BaseRevisionWatcher:
    """Polls ``transport.base_revision()`` on a daemon thread (named
    ``serve-watch``); on change, fetches the base (through ``fetcher``, an
    ``engine/basedist.BaseFetcher``, when one is given) and stages it on
    ``device`` off the decode thread, so the engine's swap is a rebind.
    Any failure (revision probe, torn fetch, decode error) counts
    ``serve.swap_fetch_failures`` and leaves the current base serving."""

    def __init__(self, transport, template_fn: Callable[[], Mapping], *,
                 poll_s: float = 10.0, start_revision: str | None = None,
                 fetcher=None, device="cuda"):
        self._transport = transport
        self._template_fn = template_fn
        self.fetcher = fetcher
        self.poll_s = poll_s
        self.device = resolve_device(device)
        self._last_seen = start_revision
        self._pending: tuple[str | None, State] | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "BaseRevisionWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="serve-watch", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:   # a watcher crash must never kill serving
                logger.exception("base watcher poll failed")

    def poll_once(self) -> bool:
        """One synchronous probe-and-stage attempt; True when a new
        revision was staged."""
        try:
            rev = self._transport.base_revision()
        except Exception:
            obs.count("serve.swap_fetch_failures")
            return False
        if rev is None or rev == self._last_seen:
            return False
        try:
            if self.fetcher is not None:
                got = self.fetcher.fetch(self._template_fn(), revision=rev)
            else:
                got = self._transport.fetch_base(self._template_fn())
        except Exception:
            obs.count("serve.swap_fetch_failures")
            flight.record("swap", outcome="fetch_failed",
                          revision=rev or "")
            logger.warning("base fetch for revision %s failed; serving "
                           "stays on the current base", rev, exc_info=True)
            return False
        if got is None:
            obs.count("serve.swap_fetch_failures")
            flight.record("swap", outcome="torn_fetch", revision=rev or "")
            return False
        base, fetched_rev = got
        placed = params_from_numpy(base, device=self.device)
        if self.device.type == "cuda":
            # stage fully off the decode thread
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self._pending = (fetched_rev, placed)
            self._last_seen = fetched_rev
        obs.count("serve.swaps_staged")
        logger.info("staged base revision %s for hot swap", fetched_rev)
        return True

    def take_pending(self) -> tuple[str | None, State] | None:
        with self._lock:
            p, self._pending = self._pending, None
            return p

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class GenerationEngine:
    """Continuous-batching decoder over a paged KV cache.

    ``model`` is a GPT2 or a Llama (its config is what counts: the
    engine builds its own copy and binds ``params``, a state dict, to
    it); ``device`` is where the pool lives and the forward runs,
    ``"cuda"`` unless the caller asks for the CPU. Thread contract: ``submit`` is thread-safe;
    ``step`` is driven from ONE thread (``ServeLoop`` or the caller)."""

    def __init__(self, model, params: State | None = None, *,
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
                 draft_k: int = 4,
                 trace: bool = True,
                 trace_exemplars: int = 4,
                 trace_window_s: float = 30.0,
                 burn=None,
                 phase: str = "unified",
                 kv_exporter=None,
                 kv_adopter=None):
        if phase not in ("unified", "prefill", "decode"):
            raise ValueError(f"phase must be unified|prefill|decode, "
                             f"got {phase!r}")
        if phase == "prefill" and kv_exporter is None:
            raise ValueError("phase='prefill' needs a kv_exporter "
                             "(engine/kv_transfer.KVExporter): a prefill "
                             "worker that cannot export KV serves nothing")
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
        self.model = None
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.swap_policy = swap_policy
        self.watcher = watcher
        cap = position_cap(cfg)
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
        # one ladder serves decode context pages and every prefill length
        self._page_ladder = BucketLadder(self.pages_per_slot)

        if draft is not None:
            if draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {draft_k}")
            if hasattr(draft, "model"):
                from . import speculative as _spec
                reason = _spec.compat_reason(draft.model, cfg)
                if reason:
                    raise ValueError(f"incompatible draft model: {reason}")
        self._draft = draft
        self.draft_k = int(draft_k)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        # steps that decoded plain with a drafter attached (draft not
        # ready, or its propose raised): serve.spec_fallbacks, counted
        # also when obs is off
        self.spec_fallbacks = 0

        self.revision: str | None = None
        self._layers: list[str] | None = None
        self._kv: tuple[torch.Tensor, torch.Tensor] | None = None
        self.pool: PagePool | None = None
        self._prefix_cache = prefix_cache
        self._cache: PrefixCache | None = None
        self.max_queue = max_queue
        self.debug_invariants = debug_invariants
        self.shed_count = 0
        self.cow_copies = 0
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
        # forwards by kind (the launch counts' denominators): one-query
        # decodes, verify windows, full prefills, suffix prefills
        self.decode_dispatches = 0
        self.verify_dispatches = 0
        self.full_prefills = 0
        self.suffix_prefills = 0
        self.tokens_emitted = 0
        # disaggregated serving: the worker class and the transfer plane
        self.phase = phase
        self._kv_exporter = kv_exporter
        self._kv_adopter = kv_adopter
        self.kv_exported = 0      # requests whose KV export published
        self.kv_adopted = 0       # requests admitted on adopted pages
        self.kv_reprefills = 0    # adoption degrades -> local prefill
        self.kv_rev_mismatch = 0  # transfers refused on revision skew
        self.trace = reqtrace.TraceBook(
            exemplar_k=trace_exemplars, window_s=trace_window_s,
            burn=burn) if trace else None
        if draft is not None and self.trace is not None:
            # the drafter's cold catch-up prefills ("spec_draft") land on
            # the same per-request timelines
            draft.trace = self.trace
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
                 kv_heads(cfg), cfg.head_dim)
        dt = cfg.compute_dtype()
        self._kv = (torch.zeros(shape, dtype=dt, device=self.device),
                    torch.zeros(shape, dtype=dt, device=self.device))
        self.pool = PagePool(self.pool_pages)
        if self._prefix_cache:
            self._cache = PrefixCache(self.pool, self.page_size)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: int | None = None, *,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0,
               request_id: str | None = None,
               kv_ref: str | None = None,
               first_token: int | None = None) -> ServeRequest:
        """Queue one generation request (thread-safe). Prompts longer
        than the cache capacity are rejected up front. ``temperature=0``
        is greedy; ``temperature > 0`` samples the scaled distribution
        cut to ``top_p`` mass under the request's seeded stream. On a
        decode worker ``kv_ref`` names a prefill worker's exported KV and
        ``first_token`` its first token."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        n_new = max_new_tokens if max_new_tokens is not None \
            else self.max_new_tokens
        if len(prompt) + n_new > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({n_new}) "
                f"exceeds max_seq_len {self.max_seq_len}")
        if kv_ref is not None and first_token is None:
            raise ValueError("kv_ref without first_token: the prefill "
                             "worker's first token must ride along")
        req = ServeRequest(prompt=prompt, max_new_tokens=n_new,
                           temperature=float(temperature),
                           top_p=float(top_p), seed=int(seed),
                           kv_ref=kv_ref,
                           first_token=(None if first_token is None
                                        else int(first_token)))
        if self.trace is not None:
            req.request_id = request_id or reqtrace.mint_request_id(
                prompt, max_new_tokens=n_new, temperature=req.temperature,
                top_p=req.top_p, seed=req.seed)
        else:
            req.request_id = request_id
        with self._qlock:
            self._queue.append(req)
            depth = len(self._queue)
        if self.trace is not None:
            self.trace.start(req, depth=depth)
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

    @property
    def prefills_done(self) -> int:
        """Full and suffix prefills run (the open-loop harness's prefill
        cost model reads it)."""
        return self.full_prefills + self.suffix_prefills

    @property
    def prefix_hits(self) -> int:
        return self._cache.hits if self._cache is not None else 0

    @property
    def prefix_misses(self) -> int:
        return self._cache.misses if self._cache is not None else 0

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else 0.0

    @property
    def prefix_tokens_saved(self) -> int:
        return self._cache.tokens_saved if self._cache is not None else 0

    @property
    def speculative(self) -> bool:
        return self._draft is not None

    @property
    def spec_accept_rate(self) -> float:
        """Cumulative fraction of drafted tokens the verify pass
        accepted (tokens per verify ~ 1 + rate * K)."""
        return (self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)

    @property
    def spec_rounds(self) -> int:
        return self._spec_rounds

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
    def _alloc_pages(self, n: int) -> list | None:
        """``n`` fresh pages (refcount 1 each); when the pool runs dry,
        evict unshared prefix-cache entries LRU-first."""
        pages = self.pool.alloc(n)
        while pages is None:
            if self._cache is None or not self._cache.evict_one():
                return None
            pages = self.pool.alloc(n)
        return pages

    def _release(self, slot: _Slot) -> None:
        # decref, not free: pages the prefix cache (or a sibling slot)
        # still holds survive this slot's exit
        for p in slot.pages:
            self.pool.decref(p)
        slot.pages = []
        if self._draft is not None:
            # draft state of a stream that is no longer committed must
            # never propose against a different future
            self._draft.drop(slot.req.rid)

    def _trace_flush(self, slot: _Slot) -> None:
        """Fold the slot's lazy decode/tpot accumulators into its trace
        (one span a contiguous decode run)."""
        if slot.tr_decode_n:
            self.trace.stage_span(slot.req.rid, "decode",
                                  slot.tr_decode_t0, slot.tr_decode_t1,
                                  slot.tr_decode_n,
                                  tokens=slot.tr_decode_n)
            slot.tr_decode_n = 0
        if slot.tr_tpot_n:
            self.trace.note_latency(slot.req.rid,
                                    tpot_sum_ms=slot.tr_tpot_sum,
                                    tpot_n=slot.tr_tpot_n)
            slot.tr_tpot_sum = 0.0
            slot.tr_tpot_n = 0

    def _finish(self, slot: _Slot, status: str) -> None:
        self._admit_hold = False
        self._release(slot)
        slot.req.status = status
        slot.req.revision = self.revision
        if self.trace is not None:
            # terminal stage, burn feed and reservoir entry before
            # done_evt, so a waiter observes a closed trace
            self._trace_flush(slot)
            self.trace.finish(slot.req, status)
        slot.req.done_evt.set()
        self._active.remove(slot)
        if status == "truncated":
            obs.count("serve.truncated")

    def _preempt_one(self, protect: _Slot | None = None) -> bool:
        """Free the youngest active slot's pages and requeue its request
        (decoding regenerates identically: the sampler is a function of
        seed and position)."""
        victims = [s for s in self._active if s is not protect]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.order)
        self._release(victim)
        self._active.remove(victim)
        self._requeue_front(victim.req)
        self._admit_hold = True
        if self.trace is not None:
            self._trace_flush(victim)
            self.trace.stage(victim.req.rid, "preempt",
                             seq_len=victim.seq_len)
        obs.count("serve.preempted")
        logger.info("preempted request %d (page pool exhausted)",
                    victim.req.rid)
        return True

    def _copy_page(self, src: int, dst: int) -> None:
        """Whole-page KV copy, every layer (the copy-on-write primitive;
        rows past the valid length copy too and stay masked): the device
        observatory's ``serve.page_copy``."""
        def copy():
            k_pages, v_pages = self._kv
            k_pages[:, dst] = k_pages[:, src]
            v_pages[:, dst] = v_pages[:, src]
        devprof.call("serve.page_copy", copy, bucket=1)

    def _cow_page(self, slot: _Slot, idx: int) -> bool:
        """Give ``slot`` a private copy of its ``idx``-th page before a
        write would reach sequences sharing it; False when the pool
        cannot supply the copy."""
        got = self._alloc_pages(1)
        if got is None:
            return False
        src = slot.pages[idx]
        self._copy_page(src, got[0])
        self.pool.decref(src)
        slot.pages[idx] = got[0]
        self.cow_copies += 1
        if self.trace is not None:
            self._trace_flush(slot)
            self.trace.stage(slot.req.rid, "cow", pages=1)
        obs.count("serve.cow_copies")
        return True

    # -- hot swap -----------------------------------------------------------
    def _maybe_swap_draft(self) -> None:
        """The drafter's own hot-swap lane: a staged draft revision
        installs between steps (flushing all draft KV); no drain is
        needed, proposals never cross a step."""
        draft = self._draft
        watcher = getattr(draft, "watcher", None) \
            if draft is not None else None
        if watcher is None:
            return
        staged = watcher.take_pending()
        if staged is None:
            return
        rev, placed = staged
        draft.install_params(placed, revision=rev)
        obs.count("serve.spec_draft_swaps")
        flight.record("swap", outcome="draft_swapped", revision=rev or "")
        logger.info("hot-swapped draft to revision %s", rev)

    def _maybe_swap(self) -> None:
        self._maybe_swap_draft()
        if self.watcher is not None:
            staged = self.watcher.take_pending()
            if staged is not None:
                self._pending_swap = staged   # latest staged revision wins
        if self._pending_swap is None:
            return
        if self.swap_policy == "restart" and self._active:
            for slot in list(self._active):
                if self._draft is not None:
                    obs.count("serve.spec_invalidations")
                self._release(slot)
                self._active.remove(slot)
                self._requeue_front(slot.req)
                if self.trace is not None:
                    self._trace_flush(slot)
                    self.trace.stage(slot.req.rid, "swap_invalidate",
                                     seq_len=slot.seq_len)
                obs.count("serve.swap_restarts")
        if self._active:
            return   # drain: finish in-flight on their revision first
        rev, params = self._pending_swap
        t0 = time.perf_counter()
        self.install_params(params, revision=rev)
        self._pending_swap = None
        if self._cache is not None:
            # cached KV was computed under the old weights
            self._cache.flush()
        obs.observe("serve.swap_stall_ms",
                    (time.perf_counter() - t0) * 1e3)
        obs.count("serve.swaps")
        flight.record("swap", outcome="swapped", revision=rev or "",
                      policy=self.swap_policy)
        logger.info("hot-swapped base to revision %s", rev)

    # -- admission and prefill ----------------------------------------------
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
        """Consult the prefix cache (increfs the shared pages), allocate
        the rest, then run the full or the suffix prefill. On pool
        exhaustion the request goes back to the queue front with its
        increfs rolled back."""
        P = self.page_size
        plen = len(req.prompt)
        queue_age_ms = max(0.0, (time.time() - req.submitted_t) * 1e3)
        if req.kv_ref is not None and self._kv_adopter is not None:
            verdict = self._try_adopt(req, queue_age_ms)
            if verdict != "degrade":
                return verdict == "ok"
            # any defect falls through to the local prefill below:
            # counted, and the output is the same
        shared: list[int] = []
        matched = 0
        if self._cache is not None:
            shared, matched = self._cache.match(list(req.prompt))
            if matched:
                for p in shared:
                    self.pool.incref(p)
                self._cache.hits += 1
                self._cache.tokens_saved += matched
                self._cache.pages_shared += len(shared)
                obs.count("serve.prefix_hits")
                obs.count("serve.prefix_tokens_saved", matched)
                obs.count("serve.prefix_pages_shared", len(shared))
            else:
                self._cache.misses += 1
                obs.count("serve.prefix_misses")
        fresh = self._alloc_pages(plen // P + 1 - len(shared))
        if fresh is None:
            for p in shared:
                self.pool.decref(p)
            self._requeue_front(req)
            return False
        pages = shared + fresh
        if matched and matched % P:
            # the suffix's first write lands inside the last matched
            # page: it must be private before the prefill writes into it
            idx = matched // P
            stub = _Slot(req=req, pages=pages, seq_len=0, last_tok=0,
                         order=-1)
            if self.pool.refs(pages[idx]) > 1 and \
                    not self._cow_page(stub, idx):
                for p in pages:
                    self.pool.decref(p)
                self._requeue_front(req)
                return False
            pages = stub.pages
        obs.observe("serve.queue_age_ms", queue_age_ms)
        if self.trace is not None:
            # a request admitted before (then preempted or requeued by a
            # swap) re-enters as "readmit"
            stage = "readmit" if self.trace.seen(req.rid, "admit") \
                else "admit"
            self.trace.stage(req.rid, stage, queue_age_ms=queue_age_ms)
        if matched:
            self._prefill_shared(req, pages, matched)
        else:
            self._prefill(req, pages)
        return True

    def _reprefill(self) -> str:
        self.kv_reprefills += 1
        obs.count("serve.kv_reprefills")
        return "degrade"

    def _try_adopt(self, req: ServeRequest, queue_age_ms: float) -> str:
        """Admit a request on ADOPTED KV pages (the decode worker's half
        of the hop). Returns "ok" (the slot is active), "full" (the pool
        is dry: requeued, stop admitting) or "degrade" (absent or torn
        manifest, hash miss, geometry skew or another base revision: the
        caller prefills locally; each is counted)."""
        t0 = time.perf_counter()
        got = self._kv_adopter.fetch(req.kv_ref)
        if got is None:
            obs.count("serve.kv_adopt_failures")
            return self._reprefill()
        if got["revision"] != (self.revision or ""):
            # KV is a function of (params, tokens): pages prefilled on
            # another base revision are wrong here, not nearly right
            self.kv_rev_mismatch += 1
            obs.count("serve.kv_rev_mismatch")
            logger.warning(
                "kv adoption refused: pages prefilled on revision %r, "
                "serving %r (request %s); prefilling locally",
                got["revision"], self.revision, req.request_id)
            return self._reprefill()
        P = self.page_size
        plen = len(req.prompt)
        k_pages, v_pages = self._kv
        want = {"layers": k_pages.shape[0], "page_size": P,
                "kv_heads": k_pages.shape[3], "head_dim": k_pages.shape[4],
                "dtype": dtype_name(k_pages)}
        n = (plen + P - 1) // P
        if got["geometry"] != want or got["prompt_len"] != plen \
                or len(got["pages"]) != n:
            obs.count("serve.kv_adopt_failures")
            return self._reprefill()
        pages = self._alloc_pages(plen // P + 1)
        if pages is None:
            self._requeue_front(req)
            return "full"
        # the adoption write: every content page in one copy a pool (the
        # device observatory's serve.kv_adopt)
        def adopt():
            idx = torch.tensor(pages[:n], device=self.device)
            for pool, j in ((k_pages, 0), (v_pages, 1)):
                host = torch.stack([pair[j] for pair in got["pages"]],
                                   dim=1)
                pool.index_copy_(1, idx, host.to(self.device))
        devprof.call("serve.kv_adopt", adopt, bucket=1)
        dur_ms = (time.perf_counter() - t0) * 1e3
        obs.observe("serve.queue_age_ms", queue_age_ms)
        obs.observe("serve.kv_adopt_ms", dur_ms)
        obs.count("serve.kv_adoptions")
        obs.count("serve.kv_pages_adopted", n)
        self.kv_adopted += 1
        if self.trace is not None:
            stage = "readmit" if self.trace.seen(req.rid, "admit") \
                else "admit"
            self.trace.stage(req.rid, stage, queue_age_ms=queue_age_ms)
            self.trace.stage(req.rid, "kv_adopt", pages=n,
                             dur_ms=round(dur_ms, 3))
        if self._cache is not None:
            # the cache takes its own reference on each page, so a
            # sibling sharing the prefix reuses them and this slot's first
            # write into a shared page takes the copy-on-write path
            self._cache.register(list(req.prompt), pages)
        self._activate(req, pages, int(got["first_token"]))
        return "ok"

    def _finish_prefill(self, req: ServeRequest, pages: list,
                        nxt: int) -> None:
        """A prefill worker's terminal: export the prompt's KV pages (one
        device-to-host copy a pool; manifest last, engine/kv_transfer
        ``KVExporter``), drop the slot's page references and finish the
        request as ``prefilled`` with the manifest ref and the first
        token. With the prefix cache the pages stay resident, so the next
        request with the same prefix exports no fresh page bytes."""
        P = self.page_size
        plen = len(req.prompt)
        n = (plen + P - 1) // P
        t0 = time.perf_counter()
        k_pages, v_pages = self._kv
        idx = torch.tensor(pages[:n], device=self.device)
        k_host = k_pages.index_select(1, idx).cpu()
        v_host = v_pages.index_select(1, idx).cpu()
        kv_ref = req.request_id or f"rq-rid{req.rid}"
        ok = self._kv_exporter.export(
            request_id=kv_ref, revision=self.revision or "",
            pages=[(k_host[:, i], v_host[:, i]) for i in range(n)],
            prompt_len=plen, first_token=int(nxt), page_size=P)
        dur_ms = (time.perf_counter() - t0) * 1e3
        if ok:
            self.kv_exported += 1
            req.kv_ref = kv_ref
        req.first_token = int(nxt)
        req.tokens.append(int(nxt))
        self.tokens_emitted += 1
        obs.count("serve.tokens")
        ttft_ms = max(0.0, (time.time() - req.submitted_t) * 1e3)
        obs.observe("serve.ttft_ms", ttft_ms)
        for p in pages:
            self.pool.decref(p)
        req.status = "prefilled"
        req.revision = self.revision
        if self.trace is not None:
            self.trace.stage(req.rid, "kv_export", pages=n, ok=int(ok),
                             dur_ms=round(dur_ms, 3))
            self.trace.note_latency(req.rid, ttft_ms=ttft_ms)
            self.trace.finish(req, "prefilled")
        req.done_evt.set()
        self._admit_hold = False

    def _prefill(self, req: ServeRequest, pages: list) -> None:
        """Full-prompt forward (:func:`_full_prefill`) into the slot's
        pages."""
        plen = len(req.prompt)
        P = self.page_size
        t0 = time.perf_counter()
        logits = devprof.call(
            "serve.prefill", _full_prefill, self.model, self._kv,
            req.prompt, pages, P, self._page_ladder,
            bucket=self._page_ladder.bucket_for((plen + P - 1) // P) * P)
        self.full_prefills += 1
        nxt = self._first_token(req, logits[0, plen - 1,
                                            :self.cfg.vocab_size])
        dur_ms = (time.perf_counter() - t0) * 1e3
        obs.observe("serve.prefill_ms", dur_ms)
        obs.count("serve.prefills")
        if self.trace is not None:
            self.trace.stage(req.rid, "prefill", pfx_hit=0, pfx_tokens=0,
                             prompt_tokens=plen, dur_ms=round(dur_ms, 3))
        if self._cache is not None:
            self._cache.register(list(req.prompt), pages)
        self._activate(req, pages, nxt)

    @torch.no_grad()
    def _prefill_shared(self, req: ServeRequest, pages: list,
                        ctx_len: int) -> None:
        """Suffix prefill: ``ctx_len`` prompt tokens already live in
        shared cache pages; only the tail runs the model, as one window
        over the paged context (the window kernel on the card), and its
        (k, v) are written at arbitrary offsets of the slot's pages
        (padded rows on trash page 0)."""
        P = self.page_size
        plen = len(req.prompt)
        suffix = plen - ctx_len
        t_bucket = self._page_ladder.bucket_for((suffix + P - 1) // P) * P
        pb = self._page_ladder.bucket_for(plen // P + 1)
        dev = self.device
        toks = np.zeros((1, t_bucket), np.int64)
        toks[0, :suffix] = req.prompt[ctx_len:]
        table = np.zeros((1, pb), np.int32)
        table[0, :len(pages)] = pages
        pos = ctx_len + np.arange(t_bucket)
        page_idx = np.where(np.arange(t_bucket) < suffix,
                            table[0, np.minimum(pos // P, pb - 1)], 0)
        t0 = time.perf_counter()

        def prefill_ctx():
            table_t = torch.from_numpy(table).to(dev)
            logits, kvs = self.model(
                torch.from_numpy(toks).to(dev),
                position_ids=torch.from_numpy(
                    np.minimum(pos, self.max_seq_len - 1)[None, :]).to(dev),
                kv_pages=_kv_pages(self._kv), page_tables=table_t,
                kv_lens=torch.tensor([ctx_len], dtype=torch.int32,
                                     device=dev),
                sow_kv=True)
            _scatter_kv(self._kv, kvs,
                        torch.from_numpy(page_idx[None, :]).to(dev),
                        torch.from_numpy((pos % P)[None, :]).to(dev))
            return logits

        logits = devprof.call("serve.prefill_ctx", prefill_ctx,
                              bucket=f"{t_bucket}x{pb}")
        self.suffix_prefills += 1
        nxt = self._first_token(
            req, logits[0, suffix - 1, :self.cfg.vocab_size])
        dur_ms = (time.perf_counter() - t0) * 1e3
        obs.observe("serve.prefill_ms", dur_ms)
        obs.count("serve.prefills")
        if self.trace is not None:
            self.trace.stage(req.rid, "prefill", pfx_hit=1,
                             pfx_tokens=ctx_len, prompt_tokens=plen,
                             dur_ms=round(dur_ms, 3))
        self._activate(req, pages, nxt)

    def _first_token(self, req: ServeRequest, row: torch.Tensor) -> int:
        """Token 0 of a request from its prefill's last logits row: the
        argmax, or the seeded draw at stream index 0 (the device
        observatory's ``serve.sample_tok``; a greedy pick belongs to the
        prefill's program, as in JAX)."""
        args = (row[None, :], [req.temperature], [req.top_p],
                [_lane_seed(req.seed)], [0])
        if req.temperature > 0.0:
            return devprof.call("serve.sample_tok", _pick, *args,
                                bucket=1)[0]
        return _pick(*args)[0]

    def _activate(self, req: ServeRequest, pages: list, nxt: int) -> None:
        if self.phase == "prefill":
            # a prefill worker never decodes: the request ends here, its
            # KV exported and its first token attached
            self._finish_prefill(req, pages, nxt)
            return
        req.status = "active"
        slot = _Slot(req=req, pages=pages, seq_len=len(req.prompt),
                     last_tok=nxt, order=next(self._order))
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
            ttft_ms = max(0.0, (time.time() - slot.req.submitted_t) * 1e3)
            obs.observe("serve.ttft_ms", ttft_ms)
            if self.trace is not None:
                self.trace.note_latency(slot.req.rid, ttft_ms=ttft_ms)
        elif slot.last_emit_t:
            tpot_ms = (now - slot.last_emit_t) * 1e3
            obs.observe("serve.tpot_ms", tpot_ms)
            if self.trace is not None:
                slot.tr_tpot_sum += tpot_ms
                slot.tr_tpot_n += 1
        slot.last_emit_t = now
        if (self.eos_id is not None and tok == self.eos_id) or \
                len(slot.req.tokens) >= slot.req.max_new_tokens:
            self._finish(slot, "done")
        elif slot.seq_len >= self.max_seq_len:
            # submit()'s length check makes this unreachable; a hard stop
            self._finish(slot, "truncated")

    # -- growth -------------------------------------------------------------
    def _spec_horizon(self, slot: _Slot) -> int:
        """Tokens this slot may draft this step: at most ``draft_k``, the
        tokens it still owes less one, and what the cache can hold."""
        if self._draft is None or not getattr(self._draft, "ready", False):
            return 0
        rem = slot.req.max_new_tokens - len(slot.req.tokens) - 1
        cap = self.max_seq_len - 1 - slot.seq_len
        return max(0, min(self.draft_k, rem, cap))

    def _grow_for_window(self, slot: _Slot, window: int) -> bool:
        """Pages, exclusively owned, for the rows this step writes:
        positions ``seq_len .. seq_len + window`` (window 0 is the plain
        decode write). Every shared page among them is copied first.
        False on pool exhaustion (the caller decides how hard to push)."""
        P = self.page_size
        need = (slot.seq_len + window) // P + 1
        while len(slot.pages) < need:
            got = self._alloc_pages(1)
            if got is None:
                return False
            slot.pages.extend(got)
        for wp in range(slot.seq_len // P, need):
            while self.pool.refs(slot.pages[wp]) > 1:
                if not self._cow_page(slot, wp):
                    return False
        return True

    def _grow(self) -> None:
        """Ensure every active slot owns the pages this step's writes
        land in. A drafting slot asks for its whole window first and
        shrinks it to 0 under pool pressure before anyone is preempted;
        preempting the youngest is the last resort, then cutting a
        sequence short."""
        for slot in list(self._active):
            if slot not in self._active:
                continue   # preempted by an earlier slot's growth
            slot.spec_window = self._spec_horizon(slot)
            while slot in self._active:
                if self._grow_for_window(slot, slot.spec_window):
                    break
                if slot.spec_window:
                    slot.spec_window = 0
                    continue
                if not self._preempt_one(protect=slot):
                    self._finish(slot, "truncated")
                    break

    # -- decode -------------------------------------------------------------
    def _decode(self) -> int:
        if not self._active:
            return 0
        if self._draft is not None:
            if getattr(self._draft, "ready", False):
                return self._decode_spec()
            # no draft weights yet: plain decode, never wrong output
            self.spec_fallbacks += 1
            obs.count("serve.spec_fallbacks")
        return self._decode_plain()

    def _lanes(self, active: list[_Slot], sb: int):
        """Per-lane sampling parameters ``(temps, top_ps, seeds,
        tok_idx)`` of a batch padded to ``sb`` lanes (padding greedy)."""
        temps = np.zeros((sb,), np.float32)
        top_ps = np.ones((sb,), np.float32)
        seeds = np.zeros((sb,), np.int64)
        tok_idx = np.zeros((sb,), np.int64)
        for i, slot in enumerate(active):
            temps[i] = slot.req.temperature
            top_ps[i] = slot.req.top_p
            seeds[i] = _lane_seed(slot.req.seed)
            tok_idx[i] = len(slot.req.tokens)
        return temps, top_ps, seeds, tok_idx

    @torch.no_grad()
    def _decode_plain(self) -> int:
        """One decode step over the active batch: the forward attends the
        pool through the page tables, THEN the step's fresh (k, v) are
        written into the pool in place. The order matters: the attention
        folds the fresh column in itself, so writing first would count it
        twice."""
        active = self._active
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
        lanes = self._lanes(active, sb)

        def step():
            tables_t = torch.from_numpy(tables).to(dev)
            lens_t = torch.from_numpy(seq_lens).to(dev)
            logits, kvs = self.model(torch.from_numpy(tokens).to(dev),
                                     position_ids=lens_t[:, None].long(),
                                     kv_pages=_kv_pages(self._kv),
                                     page_tables=tables_t, kv_lens=lens_t,
                                     sow_kv=True)
            lens_l = lens_t.long()
            page_idx = tables_t.long().gather(1, (lens_l // P)[:, None])
            _scatter_kv(self._kv, kvs, page_idx, (lens_l % P)[:, None])
            return _pick(logits[:, -1, :self.cfg.vocab_size], *lanes)

        # a batch with any sampled lane runs the sampled twin, as in JAX
        sampled = any(s.req.temperature > 0.0 for s in active)
        nxt = devprof.call(
            "serve.decode_sample" if sampled else "serve.decode", step,
            bucket=f"{sb}x{pb}")
        self.decode_dispatches += 1
        emitted = 0
        trace_t = self.trace.clock() if self.trace is not None else 0.0
        for i, slot in enumerate(list(active)):
            slot.seq_len += 1
            slot.last_tok = nxt[i]
            if self.trace is not None:
                # lazy per-slot accumulation against one clock read
                if slot.tr_decode_n == 0:
                    slot.tr_decode_t0 = trace_t
                slot.tr_decode_n += 1
                slot.tr_decode_t1 = trace_t
            self._emit(slot, nxt[i])
            emitted += 1
        return emitted

    @torch.no_grad()
    def _verify(self, active: list[_Slot], plan: dict) -> np.ndarray:
        """The verify forward: ``W = draft_k + 1`` positions a slot in
        one batched window. Position 0 consumes ``last_tok`` (what plain
        decode would), positions ``1..k`` that slot's proposals; lanes at
        or past ``n_input`` write to trash page 0. Returns the picks
        ``[sb, W]``: at window position w, the token the plain path would
        emit at stream index ``len(tokens) + w``."""
        W = self.draft_k + 1
        P = self.page_size
        need_pages = max((s.seq_len + len(plan[s.req.rid])) // P + 1
                         for s in active)
        sb = self._slot_ladder.bucket_for(len(active))
        pb = self._page_ladder.bucket_for(need_pages)
        tables = np.zeros((sb, pb), np.int32)
        seq_lens = np.zeros((sb,), np.int32)
        tokens = np.zeros((sb, W), np.int64)
        n_input = np.zeros((sb,), np.int64)
        for i, slot in enumerate(active):
            props = plan[slot.req.rid]
            row = slot.pages[:pb]
            tables[i, :len(row)] = row
            seq_lens[i] = slot.seq_len
            tokens[i, 0] = slot.last_tok
            tokens[i, 1:1 + len(props)] = props
            n_input[i] = 1 + len(props)
        pos = seq_lens[:, None].astype(np.int64) + np.arange(W)[None, :]
        page_idx = np.where(
            np.arange(W)[None, :] < n_input[:, None],
            np.take_along_axis(tables, np.minimum(pos // P, pb - 1), 1), 0)
        dev = self.device
        temps, top_ps, seeds, tok_idx0 = self._lanes(active, sb)

        def verify():
            logits, kvs = self.model(
                torch.from_numpy(tokens).to(dev),
                position_ids=torch.from_numpy(
                    np.minimum(pos, self.max_seq_len - 1)).to(dev),
                kv_pages=_kv_pages(self._kv),
                page_tables=torch.from_numpy(tables).to(dev),
                kv_lens=torch.from_numpy(seq_lens).to(dev), sow_kv=True)
            _scatter_kv(self._kv, kvs, torch.from_numpy(page_idx).to(dev),
                        torch.from_numpy(pos % P).to(dev))
            return _pick(
                logits[:, :, :self.cfg.vocab_size].reshape(sb * W, -1),
                np.repeat(temps, W), np.repeat(top_ps, W),
                np.repeat(seeds, W),
                (tok_idx0[:, None] + np.arange(W)[None, :]).reshape(-1))

        picks = devprof.call("serve.verify", verify, bucket=f"{sb}x{pb}")
        self.verify_dispatches += 1
        return np.asarray(picks).reshape(sb, W)

    def _decode_spec(self) -> int:
        """One speculative round: the drafter proposes up to
        ``spec_window`` tokens a slot, one verify forward scores every
        slot's window, and each slot commits the longest prefix of its
        proposals that equals the target's picks plus the target's pick
        at the first difference (a round that accepts nothing is one
        plain decode step). Commit is length bookkeeping: the verify rows
        past it hold rejected inputs, masked by ``kv_lens`` and
        overwritten when those positions are fed again."""
        active = self._active
        draft = self._draft
        t0 = time.perf_counter()
        proposals: dict[int, list] = {}
        if any(s.spec_window > 0 for s in active):
            try:
                proposals = draft.propose(active) or {}
            except Exception:
                # a broken drafter must never break serving: this round
                # verifies an empty window (= plain decode)
                logger.exception("draft propose failed; "
                                 "plain-decoding this step")
                self.spec_fallbacks += 1
                obs.count("serve.spec_fallbacks")
                proposals = {}
        obs.observe("serve.spec_draft_ms",
                    (time.perf_counter() - t0) * 1e3)
        plan = {s.req.rid: [int(t) for t in
                            proposals.get(s.req.rid, [])][:s.spec_window]
                for s in active}
        t1 = time.perf_counter()
        picks = self._verify(active, plan)
        obs.observe("serve.spec_verify_ms",
                    (time.perf_counter() - t1) * 1e3)
        emitted = 0
        for i, slot in enumerate(list(active)):
            props = plan[slot.req.rid]
            j = 0
            while j < len(props) and props[j] == int(picks[i, j]):
                j += 1
            if props:
                self._spec_proposed += len(props)
                self._spec_accepted += j
                obs.count("serve.spec_proposed_tokens", len(props))
                obs.count("serve.spec_accepted_tokens", j)
            if self.trace is not None:
                self._trace_flush(slot)
                self.trace.stage(slot.req.rid, "spec",
                                 proposed=len(props), accepted=j,
                                 tokens=j + 1)
            for tok in props[:j] + [int(picks[i, j])]:
                slot.seq_len += 1
                slot.last_tok = tok
                self._emit(slot, tok)
                emitted += 1
                if slot.req.status != "active":
                    break   # eos/budget hit inside the accepted run
            if slot.req.status == "active":
                draft.commit(slot.req.rid,
                             list(slot.req.prompt) + list(slot.req.tokens))
        self._spec_rounds += 1
        if self._spec_proposed:
            obs.gauge("serve.spec_accept_rate", self.spec_accept_rate)
        return emitted

    def step(self) -> dict:
        """One scheduler iteration: swap check, admission, growth, one
        decode (or verify) step over the active batch. Returns step
        stats."""
        if self.model is None:
            raise RuntimeError("no base installed; call install_params "
                               "(or attach a watcher that stages one)")
        t0 = time.perf_counter()
        self._maybe_swap()
        self._admit()
        self._grow()
        emitted = self._decode()
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
        """Every referenced page is explained by its holders (active
        slots and prefix-cache entries), and free + referenced tile the
        pool; the drafter's pool likewise."""
        expected: dict[int, int] = {}
        for slot in self._active:
            for p in slot.pages:
                expected[p] = expected.get(p, 0) + 1
        if self._cache is not None:
            for p in self._cache.pages():
                expected[p] = expected.get(p, 0) + 1
        self.pool.check(expected)
        if self._draft is not None:
            self._draft.check()

    # -- conveniences -------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int | None = None,
                 *, max_steps: int = 100_000, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int = 0) -> list[list[int]]:
        """Submit a batch and drive the scheduler to completion."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_p=top_p, seed=seed) for p in prompts]
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
        if self._draft is not None:
            self._draft.close()
        for slot in list(self._active):
            self._finish(slot, "truncated")
        with self._qlock:
            drained = list(self._queue)
            self._queue.clear()
        for req in drained:
            req.status = "truncated"
            req.done_evt.set()
        if self.trace is not None:
            # a run shorter than one window still freezes its exemplars
            self.trace.seal_window()


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


def heartbeat_counters(engine: "GenerationEngine", burn=None) -> dict:
    """The serving worker's heartbeat extras (the JAX server's): tokens
    a second, queue depth, tokens and sheds; the prefix cache's hit rate
    once it has seen traffic, the drafter's acceptance once it has
    verified tokens, the ttft / tpot / queue-age p95 once observed, the
    worst fast-window burn, and on a disaggregated worker its ``phase``
    with the KV manifests exported and adopted. Host counters only."""
    out = {"tokens_per_sec": engine.tokens_per_sec,
           "queue_depth": float(engine.queue_depth),
           "tokens": float(engine.tokens_emitted),
           "shed": float(engine.shed_count)}
    if engine.prefix_hits + engine.prefix_misses > 0:
        out["prefix_hit_rate"] = engine.prefix_hit_rate
    if engine.speculative and engine.spec_rounds > 0:
        out["spec_accept_rate"] = engine.spec_accept_rate
    reg = obs.registry()
    for metric, field in (("serve.ttft_ms", "ttft_ms_p95"),
                          ("serve.tpot_ms", "tpot_ms_p95"),
                          ("serve.queue_age_ms", "q_age_ms_p95")):
        h = reg.peek(metric)   # peek: never create an empty series
        if h is not None and h.count:
            out[field] = h.percentiles((95.0,))["p95"]
    if burn is not None:
        out["slo_burn"] = burn.max_burn()
    if engine.phase != "unified":
        out["phase"] = engine.phase
        out["kv_exported"] = float(engine.kv_exported)
        out["kv_adopted"] = float(engine.kv_adopted)
    return out


class ServeHTTPFrontend:
    """Stdlib JSON frontend (127.0.0.1 by default, daemon threads).

    - ``POST /generate`` ``{"tokens": [...]} | {"text": "..."}`` plus
      optional ``max_new_tokens``, ``temperature``, ``top_p`` and
      ``seed``: blocks until the request finishes (or ``timeout_s``) and
      returns the generated tokens (and text, with a tokenizer), status,
      base revision and ``request_id`` (also in the ``X-DT-Request-Id``
      header, which a caller may set). A refusal at admission control is
      traced: 429 when the queue is full, 503 while a drain swap runs.
      On a decode worker the body may carry ``kv_ref`` and
      ``first_token`` (the router's second leg).
    - ``POST /prefill`` (prefill workers only): the same body; runs the
      prefill leg, exports the KV pages and returns ``kv_ref``,
      ``first_token`` and ``prompt_len`` besides the ``/generate`` keys.
      A prefill worker answers ``/generate`` with 409, any other worker
      ``/prefill``.
    - ``GET /healthz``: queue depth, active slots, revision, tokens/sec,
      the worker's ``phase`` and its ``kv_exported`` / ``kv_adopted``
      counts, prefix hit rate, speculative accept rate, latency p95s,
      SLO burn.
    """

    def __init__(self, engine: GenerationEngine, port: int = 0, *,
                 host: str = "127.0.0.1", tokenizer=None,
                 timeout_s: float = 120.0):
        self.engine = engine
        self.host = host
        self.port = port
        self.tokenizer = tokenizer
        self.timeout_s = timeout_s
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def healthz(self) -> dict:
        """The ``/healthz`` body (the JAX package's: the router reads
        these keys)."""
        e = self.engine
        reg = obs.registry()
        out = {"ok": True, "queue_depth": e.queue_depth,
               "active": e.active_count, "revision": e.revision,
               "tokens_per_sec": e.tokens_per_sec,
               "max_queue": e.max_queue, "shed": e.shed_count,
               # the worker class the router routes by
               "phase": e.phase, "kv_exported": e.kv_exported,
               "kv_adopted": e.kv_adopted}
        if e.prefix_hits + e.prefix_misses > 0:
            out["prefix_hit_rate"] = e.prefix_hit_rate
        if e.speculative:
            out["spec_accept_rate"] = e.spec_accept_rate
            out["spec_k"] = e.draft_k
        for key, metric in (("ttft_ms_p95", "serve.ttft_ms"),
                            ("tpot_ms_p95", "serve.tpot_ms"),
                            ("q_age_ms_p95", "serve.queue_age_ms")):
            h = reg.peek(metric)
            if h is not None and h.count:
                out[key] = h.percentiles((95.0,))["p95"]
        burn = e.trace.burn if e.trace is not None else None
        if burn is not None:
            out["slo_burn"] = burn.max_burn()
        return out

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
                self._send(200, fe.healthz())

            def do_POST(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path not in ("/generate", "/prefill"):
                    self._send(404, {"error": "not found"})
                    return
                eng = fe.engine
                # phase discipline: a mis-routed call fails loudly
                # instead of returning a one-token "generation"
                if path == "/prefill" and eng.phase != "prefill":
                    self._send(409, {"error": "not a prefill-phase "
                                              "worker"})
                    return
                if path == "/generate" and eng.phase == "prefill":
                    self._send(409, {"error": "prefill-phase worker; "
                                              "POST /prefill"})
                    return
                # admission control before parsing; a refusal still
                # gets a traced request_id
                req_id = self.headers.get(reqtrace.REQUEST_ID_HEADER)
                state, retry = eng.admission_state()
                if state != "ok":
                    if state == "shed":
                        eng.shed_count += 1
                        obs.count("serve.shed")
                        code, msg = 429, "overloaded"
                    else:
                        obs.count("serve.drain_rejects")
                        code, msg = 503, "draining for base swap"
                    if eng.trace is not None:
                        req_id = eng.trace.reject(
                            req_id, state, retry_after_s=round(retry, 3))
                    self._send(code, {"error": msg, "retry_after_s": retry,
                                      "request_id": req_id},
                               {"Retry-After": str(max(1, int(retry))),
                                reqtrace.REQUEST_ID_HEADER: req_id or ""})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    toks = payload.get("tokens")
                    if toks is None and "text" in payload:
                        if fe.tokenizer is None:
                            raise ValueError("text prompts need a "
                                             "tokenizer; send token ids")
                        toks = fe.tokenizer.encode(payload["text"])
                    if not isinstance(toks, list) or not toks:
                        raise ValueError("need a non-empty 'tokens' list "
                                         "or 'text'")
                    # the router's decode leg carries the prefill leg's
                    # manifest ref and first token
                    kv_ref = payload.get("kv_ref")
                    ft = payload.get("first_token")
                    req = eng.submit(
                        toks, payload.get("max_new_tokens"),
                        temperature=float(payload.get("temperature", 0.0)),
                        top_p=float(payload.get("top_p", 1.0)),
                        seed=int(payload.get("seed", 0)),
                        request_id=req_id,
                        kv_ref=(str(kv_ref) if kv_ref else None),
                        first_token=(int(ft) if ft is not None else None))
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                hdr = {reqtrace.REQUEST_ID_HEADER: req.request_id or ""}
                if not req.wait(fe.timeout_s):
                    self._send(504, {"error": "generation timed out",
                                     "rid": req.rid,
                                     "request_id": req.request_id}, hdr)
                    return
                out = {"rid": req.rid, "tokens": req.tokens,
                       "status": req.status, "revision": req.revision,
                       "request_id": req.request_id}
                if path == "/prefill":
                    # the decode leg's inputs (kv_ref None: the export
                    # failed, and the router falls back to unified)
                    out["kv_ref"] = req.kv_ref
                    out["first_token"] = req.first_token
                    out["prompt_len"] = len(req.prompt)
                if fe.tokenizer is not None:
                    try:
                        out["text"] = fe.tokenizer.decode(req.tokens)
                    except Exception:
                        pass
                self._send(200, out, hdr)

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
