"""Concurrent revision-aware delta ingest — the port of the JAX package's
``engine/ingest.py`` (its single-host path): the fetch, decode and screen
front-end of the averager.

- **concurrent**: a bounded pool of daemon worker threads
  (:class:`IngestPool`) stages every miner at once, so transport latency
  overlaps across miners; each job runs under the submitting thread's
  correlation id.
- **revision-aware**: a host cache (:class:`DeltaCache`, keyed
  ``(hotkey, delta_revision)`` with an LRU byte budget) skips the
  download, decode and screen for an unchanged submission; a warm round
  costs one revision probe per miner and no artifact bytes.
- **wire v2**: a miner whose artifact is a shard MANIFEST stages through
  the manifest-first path: parse, serve every shard whose sha256 the
  cache holds, fetch and hash-verify only the changed ones, screen the
  reassembled PACKED tree, and densify only after the verdict — or never,
  with ``densify=False`` (the averager's scatter-add merge). A torn shard
  set (a hash mismatch mid-publish) is a transient miss, never decoded.
- **v1 decodes** of the port's own: dense f32/bf16, int8 and sparse8.

Everything here runs on wire-layout host trees (what the transports
serve). Not ported, and refused: the pod path (``stage(multi=True)``)
and LoRA templates (ROADMAP "Slices of the port", slice 7).

Registry metrics: ``ingest.cache_hits`` / ``ingest.cache_misses`` /
``ingest.cache_evictions`` / ``ingest.fetch_errors`` /
``ingest.rider_refreshes`` counters and the ``ingest.cache_bytes``
histogram; ``wire.bytes_fetched`` / ``wire.shards_deduped`` /
``wire.torn_fetches`` counters, the ``wire.decode_ms`` histogram and
``delta.densify_fallbacks`` on the v2 path.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import delta as delta_lib
from ..transport.retry import DEFAULT_FETCH_RETRY, call_with_retry
from ..utils import obs

logger = logging.getLogger(__name__)

Params = Any

_SLICES = "ROADMAP 'Slices of the port'"

# internal pre-screen marker; public reasons:
# "ok" | "no_delta" | "stale_base" | "fetch_error" | screen reasons
_UNSCREENED = "unscreened"

# probe raised: revision unknown — fetch anyway, bypass the cache
_PROBE_FAILED = object()

DEFAULT_CACHE_BYTES = 2 << 30


def tree_nbytes(tree: Params | None) -> int:
    """Host bytes of a tree's leaves (the cache's accounting unit)."""
    if tree is None:
        return 0
    total = 0
    for _, leaf in delta_lib._walk_state_dict(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


@dataclasses.dataclass
class StagedDelta:
    """One miner's staged submission for this round."""
    hotkey: str
    delta: Params | None        # wire-layout host tree (dense or packed)
    reason: str                 # "ok" or why the delta is withheld
    revision: str | None        # artifact revision probed this round
    cid: str | None             # correlation id from the meta rider
    cached: bool = False        # served from the host cache
    meta_base_revision: str | None = None
    wire_bytes: int = 0         # transport bytes fetched for it this round


# ---------------------------------------------------------------------------
# The worker pool
# ---------------------------------------------------------------------------

class IngestPool:
    """Bounded pool of daemon worker threads named ``ingest-worker-*``,
    spawned lazily and gone after ``idle_timeout`` seconds without work.
    ``map`` preserves input order, runs each job under the submitting
    thread's correlation id and re-raises the first job exception;
    ``workers == 1`` or a single item runs inline."""

    def __init__(self, workers: int = 4, *, idle_timeout: float = 2.0):
        self.workers = max(1, int(workers))
        self.idle_timeout = idle_timeout
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._seq = 0

    def map(self, fn: Callable, items: Sequence) -> list:
        items = list(items)
        if not items:
            return []
        if self.workers == 1 or len(items) == 1:
            return [fn(x) for x in items]
        ctx = obs.capture_context()
        out: list = [None] * len(items)
        done = threading.Semaphore(0)
        for i, x in enumerate(items):
            self._q.put((fn, x, i, out, done, ctx))
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            while len(self._threads) < min(self.workers, len(items)):
                t = threading.Thread(target=self._run, daemon=True,
                                     name=f"ingest-worker-{self._seq}")
                self._seq += 1
                self._threads.append(t)
                t.start()
        for _ in items:
            done.acquire()
        results = []
        for ok, val in out:
            if not ok:
                raise val
            results.append(val)
        return results

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            try:
                job = self._q.get(timeout=self.idle_timeout)
            except queue.Empty:
                with self._lock:
                    # exit only when nothing is queued: a job enqueued
                    # between the timeout and this check is taken next
                    if not self._q.empty():
                        continue
                    if me in self._threads:
                        self._threads.remove(me)
                    return
            if job is None:   # close() sentinel
                with self._lock:
                    if me in self._threads:
                        self._threads.remove(me)
                return
            fn, x, i, out, done, ctx = job
            try:
                with obs.use_context(ctx):
                    out[i] = (True, fn(x))
            except BaseException as e:  # noqa: BLE001 — re-raised in map()
                out[i] = (False, e)
            finally:
                done.release()

    def close(self, timeout: float = 2.0) -> None:
        """Shutdown drain (not safe concurrently with map)."""
        with self._lock:
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(timeout)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]


# ---------------------------------------------------------------------------
# The content-addressed host cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Entry:
    revision: str
    delta: Params | None        # staged tree (None: negative entry)
    reason: str                 # verdict for this revision
    fetched: bool               # False = rider-only (stale skip)
    cid: str | None
    meta_base_revision: str | None
    nbytes: int


class DeltaCache:
    """LRU host cache of staged submissions keyed ``(hotkey,
    delta_revision)``, plus the wire-v2 shard store keyed by content hash
    (two miners shipping an identical layer dedupe to one entry). One
    entry per hotkey: a new revision replaces the old. Negative verdicts
    are cached too, so a hostile artifact is rejected once per revision.
    Shards evict before whole entries (a shard is re-fetchable per layer).
    Thread-safe."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._shards: OrderedDict[str, tuple] = OrderedDict()
        self._bytes = 0

    def _evict_locked(self) -> int:
        evicted = 0
        while self._bytes > self.max_bytes and self._shards:
            _, (_, nb) = self._shards.popitem(last=False)
            self._bytes -= nb
            evicted += 1
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, ev = self._entries.popitem(last=False)
            self._bytes -= ev.nbytes
            evicted += 1
        return evicted

    def _after_insert(self, evicted: int, total: int) -> None:
        if evicted:
            obs.count("ingest.cache_evictions", evicted)
        obs.observe("ingest.cache_bytes", total)

    # -- wire-v2 shard granularity ------------------------------------------
    def shard_lookup(self, digest: str):
        """The decoded packed entry for a shard content hash, or None."""
        if self.max_bytes <= 0 or not isinstance(digest, str):
            return None
        with self._lock:
            hit = self._shards.get(digest)
            if hit is None:
                return None
            self._shards.move_to_end(digest)
            return hit[0]

    def shard_put(self, digest: str, entry) -> None:
        if self.max_bytes <= 0 or not isinstance(digest, str):
            return
        nb = tree_nbytes(entry)
        if nb > self.max_bytes:
            return
        with self._lock:
            old = self._shards.pop(digest, None)
            if old is not None:
                self._bytes -= old[1]
            self._shards[digest] = (entry, nb)
            self._bytes += nb
            evicted, total = self._evict_locked(), self._bytes
        self._after_insert(evicted, total)

    def lookup(self, hotkey: str, revision) -> _Entry | None:
        if self.max_bytes <= 0 or not isinstance(revision, str):
            return None
        with self._lock:
            e = self._entries.get(hotkey)
            if e is None or e.revision != revision:
                return None
            self._entries.move_to_end(hotkey)
            return e

    def put(self, hotkey: str, revision, *, delta: Params | None = None,
            reason: str = "ok", fetched: bool = True, cid: str | None = None,
            meta_base_revision: str | None = None) -> None:
        if self.max_bytes <= 0 or not isinstance(revision, str):
            return
        nb = tree_nbytes(delta)
        if nb > self.max_bytes:
            return  # larger than the whole budget: caching it evicts all
        with self._lock:
            old = self._entries.pop(hotkey, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[hotkey] = _Entry(revision, delta, reason, fetched,
                                           cid, meta_base_revision, nb)
            self._bytes += nb
            evicted, total = self._evict_locked(), self._bytes
        self._after_insert(evicted, total)



# ---------------------------------------------------------------------------
# v1 decodes
# ---------------------------------------------------------------------------

def densify_delta_bytes(data: bytes, template, *, quant_template=None,
                        accept_quant: bool = True) -> Params | None:
    """Validated artifact bytes -> dense wire-layout host delta, or None:
    a dense tree (f32 or bf16), then the int8 tree (dtype-pinned,
    dequantized here), then sparse8 (densified here). ``accept_quant=False``
    rejects both quantized forms."""
    from .. import serialization as ser

    try:
        return ser.validated_load(data, template)
    except ser.PayloadError:
        pass
    if not accept_quant:
        return None
    qt = quant_template() if callable(quant_template) else quant_template
    if qt is None:
        qt = delta_lib.quantized_template(template)
    try:
        q = ser.validated_load(data, qt, check_dtypes=True)
    except ser.PayloadError:
        q = None
    if q is not None:
        return delta_lib.dequantize_delta(q)
    return delta_lib.sparse_delta_from_bytes(data, template)


# ---------------------------------------------------------------------------
# The ingestor
# ---------------------------------------------------------------------------

class DeltaIngestor:
    """Stage a round's miner submissions: probe -> cache -> fetch -> decode
    -> screen, concurrently across miners.

    ``template`` is the wire-layout host template (or a zero-argument
    supplier, resolved once); ``stale_deltas="skip"`` withholds a
    submission whose rider names a base other than the round's
    ``base_revision`` without downloading it. ``densify=False`` keeps
    screened wire-v2 submissions PACKED (``StagedDelta.delta`` is the
    packed tree) for a scatter-add merge."""

    def __init__(self, transport, template, *,
                 lora_cfg=None, lora_template=None, quant_template=None,
                 accept_quant: bool = True,
                 accept_wire_v2: bool = True,
                 max_delta_abs: float | None = None,
                 stale_deltas: str = "accept",
                 workers: int = 4,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 span_prefix: str = "ingest",
                 densify: bool = True):
        if lora_cfg is not None or lora_template is not None:
            raise NotImplementedError(
                f"DeltaIngestor(lora_cfg=...): LoRA adapter submissions are "
                f"slice 7 ({_SLICES})")
        if stale_deltas not in ("skip", "accept"):
            raise ValueError(f"stale_deltas must be 'skip' or 'accept', "
                             f"got {stale_deltas!r}")
        self.transport = transport
        self._template_in = template
        self._template_cache = None
        self.quant_template = quant_template
        self.accept_quant = accept_quant
        self.accept_wire_v2 = accept_wire_v2
        self.max_delta_abs = max_delta_abs
        self.stale_deltas = stale_deltas
        self.span_prefix = span_prefix
        self.retry = DEFAULT_FETCH_RETRY
        self.densify = densify
        self.cache = DeltaCache(cache_bytes)
        self.pool = IngestPool(workers)

    def close(self) -> None:
        self.pool.close()

    def _template(self):
        if self._template_cache is None:
            t = self._template_in
            self._template_cache = t() if callable(t) else t
        return self._template_cache

    def _span(self, phase: str) -> str:
        return f"{self.span_prefix}.{phase}"

    # -- public entry --------------------------------------------------------
    def stage(self, hotkeys: Sequence[str], *, base_revision=None,
              multi: bool = False) -> list[StagedDelta]:
        """Stage every hotkey's current submission; one
        :class:`StagedDelta` per hotkey, in input order. Per-miner
        failures are isolated (reason ``fetch_error``), never raised."""
        if multi:
            raise NotImplementedError(
                f"DeltaIngestor.stage(multi=True): the pod path is slice 7 "
                f"({_SLICES})")
        staged = self.pool.map(
            lambda h: self._stage_one(h, base_revision), list(hotkeys))
        self._screen_fresh(staged)
        return staged

    # -- single-host path ----------------------------------------------------
    def _probe(self, hotkey: str):
        try:
            return call_with_retry(
                lambda: self.transport.delta_revision(hotkey),
                policy=self.retry, describe=f"probe {hotkey}")
        except Exception:
            logger.warning("ingest: revision probe failed for %s; fetching "
                           "uncached", hotkey, exc_info=True)
            return _PROBE_FAILED

    def _rider(self, hotkey: str) -> tuple[str | None, str | None]:
        """(cid, base_revision) from the miner's meta rider, both
        validated; any failure reads as riderless."""
        fm = getattr(self.transport, "fetch_delta_meta", None)
        if fm is None:
            return None, None
        try:
            meta = fm(hotkey)
        except Exception:
            return None, None
        cid = obs.rider_delta_id(meta)
        rev = meta.get("base_revision") if isinstance(meta, dict) else None
        if not (isinstance(rev, str) and rev):
            rev = None
        return cid, rev

    @staticmethod
    def _is_stale(meta_base_revision, base_revision) -> bool:
        return (base_revision is not None and meta_base_revision is not None
                and meta_base_revision != base_revision)

    def _stage_one(self, hotkey: str, base_revision) -> StagedDelta:
        try:
            return self._stage_one_inner(hotkey, base_revision)
        except Exception:
            # one miner's transport failure must not sink the round
            logger.exception("ingest: staging %s failed", hotkey)
            obs.count("ingest.fetch_errors")
            return StagedDelta(hotkey, None, "fetch_error", None, None)

    def _stage_one_inner(self, hotkey: str, base_revision) -> StagedDelta:
        rev = self._probe(hotkey)
        if rev is None:
            return StagedDelta(hotkey, None, "no_delta", None, None)
        rev_key = None if rev is _PROBE_FAILED else rev
        entry = self.cache.lookup(hotkey, rev_key)
        if entry is not None:
            obs.count("ingest.cache_hits")
            cid, meta_rev = entry.cid, entry.meta_base_revision
            if self.stale_deltas == "skip" and self._is_stale(meta_rev,
                                                             base_revision):
                # the artifact is content-addressed but the rider is not:
                # re-read the (small) rider before withholding
                cid2, meta_rev2 = self._rider(hotkey)
                if not self._is_stale(meta_rev2, base_revision):
                    obs.count("ingest.rider_refreshes")
                    entry.meta_base_revision = meta_rev = meta_rev2
                    entry.cid = cid = cid2 if cid2 is not None else cid
                else:
                    return StagedDelta(hotkey, None, "stale_base", rev_key,
                                       cid, cached=True,
                                       meta_base_revision=meta_rev)
            if entry.fetched:
                with obs.span(self._span("fetch"), cid=cid, miner=hotkey,
                              cache="hit"):
                    pass
                return StagedDelta(hotkey, entry.delta, entry.reason,
                                   rev_key, cid, cached=True,
                                   meta_base_revision=meta_rev)
            # a rider-only entry whose verdict no longer withholds: fetch
        else:
            obs.count("ingest.cache_misses")
            cid, meta_rev = self._rider(hotkey)
            if self.stale_deltas == "skip" and self._is_stale(meta_rev,
                                                             base_revision):
                self.cache.put(hotkey, rev_key, delta=None,
                               reason="stale_base", fetched=False, cid=cid,
                               meta_base_revision=meta_rev)
                return StagedDelta(hotkey, None, "stale_base", rev_key, cid,
                                   meta_base_revision=meta_rev)
        with obs.span(self._span("fetch"), cid=cid, miner=hotkey,
                      cache="miss"):
            delta, attempted, nbytes = self._fetch_dense(hotkey)
        if delta is None:
            if attempted:
                # decoded-and-invalid is a verdict worth remembering; a
                # bytes-level miss (publish race, torn shard set) is not
                self.cache.put(hotkey, rev_key, delta=None,
                               reason="no_delta", cid=cid,
                               meta_base_revision=meta_rev)
            return StagedDelta(hotkey, None, "no_delta", rev_key, cid,
                               meta_base_revision=meta_rev,
                               wire_bytes=nbytes)
        return StagedDelta(hotkey, delta, _UNSCREENED, rev_key, cid,
                           meta_base_revision=meta_rev, wire_bytes=nbytes)

    def _fetch_dense(self, hotkey: str) -> tuple[Params | None, bool, int]:
        """(wire-layout delta | None, decode_attempted, bytes fetched): one
        fetch, every v1 form tried on the same bytes; a wire-v2 MANIFEST
        takes the shard path and returns the PACKED tree."""
        from .. import serialization as ser

        data = call_with_retry(lambda: self.transport.fetch_delta_bytes(
            hotkey), policy=self.retry, describe=f"fetch {hotkey}")
        if data is None:
            return None, False, 0
        if ser.is_wire_v2_manifest(data):
            if not self.accept_wire_v2:
                return None, True, len(data)
            return self._assemble_v2(hotkey, bytes(data))
        obs.count("wire.bytes_fetched", len(data))
        return densify_delta_bytes(
            data, self._template(), quant_template=self.quant_template,
            accept_quant=self.accept_quant), True, len(data)

    def _assemble_v2(self, hotkey: str, manifest_bytes: bytes
                     ) -> tuple[Params | None, bool, int]:
        """Manifest-first ingest of one v2 publish: parse the manifest,
        serve cached shards (zero bytes for unchanged layers), fetch and
        hash-verify the rest, reassemble the packed tree. A hash mismatch
        is a torn (mid-publish) set: a transient miss, not cached and
        never decoded."""
        from .. import serialization as ser
        from ..transport import base as tbase

        fetched = len(manifest_bytes)
        obs.count("wire.bytes_fetched", fetched)
        man = ser.parse_wire_manifest(manifest_bytes)
        if man is None or not man["layers"]:
            return None, True, fetched   # hostile/empty manifest: a verdict
        entries: dict = {}
        for key, info in man["layers"].items():
            cached = self.cache.shard_lookup(info["h"])
            if cached is not None:
                obs.count("wire.shards_deduped")
                entries[key] = cached
                continue
            data = call_with_retry(
                lambda key=key: tbase.fetch_shard(self.transport, hotkey,
                                                  key),
                policy=self.retry, describe=f"fetch shard {hotkey}/{key}")
            if data is None or ser.shard_digest(data) != info["h"]:
                obs.count("wire.torn_fetches")
                return None, False, fetched
            fetched += len(data)
            obs.count("wire.bytes_fetched", len(data))
            entry = ser.unpack_shard(data)
            if entry is None:
                return None, True, fetched   # undecodable shard: a verdict
            self.cache.shard_put(info["h"], entry)
            entries[key] = entry
        packed = delta_lib.packed_from_layer_entries(entries)
        if not delta_lib.packed_matches(packed, self._template()):
            return None, True, fetched
        return packed, True, fetched

    # -- screening -----------------------------------------------------------
    def _screen_fresh(self, staged: list[StagedDelta]) -> None:
        fresh = [s for s in staged if s.reason == _UNSCREENED]
        if not fresh:
            return
        with obs.span(self._span("screen"), k=len(fresh)):
            # packed submissions screen in packed form: a rejected one
            # never pays a densify
            verdicts = delta_lib.screen_deltas(
                [s.delta for s in fresh], self._template(),
                max_abs=self.max_delta_abs)
        for s, (ok, reason) in zip(fresh, verdicts):
            s.reason = "ok" if ok else reason
            if not ok:
                s.delta = None
            elif self.densify and delta_lib.is_packed_v2(s.delta):
                # verdict passed: densify for dense consumers. Counted, so
                # a merge path that regresses onto this round trip (a
                # full-tensor write per contribution: the cost the
                # scatter-add kernel removes) shows in the registry.
                obs.count("delta.densify_fallbacks")
                t0 = time.perf_counter()
                dense = delta_lib.densify_packed_v2(s.delta,
                                                    self._template())
                obs.observe("wire.decode_ms",
                            (time.perf_counter() - t0) * 1e3)
                if dense is None:   # cannot happen after the screen
                    s.reason, s.delta = "no_delta", None
                else:
                    s.delta = dense
            self.cache.put(s.hotkey, s.revision, delta=s.delta,
                           reason=s.reason, cid=s.cid,
                           meta_base_revision=s.meta_base_revision)
