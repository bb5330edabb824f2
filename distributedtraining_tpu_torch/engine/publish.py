"""Asynchronous miner publication pipeline — the port of the JAX package's
``engine/publish.py``: dense v1 artifacts, and the wire-v2 shard publish
(changed shards, then the manifest).

Division of labor:

- the TRAINING thread computes the delta snapshot (a fresh copy on the
  card, with its finite flag, both queued on the stream) and hands it to
  a :class:`SupersedeQueue`; the step cadence never waits on transport;
- the PUBLISHER worker does everything with host cost off-thread: the
  finite-flag read, the device-to-host copy, serialization,
  ``transport.publish_delta`` and the base-revision rider, with bounded
  jittered-backoff retries (transport/retry.py);
- a push still pending when the next interval fires is SUPERSEDED,
  never queued behind: each artifact is the whole cumulative delta, so
  only the newest matters.

Sync and async publish run the same procedure on the same tensors, so
their artifacts are byte-identical. ``flush()`` drains in-flight work so
shutdown semantics match the sequential path.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..utils import obs

logger = logging.getLogger(__name__)

Params = Any

_CLOSED = object()


class SupersedeQueue:
    """Bounded single-producer/single-consumer handoff where NEWEST wins.

    ``offer`` never blocks: when ``depth`` items are already pending, the
    OLDEST pending item is dropped (superseded). An item the consumer has
    already taken is never superseded — it completes. ``wait_drained``
    blocks until nothing is pending AND nothing is in flight (the flush
    primitive)."""

    def __init__(self, depth: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._depth = depth
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._in_flight = 0
        self._closed = False

    def offer(self, item) -> int:
        """Enqueue ``item``; returns how many pending items it superseded
        (0 or 1 at depth 1). No-op (returns 0) after close."""
        with self._cv:
            if self._closed:
                return 0
            dropped = 0
            while len(self._items) >= self._depth:
                self._items.popleft()
                dropped += 1
            self._items.append(item)
            depth = len(self._items)
            self._cv.notify_all()
        # outside the cv: observability must never extend the handoff's
        # critical section (no-ops unless a sink is configured)
        obs.observe("publish.queue_depth", depth)
        if dropped:
            obs.count("publish.superseded", dropped)
        return dropped

    def take(self, timeout: float | None = None):
        """Next item (marks it in flight — pair with ``task_done``), or
        ``_CLOSED`` once closed and empty, or None on timeout."""
        with self._cv:
            while not self._items:
                if self._closed:
                    return _CLOSED
                if not self._cv.wait(timeout=timeout):
                    return None
            self._in_flight += 1
            return self._items.popleft()

    def task_done(self) -> None:
        with self._cv:
            self._in_flight -= 1
            self._cv.notify_all()

    def wait_drained(self, timeout: float | None = None) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._items and self._in_flight == 0,
                timeout=timeout)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class PublishWorker:
    """One DAEMON thread draining a SupersedeQueue of zero-arg jobs.

    A job exception is logged and reported to ``on_error``, never
    propagated — a failed upload must not kill training, and a poisoned
    job must not wedge the queue. Daemon: a worker blocked in a hung
    upload at interpreter exit must not block shutdown (the run loop's
    flush() is the orderly path)."""

    def __init__(self, name: str = "publisher", *, depth: int = 1,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 counter_prefix: str = "publish"):
        self._q = SupersedeQueue(depth)
        self._on_error = on_error
        self._name = name
        # registry namespace of the worker occupancy counters
        self._counter_prefix = counter_prefix
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.jobs_run = 0
        self.jobs_failed = 0
        self.jobs_superseded = 0

    def submit(self, job: Callable[[], None]) -> int:
        """Queue ``job``; returns how many pending jobs it superseded.
        The worker thread starts lazily on first submit, so loops that
        never go async never own a thread."""
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                name=self._name, daemon=True)
                self._thread.start()
        dropped = self._q.offer(job)
        self.jobs_superseded += dropped
        return dropped

    def _run(self) -> None:
        while True:
            # idle = worker waiting for work (training fully overlapped);
            # busy = host cost actually hidden behind accelerator compute.
            # publish.worker_idle_ms / publish.worker_busy_ms together
            # read as the pipeline's occupancy: busy/(busy+idle) near 1.0
            # means the worker is the bottleneck and pushes will start
            # superseding each other.
            t0 = time.perf_counter()
            job = self._q.take()
            obs.count(f"{self._counter_prefix}.worker_idle_ms",
                      (time.perf_counter() - t0) * 1e3)
            if job is _CLOSED:
                return
            if job is None:
                continue
            t1 = time.perf_counter()
            try:
                job()
                self.jobs_run += 1
            except BaseException as e:  # noqa: BLE001 - worker must survive
                self.jobs_failed += 1
                logger.exception("%s: background job failed", self._name)
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:
                        pass
            finally:
                obs.count(f"{self._counter_prefix}.worker_busy_ms",
                          (time.perf_counter() - t1) * 1e3)
                self._q.task_done()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every pending AND in-flight job has completed
        (failed jobs count as completed — they were logged/counted)."""
        return self._q.wait_drained(timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Drain, then stop the worker thread. Idempotent."""
        self._q.wait_drained(timeout=timeout)
        self._q.close()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)


def host_materialize(tree: Mapping[str, Any]) -> dict:
    """A host copy of a state dict (keys are ``.``-joined tree paths) as
    the nested tree the wire carries: numpy arrays, and CPU tensors for
    bf16 leaves (numpy has no bf16 on the card machine; the serializer
    writes both)."""
    from ..delta import nest_tree

    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return v if v.dtype == torch.bfloat16 else v.numpy()
        return np.asarray(v)

    return nest_tree({path: host(v) for path, v in tree.items()})


class DeltaPublisher:
    """The miner's publication lane: one implementation of the
    screen -> transfer -> publish -> rider sequence, runnable either
    inline (``publish_now``, the --no-push-async sequential path) or on
    the background worker (``submit``). Both spellings execute the
    identical code on the identical tensors, so the published artifacts
    are byte-identical by construction.

    Counters land in the loop's :class:`MinerReport` (single logical
    writer: either the training thread in sync mode or the worker in
    async mode — never both concurrently for the same field)."""

    def __init__(self, transport, miner_id: str, *, report,
                 nan_guard: bool = True, queue_depth: int = 1,
                 sleep: Callable[[float], None] | None = None,
                 publish_retry=None, meta_retry=None,
                 wire_spec: dict | None = None):
        from ..transport.retry import (DEFAULT_META_RETRY,
                                       DEFAULT_PUBLISH_RETRY)
        self.transport = transport
        self.miner_id = miner_id
        self.report = report
        self.nan_guard = nan_guard
        self.publish_retry = publish_retry or DEFAULT_PUBLISH_RETRY
        self.meta_retry = meta_retry or DEFAULT_META_RETRY
        self._sleep = sleep
        # wire-v2 declaration for the meta rider (format/density/quant):
        # how receivers learn this miner's artifact is a shard manifest
        # before fetching it. Set by MinerLoop when wire_v2.
        self.wire_spec = wire_spec
        # layer_key -> sha256 of the last shard set the fleet can see
        # (advanced only after the manifest lands): an unchanged layer's
        # shard is never re-uploaded
        self._last_shards: dict[str, str] = {}
        self._worker = PublishWorker(name=f"publish-{miner_id}",
                                     depth=queue_depth)

    # -- the one publish procedure ------------------------------------------
    def publish_now(self, payload: Params, finite, base_revision,
                    cid: str | None = None, *,
                    extra_meta: dict | None = None) -> bool:
        """Screen + transfer + publish + rider ON the calling thread.
        ``payload`` is the snapshot's state dict (tensors on the card), or
        a wire-v2 packed tree (``delta.pack_delta_v2``), which publishes as
        shards and a manifest; ``finite`` its 0-dim flag (None skips the
        screen).
        ``cid`` is the push's correlation id: it tags the spans below and
        rides the meta rider as ``delta_id``. ``extra_meta`` merges
        additional rider keys (protocol keys win on collision)."""
        from ..transport.retry import call_with_retry

        with obs.correlate(cid):
            if self.nan_guard and finite is not None:
                with obs.span("push.screen"):
                    finite_ok = bool(finite)
                if not finite_ok:
                    logger.warning("miner %s: delta has non-finite values, "
                                   "not pushing", self.miner_id)
                    return False
            from .. import delta as delta_lib
            wire_v2 = delta_lib.is_packed_v2(payload)
            with obs.span("push.materialize"):
                host = (delta_lib.packed_layer_entries(payload) if wire_v2
                        else host_materialize(payload))
            sleep = self._sleep
            try:
                with obs.span("push.upload"):
                    if wire_v2:
                        self._publish_v2(host)
                    else:
                        call_with_retry(
                            lambda: self.transport.publish_delta(
                                self.miner_id, host),
                            policy=self.publish_retry,
                            describe=f"miner {self.miner_id} delta publish",
                            **({"sleep": sleep} if sleep is not None
                               else {}))
            except Exception:
                self.report.pushes_failed += 1
                obs.count("publish.failed")
                logger.exception("miner %s: delta push failed", self.miner_id)
                return False
            self._publish_meta(base_revision, cid,
                               wire=self.wire_spec if wire_v2 else None,
                               extra=extra_meta)
            self.report.pushes += 1
            obs.count("publish.pushes")
            logger.info("miner %s: pushed delta #%d", self.miner_id,
                        self.report.pushes)
            return True

    # -- wire v2: changed shards, then the manifest --------------------------
    def _publish_v2(self, entries: dict) -> None:
        """Shard-addressed publish of one packed tree's layer entries
        (``delta.packed_layer_entries``): serialize and hash every layer,
        upload only the shards whose hash changed since the last publish
        that landed, then the manifest. Manifest-last keeps readers safe:
        until it commits they hold the previous manifest, and an
        already-overwritten shard fails its hash check instead of decoding
        half-new. ``_last_shards`` advances only after the manifest lands,
        so a failed publish re-uploads everything unconfirmed."""
        from .. import serialization as ser
        from ..transport import base as tbase
        from ..transport.retry import call_with_retry

        sleep = self._sleep
        kw = {"sleep": sleep} if sleep is not None else {}
        t0 = time.perf_counter()
        shards = {key: ser.pack_shard(e) for key, e in entries.items()}
        layers = {key: (ser.shard_digest(data), len(data))
                  for key, data in shards.items()}
        spec = self.wire_spec or {}
        manifest = ser.build_wire_manifest(
            layers, density=spec.get("density", 0.0),
            quant=spec.get("quant", "int8"))
        obs.observe("wire.encode_ms", (time.perf_counter() - t0) * 1e3)
        changed = [key for key, (digest, _) in layers.items()
                   if self._last_shards.get(key) != digest]
        for key in changed:
            data = shards[key]
            call_with_retry(
                lambda key=key, data=data: tbase.publish_shard(
                    self.transport, self.miner_id, key, data),
                policy=self.publish_retry,
                describe=f"miner {self.miner_id} shard {key}", **kw)
            obs.count("wire.bytes_published", len(data))
        obs.count("wire.shards_uploaded", len(changed))
        obs.count("wire.shards_skipped", len(shards) - len(changed))
        pdr = getattr(self.transport, "publish_delta_raw", None)
        publish_manifest = pdr if pdr is not None else self.transport.publish_raw
        call_with_retry(lambda: publish_manifest(self.miner_id, manifest),
                        policy=self.publish_retry,
                        describe=f"miner {self.miner_id} wire manifest "
                                 "publish", **kw)
        obs.count("wire.bytes_published", len(manifest))
        obs.count("wire.manifest_publishes")
        self._last_shards = {key: digest
                             for key, (digest, _) in layers.items()}

    def _publish_meta(self, base_revision, cid: str | None = None,
                      wire: dict | None = None,
                      extra: dict | None = None) -> None:
        """Base-revision (+ correlation-id, + wire-format declaration)
        rider next to the delta (see transport/base.Transport
        .publish_delta_meta for the staleness protocol). The
        delta-THEN-rider order makes the only inconsistent window
        false-STALE, never false-fresh (and, for wire v2, never false-v2:
        the manifest is self-describing by its magic). Best-effort: a
        rider that fails its whole retry budget heals at the next push
        cadence, so it is logged, not counted as a failed push."""
        from ..transport.retry import call_with_retry

        pm = getattr(self.transport, "publish_delta_meta", None)
        if pm is None or (base_revision is None and cid is None
                          and wire is None and not extra):
            return
        meta: dict = dict(extra) if extra else {}
        if base_revision is not None:
            meta["base_revision"] = base_revision
        if cid is not None:
            meta["delta_id"] = cid
        if wire is not None:
            meta["wire"] = wire
        sleep = self._sleep
        try:
            with obs.span("push.meta"):
                call_with_retry(
                    lambda: pm(self.miner_id, meta),
                    policy=self.meta_retry,
                    describe=f"miner {self.miner_id} delta meta publish",
                    **({"sleep": sleep} if sleep is not None else {}))
        except Exception:
            logger.warning(
                "miner %s: delta meta publish failed after retries; "
                "skip-policy receivers may treat this push as stale "
                "until the next one", self.miner_id, exc_info=True)

    # -- async lane ---------------------------------------------------------
    def submit(self, payload: Params, finite, base_revision,
               cid: str | None = None, *,
               extra_meta: dict | None = None) -> int:
        """Hand a snapshot to the background worker; returns how many
        pending pushes it superseded. The caller must pass a snapshot the
        training steps do not overwrite (MinerLoop's fresh delta tensors):
        the worker reads them while later steps update the live state in
        place.

        ``publish.submit_ms`` is the TRAINING THREAD's whole cost of a
        push in async mode — the number the pipeline exists to keep near
        zero."""
        t0 = time.perf_counter()
        dropped = self._worker.submit(
            lambda: self.publish_now(payload, finite, base_revision, cid,
                                     extra_meta=extra_meta))
        obs.observe("publish.submit_ms", (time.perf_counter() - t0) * 1e3)
        if dropped:
            self.report.pushes_superseded += dropped
            logger.debug("miner %s: superseded %d pending push(es)",
                         self.miner_id, dropped)
        return dropped

    def flush(self, timeout: float | None = None) -> bool:
        """Drain pending + in-flight publishes (shutdown/e2e semantics:
        the final push is on the wire before flush returns)."""
        return self._worker.flush(timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        self._worker.close(timeout=timeout)
