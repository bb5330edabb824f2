"""Request-scoped serving traces — the port of the JAX package's
``utils/reqtrace.py``: the per-request causal story.

- every request gets a content-addressable ``request_id``
  (:func:`mint_request_id`: a sha256 of the request content, its
  sampling meta and a per-process sequence number), carried in the
  ``X-DT-Request-Id`` header and stamped on every stage;
- each live request keeps a timeline of stages from a closed vocabulary
  (:data:`STAGES`; :func:`check_stage` refuses anything else at the
  producer). Recording is host-side only: no device work. Per-step
  stages (``decode``/``spec``/``cow``) coalesce into one entry, so a long
  generation keeps a bounded timeline;
- a tail-exemplar reservoir keeps the slowest ttft/tpot requests of each
  window and freezes their timelines into the flight recorder
  (``serve.trace.exemplar`` / ``serve.trace.stage`` events and one
  bundle a sealed window);
- finished and refused requests feed the SLO burn-rate monitor
  (``engine/health.BurnRateMonitor``).

Request ids, records, exemplar picks and flight events are the JAX
package's for the same inputs. The engine builds a :class:`TraceBook`
only with tracing on; every instrumentation site is a single-branch
no-op without one.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time

from . import flight, obs

# ---------------------------------------------------------------------------
# The closed stage vocabulary
# ---------------------------------------------------------------------------

# stage -> description (the JAX package's vocabulary, the disaggregated
# kv_export/kv_adopt stages included so records of either package
# parse in the other). record() rejects anything else at the producer:
# a mistyped stage fails in the first test that exercises the site.
STAGES: dict[str, str] = {
    "queue": "request entered the engine queue (submit); depth at entry",
    "admit": "slot granted; queue_age_ms = submit -> admission wait",
    "readmit": "re-admission after a preempt / swap-invalidate requeue",
    "prefill": "prompt prefill dispatched; pfx_hit, pfx_tokens, dur_ms",
    "decode": "plain decode steps this request rode (coalesced batch: "
              "n steps, tokens emitted)",
    "spec": "speculative rounds (coalesced batch: n rounds, proposed, "
            "accepted)",
    "spec_draft": "drafter rebuilt its context for this request "
                  "(cold catch-up prefill before proposing)",
    "cow": "copy-on-write page copies before a shared-page write "
           "(coalesced batch)",
    "kv_export": "prefill worker exported this request's KV pages as "
                 "content-addressed shards (disaggregated serving); "
                 "pages, ok, dur_ms",
    "kv_adopt": "decode worker adopted exported KV pages into its pool "
                "(the cross-worker hop); pages, dur_ms — a failed "
                "transfer shows as a plain 'prefill' instead (the "
                "degrade path)",
    "preempt": "preempted back to the queue on page exhaustion",
    "swap_invalidate": "requeued by a restart-policy base hot-swap",
    "emit": "terminal: finished; tokens, status, ttft_ms, tpot_ms",
    "shed": "refused 429 at admission control (never queued)",
    "drain": "refused 503 while a drain-policy swap is in flight",
}

# per-step stages that merge into one batched timeline entry (the
# "decode-step batches" discipline: bounded timelines however long the
# generation)
_COALESCE = frozenset(("decode", "spec", "cow"))

_MAX_STAGES = 64        # timeline rows per request (overflow is flagged)
_MAX_WINDOW = 4096      # finished traces held per reservoir window

REQUEST_ID_HEADER = "X-DT-Request-Id"

_SEQ = itertools.count()


def check_stage(stage: str) -> str:
    """Producer-side schema lint (the reqtrace twin of
    flight.check_event_kind): a stage outside the closed vocabulary
    must fail at the call site, not parse-time at every consumer."""
    if stage not in STAGES:
        raise ValueError(f"unknown reqtrace stage {stage!r}; expected "
                         f"one of {sorted(STAGES)}")
    return stage


def mint_request_id(content, *, seq: int | None = None, **meta) -> str:
    """Content-addressable request id: ``rq-`` + 16 hex of the sha256
    over the request content (token ids, raw body bytes, or text),
    its sampling meta, and a per-process sequence number. The sequence
    keeps identical retries distinguishable; given the same
    (content, meta, seq) the id is bit-reproducible — which is what
    lets a frontend, a router, and an offline report all derive the
    same identity for one request without coordination."""
    h = hashlib.sha256()
    if isinstance(content, (bytes, bytearray)):
        h.update(bytes(content))
    elif isinstance(content, str):
        h.update(content.encode())
    else:
        h.update(json.dumps([int(t) for t in content]).encode())
    if meta:
        h.update(json.dumps(
            {k: meta[k] for k in sorted(meta)}, default=float).encode())
    n = next(_SEQ) if seq is None else int(seq)
    h.update(str(n).encode())
    return "rq-" + h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# One request's timeline
# ---------------------------------------------------------------------------

class RequestTrace:
    """The stage timeline of ONE request. Mutated by the engine's step
    thread (every stage after ``queue``); built by the submit thread
    (which records ``queue`` before the request is ever visible to the
    scheduler), so no per-record locking is needed."""

    __slots__ = ("request_id", "rid", "t0", "stages", "status", "tokens",
                 "ttft_ms", "overflow", "_tpot_sum", "_tpot_n")

    def __init__(self, request_id: str, rid: int, t0: float):
        self.request_id = request_id
        self.rid = rid
        self.t0 = t0
        self.stages: list[dict] = []
        self.status = "live"
        self.tokens = 0
        self.ttft_ms: float | None = None
        self.overflow = 0
        self._tpot_sum = 0.0
        self._tpot_n = 0

    @property
    def tpot_ms(self) -> float | None:
        return self._tpot_sum / self._tpot_n if self._tpot_n else None

    def record(self, stage: str, t: float, **fields) -> None:
        check_stage(stage)
        last = self.stages[-1] if self.stages else None
        if last is not None and last["stage"] == stage \
                and stage in _COALESCE:
            # batched per step: consecutive decode/spec/cow entries
            # merge — numeric fields accumulate, the entry spans
            # [t, t_last] with n merged steps
            last["n"] += 1
            last["t_last"] = t
            for k, v in fields.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    last[k] = last.get(k, 0) + v
            return
        if len(self.stages) >= _MAX_STAGES:
            self.overflow += 1
            return
        self.stages.append({"stage": stage, "t": t, "t_last": t, "n": 1,
                            **fields})

    def record_span(self, stage: str, t0: float, t1: float, n: int,
                    **fields) -> None:
        """Fold an ALREADY-coalesced batch in: ``n`` steps spanning
        [t0, t1]. The lazy producer path — the engine's per-token hot
        loop bumps slot-local scalars and flushes one span here when
        the request's story moves on (another stage, finish)."""
        check_stage(stage)
        last = self.stages[-1] if self.stages else None
        if last is not None and last["stage"] == stage \
                and stage in _COALESCE:
            last["n"] += n
            last["t_last"] = t1
            for k, v in fields.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    last[k] = last.get(k, 0) + v
            return
        if len(self.stages) >= _MAX_STAGES:
            self.overflow += n
            return
        self.stages.append({"stage": stage, "t": t0, "t_last": t1,
                            "n": n, **fields})

    def seen(self, stage: str) -> bool:
        return any(e["stage"] == stage for e in self.stages)

    def note_latency(self, *, ttft_ms: float | None = None,
                     tpot_ms: float | None = None,
                     tpot_sum_ms: float | None = None,
                     tpot_n: int = 0) -> None:
        """Fold the per-token latency attribution the engine's _emit
        already computes (no second clock read on the hot path).
        ``tpot_sum_ms``/``tpot_n`` fold a slot-accumulated batch in one
        call — the lazy twin of per-token ``tpot_ms``."""
        if ttft_ms is not None:
            self.ttft_ms = float(ttft_ms)
        if tpot_ms is not None:
            self._tpot_sum += float(tpot_ms)
            self._tpot_n += 1
        if tpot_sum_ms is not None:
            self._tpot_sum += float(tpot_sum_ms)
            self._tpot_n += int(tpot_n)

    def as_record(self) -> dict:
        """JSON-able summary (tests / debugging; the flight freeze path
        serializes stage-by-stage instead)."""
        return {"request_id": self.request_id, "rid": self.rid,
                "t0": self.t0, "status": self.status,
                "tokens": self.tokens, "ttft_ms": self.ttft_ms,
                "tpot_ms": self.tpot_ms, "overflow": self.overflow,
                "stages": [dict(e) for e in self.stages]}


# ---------------------------------------------------------------------------
# The per-engine collector
# ---------------------------------------------------------------------------

class TraceBook:
    """Per-engine trace collector + tail-exemplar reservoir.

    Thread contract: ``start``/``reject`` may be called from HTTP
    handler threads (they only touch ``_live``/``_window`` under
    ``_lock``); ``stage``/``note_latency``/``finish`` run on the single
    scheduler thread. ``seal_window`` may be called from either (the
    engine's finish path auto-seals on window expiry; the engine's close
    seals explicitly so a short live run still freezes its
    exemplars)."""

    def __init__(self, *, clock=time.time, exemplar_k: int = 4,
                 window_s: float = 30.0, burn=None):
        if exemplar_k < 1:
            raise ValueError(f"exemplar_k must be >= 1, got {exemplar_k}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.clock = clock
        self.exemplar_k = exemplar_k
        self.window_s = window_s
        self.burn = burn
        self._live: dict[int, RequestTrace] = {}
        self._window: list[RequestTrace] = []
        self._window_t0 = float(clock())
        self._lock = threading.Lock()
        self.started = 0
        self.finished = 0
        self.rejected = 0
        self.windows_sealed = 0
        self.exemplars_frozen = 0
        self.last_pm_ref: str | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self, req, *, depth: int = 0) -> RequestTrace:
        """Open a trace for a submitted request and record its ``queue``
        stage (``req`` is a serve.ServeRequest: needs .rid,
        .request_id, .submitted_t)."""
        t = float(req.submitted_t or self.clock())
        tr = RequestTrace(req.request_id or f"rq-rid{req.rid}", req.rid, t)
        tr.record("queue", t, depth=depth)
        with self._lock:
            self._live[req.rid] = tr
            self.started += 1
        return tr

    def stage(self, rid: int, stage: str, t: float | None = None,
              **fields) -> None:
        """Record one stage against a live request — single-branch
        no-op for untracked rids (requests submitted before tracing
        was enabled). ``t`` lets a batched caller hoist ONE clock read
        per step instead of one per slot (the decode hot path)."""
        tr = self._live.get(rid)
        if tr is None:
            return
        tr.record(stage, float(self.clock()) if t is None else t,
                  **fields)

    def stage_span(self, rid: int, stage: str, t0: float, t1: float,
                   n: int, **fields) -> None:
        """Record a producer-coalesced batch of ``n`` steps spanning
        [t0, t1] (see RequestTrace.record_span)."""
        tr = self._live.get(rid)
        if tr is not None:
            tr.record_span(stage, t0, t1, n, **fields)

    def seen(self, rid: int, stage: str) -> bool:
        tr = self._live.get(rid)
        return tr.seen(stage) if tr is not None else False

    def note_latency(self, rid: int, **kw) -> None:
        tr = self._live.get(rid)
        if tr is not None:
            tr.note_latency(**kw)

    def get(self, rid: int) -> RequestTrace | None:
        return self._live.get(rid)

    def finish(self, req, status: str) -> RequestTrace | None:
        """Close a request's trace: records the terminal ``emit`` stage,
        feeds the burn-rate monitor, and enters the trace into the
        current reservoir window (sealing the window first when it
        expired)."""
        with self._lock:
            tr = self._live.pop(req.rid, None)
        if tr is None:
            return None
        now = float(self.clock())
        tr.status = status
        tr.tokens = len(req.tokens)
        tr.record("emit", now, tokens=tr.tokens, status=status,
                  ttft_ms=tr.ttft_ms, tpot_ms=tr.tpot_ms)
        if self.burn is not None:
            try:
                self.burn.observe(now, ttft_ms=tr.ttft_ms,
                                  tpot_ms=tr.tpot_ms)
            except Exception:
                pass  # a broken monitor must never break serving
        with self._lock:
            self.finished += 1
            if len(self._window) < _MAX_WINDOW:
                self._window.append(tr)
        if now - self._window_t0 >= self.window_s:
            self.seal_window(now=now)
        return tr

    def reject(self, request_id: str | None, stage: str, **fields) -> str:
        """Record a request refused at admission control (``shed`` /
        ``drain``) — it never queued, so its whole timeline is the one
        refusal stage. Feeds the shed stream of the burn monitor.
        Returns the (possibly just-minted) request id."""
        check_stage(stage)
        now = float(self.clock())
        rid = request_id or mint_request_id(b"", t=round(now, 3))
        tr = RequestTrace(rid, -1, now)
        tr.record(stage, now, **fields)
        tr.status = stage
        with self._lock:
            self.rejected += 1
        if self.burn is not None:
            try:
                self.burn.observe(now, shed=True)
            except Exception:
                pass
        obs.count("serve.trace_rejects")
        return rid

    # -- the reservoir -------------------------------------------------------
    def _pick_exemplars(self, window: list[RequestTrace]
                        ) -> list[RequestTrace]:
        """The K slowest by ttft UNION the K slowest by tpot — the two
        tails a serving SLO decomposes into (a queue-bound request and
        a decode-bound request are different stories)."""
        k = self.exemplar_k
        by_ttft = sorted((t for t in window if t.ttft_ms is not None),
                         key=lambda t: -t.ttft_ms)[:k]
        by_tpot = sorted((t for t in window if t.tpot_ms is not None),
                         key=lambda t: -(t.tpot_ms or 0.0))[:k]
        out, seen = [], set()
        for tr in by_ttft + by_tpot:
            if id(tr) not in seen:
                seen.add(id(tr))
                out.append(tr)
        return out

    def seal_window(self, *, now: float | None = None,
                    reason: str = "trace_exemplar") -> str | None:
        """Close the current reservoir window: freeze the tail
        exemplars' full timelines into the flight recorder
        (``serve.trace.*`` events + one content-addressed bundle) and
        start a fresh window. Returns the bundle id (``pm_ref``) or
        None when there was nothing to freeze / no recorder."""
        now = float(self.clock()) if now is None else now
        with self._lock:
            window, self._window = self._window, []
            self._window_t0 = now
        if not window:
            return None
        self.windows_sealed += 1
        obs.count("serve.trace_windows")
        exemplars = self._pick_exemplars(window)
        if not exemplars or flight.recorder() is None:
            return None
        for tr in exemplars:
            self._freeze_one(tr)
        self.exemplars_frozen += len(exemplars)
        obs.count("serve.trace_exemplars", len(exemplars))
        ref = flight.freeze_and_publish(reason)
        if ref:
            self.last_pm_ref = ref
        return ref

    @staticmethod
    def _freeze_one(tr: RequestTrace) -> None:
        flight.record(
            "serve.trace.exemplar", request_id=tr.request_id, rid=tr.rid,
            t0=round(tr.t0, 6), status=tr.status, tokens=tr.tokens,
            ttft_ms=None if tr.ttft_ms is None else round(tr.ttft_ms, 3),
            tpot_ms=None if tr.tpot_ms is None else round(tr.tpot_ms, 3),
            stages=len(tr.stages), overflow=tr.overflow or None)
        for e in tr.stages:
            extra = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in e.items()
                     if k not in ("stage", "t", "t_last", "n")}
            # a stage that measured its own duration (prefill,
            # spec_draft) wins over the coalesced [t, t_last] span
            dur = extra.pop("dur_ms",
                            round((e["t_last"] - e["t"]) * 1e3, 3))
            flight.record(
                "serve.trace.stage", request_id=tr.request_id,
                stage=e["stage"], rel_ms=round((e["t"] - tr.t0) * 1e3, 3),
                dur_ms=dur, n=e["n"], **extra)

    # -- exposure ------------------------------------------------------------
    @property
    def live_count(self) -> int:
        return len(self._live)

    def counters(self) -> dict:
        """Numeric snapshot for healthz / heartbeat extras."""
        return {"trace_started": float(self.started),
                "trace_finished": float(self.finished),
                "trace_rejected": float(self.rejected),
                "trace_windows": float(self.windows_sealed),
                "trace_exemplars": float(self.exemplars_frozen)}
