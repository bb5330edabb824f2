"""Phase-timing registry: counters, gauges, latency histograms, spans and
correlation ids.

The serving engine reports through it as ``serve.*`` (``serve.ttft_ms``,
``serve.tpot_ms``, ...), the miner as ``miner.*`` (``miner.step_ms``,
``miner.data_wait_ms``) and its publisher as ``publish.*``, ``wire.*``
(the v2 shard publish) and ``push.*`` spans; the averager as ``avg.*``
spans (``avg.fetch``, ``avg.screen``, ``avg.merge``, ``avg.eval``,
``avg.publish``), ``ingest.*`` and ``wire.*`` counters,
``delta.densify_fallbacks`` and ``merge.weights_reused``. Same names and semantics as the JAX package's
``utils/obs.py``: the registry, ``span`` (a ``span.<name>_ms``
histogram), the thread-local correlation id (``correlate``,
``current_cid``, ``new_delta_id``) and ``flush`` (a registry snapshot
through a caller's sink). Span records, the role's own sink and the
anomaly monitor come with the ported metrics sinks (slice 7).

Everything is off until ``configure()`` switches it on: the
module-level ``count``/``observe``/``gauge``/``span`` helpers are
single-branch no-ops when disabled, so the hot path may call them
unconditionally. Instruments are lock-protected (HTTP handler threads,
the serve loop and the publish worker touch the registry concurrently).
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
import time
from collections import deque
from typing import Any, Iterable

_NAME_RE = re.compile(r"^[a-z0-9_.]+$")


def check_metric_name(name: str) -> str:
    """Reject anything outside ``[a-z0-9_.]`` (the JAX package's
    flattened ``<name>.p99`` exporter names assume it)."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: must match [a-z0-9_.]+")
    return name


class Counter:
    """Monotonic float counter (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = check_metric_name(name)
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-value-wins gauge (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = check_metric_name(name)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


def percentile(sorted_vals, q: float) -> float:
    """numpy's default ('linear') percentile on an already-sorted list."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_vals[0])
    pos = (n - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class Histogram:
    """Latency histogram over a bounded ring reservoir (thread-safe):
    percentiles reflect the most recent ``capacity`` observations,
    ``count`` and the sum are lifetime."""

    __slots__ = ("name", "capacity", "_ring", "_count", "_total", "_lock")

    def __init__(self, name: str, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = check_metric_name(name)
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring.append(float(value))
            self._count += 1
            self._total += float(value)

    @property
    def count(self) -> int:
        return self._count

    def percentiles(self, qs: Iterable[float] = (50.0, 95.0, 99.0)
                    ) -> dict[str, float]:
        with self._lock:
            vals = sorted(self._ring)
        return {f"p{int(q)}": percentile(vals, q) for q in qs}

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            count, total = self._count, self._total
        out = {"count": float(count), "sum": total}
        if count:
            out.update(self.percentiles())
        return out


class Registry:
    """Named counters, gauges and histograms; get-or-create,
    kind-checked: one name is ONE instrument, so two call sites cannot
    silently split a metric into two series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, kind) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name)
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def peek(self, name: str) -> Any | None:
        """The instrument under ``name`` (or None) without creating one."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict[str, float]:
        """Flat numeric dict: counters and gauges as ``name``, histograms
        as ``name.count/.sum/.p50/.p95/.p99``."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, float] = {}
        for name, m in items:
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            else:
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
        return out


class _ObsState:
    def __init__(self):
        self.registry = Registry()
        self.enabled = False
        self.tl = threading.local()   # per-thread correlation id


_STATE = _ObsState()


def configure() -> Registry:
    """Switch the instruments on and return the registry.
    Re-configuring keeps the registry."""
    _STATE.enabled = True
    return _STATE.registry


def registry() -> Registry:
    return _STATE.registry


def reset() -> None:
    """Switch the instruments off and drop the registry."""
    global _STATE
    _STATE = _ObsState()


def count(name: str, n: float = 1.0) -> None:
    """Increment a counter — no-op when disabled."""
    if not _STATE.enabled:
        return
    _STATE.registry.counter(name).inc(n)


def observe(name: str, value: float) -> None:
    """Record into a histogram — no-op when disabled."""
    if not _STATE.enabled:
        return
    _STATE.registry.histogram(name).observe(value)


def gauge(name: str, value: float) -> None:
    """Set a gauge — no-op when disabled."""
    if not _STATE.enabled:
        return
    _STATE.registry.gauge(name).set(value)


def flush(sink=None, *, step: int | None = None) -> dict[str, float]:
    """Snapshot the registry, and log it through ``sink`` (an object with
    ``log(record, step=...)``) when one is given: the periodic-flush
    primitive the miner calls at its log cadence."""
    snap = _STATE.registry.snapshot() if _STATE.enabled else {}
    if snap and sink is not None:
        sink.log(dict(snap), step=step)
    return snap


# ---------------------------------------------------------------------------
# Correlation ids and spans
# ---------------------------------------------------------------------------

def new_delta_id(miner_id: str, seq: int) -> str:
    """Deterministic per-push correlation id (the push SEQUENCE, so
    superseded pushes stay distinguishable); it rides the delta's meta
    rider as ``delta_id``."""
    return f"{miner_id}-{seq:06d}"


def current_cid() -> str | None:
    return getattr(_STATE.tl, "cid", None)


@contextlib.contextmanager
def correlate(cid: str | None):
    """Set the CURRENT thread's correlation id for the duration (the
    publish worker re-enters its job's id through this: thread-local
    state does not cross threads)."""
    tl = _STATE.tl
    prev = getattr(tl, "cid", None)
    tl.cid = cid
    try:
        yield
    finally:
        tl.cid = prev


_CID_MAX_LEN = 120


def capture_context() -> str | None:
    """This thread's correlation id, for hand-off to a worker thread (the
    ingest pool installs it per job with :func:`use_context`)."""
    return current_cid()


@contextlib.contextmanager
def use_context(ctx: str | None):
    """Install a :func:`capture_context` snapshot on the current thread
    for the duration."""
    with correlate(ctx):
        yield


def rider_delta_id(meta) -> str | None:
    """Defensive read of ``delta_id`` from a PEER-CONTROLLED meta rider:
    a short string or nothing."""
    if not isinstance(meta, dict):
        return None
    v = meta.get("delta_id")
    if isinstance(v, str) and 0 < len(v) <= _CID_MAX_LEN:
        return v
    return None


@contextlib.contextmanager
def span(name: str, *, cid: str | None = None, **attrs):
    """Time a phase into the ``span.<name>_ms`` histogram; ``cid`` sets
    the thread's correlation id inside it. ``attrs`` (miner, cache, ...)
    annotate the JAX package's span records; the port keeps the
    histogram only, so they are accepted and dropped. A no-op when
    disabled."""
    if not _STATE.enabled:
        yield
        return
    check_metric_name(name)
    reg = _STATE.registry
    t0 = time.perf_counter()
    with correlate(cid if cid is not None else current_cid()):
        try:
            yield
        finally:
            reg.histogram(f"span.{name}_ms").observe(
                (time.perf_counter() - t0) * 1e3)
