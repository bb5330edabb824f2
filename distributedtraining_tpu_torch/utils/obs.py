"""Phase-timing registry: counters, gauges and latency histograms.

The serving engine reports through it as ``serve.*`` (``serve.ttft_ms``,
``serve.tpot_ms``, ``serve.step_ms``, ``serve.prefill_ms``,
``serve.tokens``, ``serve.preempted``, ...). Same names and semantics
as the JAX package's ``utils/obs.py``, of which this is the registry
half: snapshots, sinks, spans, correlation ids and the anomaly monitor
come with the ported fleet planes.

Everything is off until ``configure()`` switches it on: the
module-level ``count``/``observe``/``gauge`` helpers are single-branch
no-ops when disabled, so the hot path may call them unconditionally.
Instruments are lock-protected (HTTP handler threads and the serve loop
touch the registry concurrently).
"""

from __future__ import annotations

import math
import re
import threading
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
    ``count`` is lifetime."""

    __slots__ = ("name", "capacity", "_ring", "_count", "_lock")

    def __init__(self, name: str, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = check_metric_name(name)
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring.append(float(value))
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def percentiles(self, qs: Iterable[float] = (50.0, 95.0, 99.0)
                    ) -> dict[str, float]:
        with self._lock:
            vals = sorted(self._ring)
        return {f"p{int(q)}": percentile(vals, q) for q in qs}


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


class _ObsState:
    def __init__(self):
        self.registry = Registry()
        self.enabled = False


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
