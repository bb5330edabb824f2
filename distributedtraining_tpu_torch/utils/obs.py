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
``current_cid``, ``new_delta_id``), ``flush`` (a registry snapshot
through a caller's sink or the configured one, tagged with the role as
``obs_registry``), the flight recorder's hooks
(``attach_flight``: span closes and flushes reach its ring) and
:class:`AnomalyMonitor` (a loss spike, a push-failure streak or a
step-time p99 blowout arms one ``utils.metrics.TraceCapture`` window).
``configure(sink, role=)`` binds the role's sink (``--metrics-path``):
every span then also lands there as one ``{"span", "dur_ms", "t0",
"depth", "role", "parent", "cid", ...attrs}`` record, the JAX package's,
and with the device observatory on (``attach_devprof``, which
``utils/devprof.enable`` calls) every flush also logs its
``{"devprof": ...}`` record. ``Registry(max_names=)`` caps the name
cardinality (new names past it are dropped and counted),
``Registry.merge`` folds registries (``merge_from`` on each
instrument), ``flush_to`` logs one snapshot, and ``fetch_cid`` reads a
miner's correlation id from its rider.

Everything is off until ``configure()`` switches it on: the
module-level ``count``/``observe``/``gauge``/``span`` helpers are
single-branch no-ops when disabled, so the hot path may call them
unconditionally. Instruments are lock-protected (HTTP handler threads,
the serve loop and the publish worker touch the registry concurrently).
"""

from __future__ import annotations

import contextlib
import logging
import math
import re
import threading
import time
from collections import deque
from typing import Any, Iterable

logger = logging.getLogger(__name__)

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

    def merge_from(self, other: "Counter") -> None:
        """Fold another counter's total into this one (Registry.merge)."""
        self.inc(other.value)


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

    def merge_from(self, other: "Gauge") -> None:
        """Last-merged-wins, the instrument's own semantics."""
        self.set(other.value)


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

    @property
    def total(self) -> float:
        return self._total

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

    def merge_from(self, other: "Histogram") -> None:
        """Fold another histogram in: lifetime count and sum add, the
        other ring's observations extend this ring (bounded by THIS
        ring's capacity: the newest tail survives)."""
        with other._lock:
            vals = list(other._ring)
            count, total = other._count, other._total
        with self._lock:
            self._ring.extend(vals)
            self._count += count
            self._total += total


class Registry:
    """Named counters, gauges and histograms; get-or-create,
    kind-checked: one name is ONE instrument, so two call sites cannot
    silently split a metric into two series.

    ``max_names`` caps the name cardinality: once the registry holds
    that many names, a request for a NEW name logs one warning, bumps
    ``dropped_names`` and returns a detached instrument (usable, never
    snapshotted). ``merge(other)`` folds another registry in: counters
    add, gauges are last-merged-wins, histogram rings concatenate; a
    kind mismatch raises. The JAX package's rules."""

    def __init__(self, *, max_names: int | None = None):
        if max_names is not None and max_names < 1:
            raise ValueError(f"max_names must be >= 1, got {max_names}")
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}
        self.max_names = max_names
        self.dropped_names = 0
        self._warned_cap = False

    def _get(self, name: str, kind) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if self.max_names is not None \
                        and len(self._metrics) >= self.max_names:
                    self.dropped_names += 1
                    if not self._warned_cap:
                        self._warned_cap = True
                        logger.warning(
                            "registry at its %d-name cardinality cap; "
                            "dropping new metric %r (and any further new "
                            "names, counted in dropped_names)",
                            self.max_names, name)
                    return kind(name)  # detached: usable, never snapshotted
                m = self._metrics[name] = kind(name)
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def merge(self, other: "Registry") -> "Registry":
        """Fold ``other``'s instruments into this registry; returns self.
        Names past this registry's cap are dropped and counted."""
        with other._lock:
            items = list(other._metrics.items())
        for name, m in items:
            self._get(name, type(m)).merge_from(m)
        return self

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

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def digest(self) -> str:
        """Short stable digest of the metric VOCABULARY (names, not
        values), as the JAX package's registry computes it."""
        import hashlib
        return hashlib.sha256(
            ",".join(self.names()).encode()).hexdigest()[:12]

    def __len__(self) -> int:
        return len(self._metrics)

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

    def flush_to(self, sink, *, step: int | None = None) -> dict[str, float]:
        """The snapshot, logged through ``sink`` when it is not empty."""
        snap = self.snapshot()
        if snap and sink is not None:
            sink.log(snap, step=step)
        return snap


class _ObsState:
    def __init__(self):
        self.registry = Registry()
        self.enabled = False
        self.sink = None              # the role's MetricsSink, or None
        self.role: str | None = None
        self.tl = threading.local()   # per-thread correlation id, spans
        self.flight = None            # utils/flight.FlightRecorder
        # utils/devprof.on_flush while the observatory is on: flush()
        # then mirrors its per-program registry into the same sink
        self.devprof = None


_STATE = _ObsState()


def configure(sink=None, *, role: str | None = None) -> Registry:
    """Switch the instruments on and return the registry; with ``sink``
    (a MetricsSink) spans and flushes also land there, tagged with
    ``role``. Re-configuring replaces the sink and role and keeps the
    registry."""
    _STATE.enabled = True
    _STATE.sink = sink
    _STATE.role = role
    return _STATE.registry


def enabled() -> bool:
    return _STATE.enabled


def current_sink():
    """The configured MetricsSink, or None."""
    return _STATE.sink


def registry() -> Registry:
    return _STATE.registry


def attach_flight(recorder) -> None:
    """Attach (or detach, with None) a flight recorder
    (``utils/flight.py``): span closes and flushes then reach its ring.
    ``reset()`` drops the attachment with the rest of the state."""
    _STATE.flight = recorder


def attach_devprof(hook) -> None:
    """Attach (or detach, with None) the device observatory's flush hook
    (``utils/devprof.on_flush``): every :func:`flush` then also logs a
    ``{"devprof": ...}`` record through the same sink.
    ``devprof.enable()`` attaches itself; ``reset()`` drops it."""
    _STATE.devprof = hook


def registry_digest() -> str:
    return _STATE.registry.digest()


def reset() -> None:
    """Switch the instruments off and drop the registry."""
    global _STATE
    _STATE = _ObsState()


def dirty() -> bool:
    """True when the instruments are on or the registry holds metrics
    (what a test module checks it left behind)."""
    return _STATE.enabled or _STATE.sink is not None \
        or len(_STATE.registry) > 0


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
    """Snapshot the registry, and log it through ``sink`` (default: the
    configured one) as ``{"obs_registry": role, **snapshot}``: the
    periodic-flush primitive each role calls at its cadence."""
    snap = _STATE.registry.snapshot() if _STATE.enabled else {}
    if sink is None:
        sink = _STATE.sink
    if snap and sink is not None:
        sink.log({"obs_registry": _STATE.role or "unknown", **snap},
                 step=step)
    fl = _STATE.flight
    if fl is not None and _STATE.enabled:
        try:
            fl.on_flush(snap)
        except Exception:
            logger.exception("flight flush hook failed")
    dp = _STATE.devprof
    if dp is not None and sink is not None:
        try:
            dp(sink, _STATE.role)
        except Exception:
            logger.exception("devprof flush hook failed")
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


def fetch_cid(transport, miner_id: str) -> str | None:
    """Correlation id of ``miner_id``'s current artifact, from its meta
    rider: observability only, so every failure reads as None (and
    nothing is read while the instruments are off)."""
    if not _STATE.enabled:
        return None
    fm = getattr(transport, "fetch_delta_meta", None)
    if fm is None:
        return None
    try:
        return rider_delta_id(fm(miner_id))
    except Exception:
        return None


@contextlib.contextmanager
def span(name: str, *, cid: str | None = None, **attrs):
    """Time a phase into the ``span.<name>_ms`` histogram; ``cid`` sets
    the thread's correlation id inside it. With a configured sink, the
    close also logs one record (nesting per thread: ``parent``,
    ``depth``; ``attrs`` verbatim, kept JSON-able and small). A no-op
    when disabled."""
    if not _STATE.enabled:
        yield
        return
    check_metric_name(name)
    st = _STATE
    tl = st.tl
    stack = tl.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    stack.append(name)
    t0_wall = time.time()
    t0 = time.perf_counter()
    ok = True
    with correlate(cid if cid is not None else current_cid()):
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            stack.pop()
            ccid = current_cid()
            st.registry.histogram(f"span.{name}_ms").observe(dur_ms)
            if st.sink is not None:
                rec = {"span": name, "dur_ms": round(dur_ms, 3),
                       "t0": t0_wall, "depth": len(stack)}
                if st.role is not None:
                    rec["role"] = st.role
                if parent is not None:
                    rec["parent"] = parent
                if ccid is not None:
                    rec["cid"] = ccid
                if not ok:
                    rec["error"] = True
                rec.update(attrs)
                try:
                    st.sink.log(rec)
                except Exception:  # a broken sink never breaks a phase
                    logger.exception("span sink emit failed")
            fl = st.flight
            if fl is not None:
                try:
                    fl.on_span(name, dur_ms, ccid, ok)
                except Exception:  # forensics must never break a phase
                    logger.exception("flight span hook failed")


# ---------------------------------------------------------------------------
# Anomaly-triggered profiler capture
# ---------------------------------------------------------------------------

class AnomalyMonitor:
    """Arms a one-shot ``TraceCapture`` (``utils/metrics.py``) on the
    first of:

    - a loss spike: the loss exceeds ``loss_spike_factor`` x its EMA
      (after ``loss_warmup`` observations), or is non-finite;
    - a push-failure streak: ``push_failure_streak`` consecutive failed
      pushes with no success between them;
    - a step-time p99 blowout: the recent steps' p99 exceeds
      ``step_p99_factor`` x their p50 (after ``step_warmup`` steps,
      checked every ``check_every`` observations).

    Exactly one arming a monitor's lifetime, whatever fires later: the
    first anomaly is the one worth a capture window. ``capture`` may be
    None (detection and counters only, the averager's and the
    validator's monitor). The miner loop feeds observations and forwards
    ``tick()``. The same rules and numbers as the JAX package's."""

    def __init__(self, capture=None, *, loss_spike_factor: float = 2.0,
                 loss_warmup: int = 8, push_failure_streak: int = 3,
                 step_p99_factor: float = 8.0, step_warmup: int = 64,
                 check_every: int = 32):
        if loss_spike_factor <= 1.0 or step_p99_factor <= 1.0:
            raise ValueError("anomaly factors must be > 1.0")
        if push_failure_streak < 1:
            raise ValueError("push_failure_streak must be >= 1")
        self.capture = capture
        self.loss_spike_factor = loss_spike_factor
        self.loss_warmup = loss_warmup
        self.push_failure_streak = push_failure_streak
        self.step_p99_factor = step_p99_factor
        self.step_warmup = step_warmup
        self.check_every = check_every
        self.triggered: str | None = None
        self._loss_ema: float | None = None
        self._loss_seen = 0
        self._fail_streak = 0
        self._last_pushes = 0
        self._last_failed = 0
        self._steps = Histogram("anomaly.step_ms", capacity=256)

    # -- observations -------------------------------------------------------
    def observe_loss(self, loss: float) -> None:
        loss = float(loss)
        if not math.isfinite(loss):
            self._trigger("loss_nonfinite", value=loss)
            return
        self._loss_seen += 1
        if self._loss_ema is None:
            self._loss_ema = loss
            return
        if (self._loss_seen > self.loss_warmup and self._loss_ema > 0
                and loss > self.loss_spike_factor * self._loss_ema):
            self._trigger("loss_spike", value=loss, ema=self._loss_ema)
        self._loss_ema += 0.1 * (loss - self._loss_ema)

    def observe_step_ms(self, ms: float) -> None:
        self._steps.observe(ms)
        n = self._steps.count
        if n < self.step_warmup or n % self.check_every:
            return
        p = self._steps.percentiles((50.0, 99.0))
        if p["p50"] > 0 and p["p99"] > self.step_p99_factor * p["p50"]:
            self._trigger("step_time_p99", p50=p["p50"], p99=p["p99"])

    def observe_push_counters(self, pushes: int, failed: int) -> None:
        """Feed the loop's cumulative push counters; the deltas since the
        last call drive the streak (a success resets it)."""
        d_push = pushes - self._last_pushes
        d_fail = failed - self._last_failed
        self._last_pushes, self._last_failed = pushes, failed
        if d_push > 0:
            self._fail_streak = 0
        if d_fail > 0:
            self._fail_streak += d_fail
            if self._fail_streak >= self.push_failure_streak:
                self._trigger("push_failure_streak",
                              streak=self._fail_streak)

    def trigger_external(self, reason: str, **details) -> None:
        """Arm on an anomaly detected elsewhere (the lineage plane's
        quality drift): the same one-shot budget as the local rules."""
        self._trigger(check_metric_name(reason), **details)

    # -- capture plumbing ---------------------------------------------------
    def tick(self) -> None:
        """Forward one step tick to the (possibly armed) capture."""
        if self.capture is not None:
            self.capture.tick()

    def close(self) -> None:
        if self.capture is not None:
            self.capture.close()

    def _trigger(self, reason: str, **details) -> None:
        if self.triggered is not None:
            return   # one-shot: the first anomaly wins, forever
        self.triggered = reason
        count(f"obs.anomaly.{reason}")
        logger.warning("anomaly detected (%s%s)%s", reason,
                       "".join(f" {k}={v:.4g}" if isinstance(v, float)
                               else f" {k}={v}"
                               for k, v in details.items()),
                       "" if self.capture is None
                       else " — arming one-shot profiler capture")
        fl = _STATE.flight
        if fl is not None:
            try:
                fl.record("anomaly", reason=reason,
                          armed=self.capture is not None)
            except Exception:
                logger.exception("flight anomaly hook failed")
        if self.capture is not None:
            self.capture.arm()
