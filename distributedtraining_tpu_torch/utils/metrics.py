"""Metric sinks, the device's memory numbers and bounded profiler
capture — the port of the JAX package's ``utils/metrics.py``.

A ``MetricsSink`` (anything with ``log(record, step=)`` and
``log_params``) decouples the loops from the backend: ``InMemorySink``
(tests), ``JSONLSink`` (one JSON object a line, the production sink,
with size rotation) and ``multi_sink`` over several. The JAX package's
``MLflowSink`` is not ported (``--mlflow-uri`` stays refused).
``device_memory_watermarks`` / ``device_metrics`` read
``torch.cuda.memory_stats`` / ``mem_get_info`` under the JAX package's
names; on the CPU they carry no device keys. ``TraceCapture`` is the
JAX package's bounded capture on ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Protocol


class MetricsSink(Protocol):
    def log(self, metrics: dict[str, Any], *, step: int | None = None) -> None: ...
    def log_params(self, params: dict[str, Any]) -> None: ...


class InMemorySink:
    def __init__(self):
        self.records: list[dict] = []
        self.params: dict[str, Any] = {}

    def log(self, metrics: dict[str, Any], *, step: int | None = None) -> None:
        self.records.append({"step": step, **metrics})

    def log_params(self, params: dict[str, Any]) -> None:
        self.params.update(params)


def jsonl_segments(path: str) -> list[str]:
    """The rotation segments of ``path`` that exist, oldest first, the
    current file last: concatenated, a rotated run reads as an unrotated
    one."""
    out = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        out.append(f"{path}.{n}")
        n += 1
    out.reverse()  # .N is the oldest, .1 the most recently rotated
    if os.path.exists(path) or not out:
        out.append(path)
    return out


class JSONLSink:
    """One JSON object a line (``{"ts", "step", **record}``), the JAX
    package's line bytes.

    Thread-safe: each record is one ``write()`` of a whole line under a
    lock, to a handle kept open with line buffering, so a reader sees
    whole records or nothing. ``max_bytes`` bounds the current file:
    once a write carries it past the limit it rotates (``path`` ->
    ``path.1`` -> ``path.2`` ...) and the newest ``keep_segments``
    rotated segments survive (0/None: no rotation). The first record's
    open sweeps segments beyond ``retention_segments`` (default
    ``keep_segments``) that an earlier run left (``obs.segments_pruned``).
    """

    def __init__(self, path: str, *, max_bytes: int | None = None,
                 keep_segments: int = 3,
                 retention_segments: int | None = None):
        self.path = path
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if keep_segments < 1:
            raise ValueError(
                f"keep_segments must be >= 1, got {keep_segments}")
        if retention_segments is not None and retention_segments < 1:
            raise ValueError(f"retention_segments must be >= 1, "
                             f"got {retention_segments}")
        self.max_bytes = max_bytes or 0
        self.keep_segments = keep_segments
        self.retention_segments = retention_segments
        self.rotations = 0
        self.segments_pruned = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None        # opened at the first record
        self._written = None   # bytes in the current segment

    def _sweep_locked(self) -> None:
        """Drop rotated segments beyond the retention bound (the oldest,
        by construction); a failed unlink stops the sweep."""
        keep = self.retention_segments or self.keep_segments
        n = keep + 1
        pruned = 0
        while True:
            seg = f"{self.path}.{n}"
            if not os.path.exists(seg):
                break
            try:
                os.remove(seg)
            except OSError:
                break
            pruned += 1
            n += 1
        if pruned:
            self.segments_pruned += pruned
            from . import obs
            obs.count("obs.segments_pruned", pruned)

    def log(self, metrics: dict[str, Any], *, step: int | None = None) -> None:
        rec = {"ts": time.time(), "step": step, **metrics}
        line = json.dumps(rec, default=float) + "\n"
        with self._lock:
            if self._fh is None:
                self._sweep_locked()
                self._fh = open(self.path, "a", buffering=1)
                if self.max_bytes:
                    self._written = self._fh.tell()  # append: resume
            self._fh.write(line)
            if self.max_bytes:
                self._written += len(line)
                if self._written >= self.max_bytes:
                    self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift path -> path.1 -> ... -> path.keep_segments (dropped);
        whole lines and atomic renames: a reader never sees a torn
        segment. A failed rotation keeps appending, never loses a
        record."""
        self._fh.close()
        self._fh = None
        try:
            drop = f"{self.path}.{self.keep_segments}"
            if os.path.exists(drop):
                os.remove(drop)
            for n in range(self.keep_segments - 1, 0, -1):
                src = f"{self.path}.{n}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{n + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            pass
        self._written = 0
        self.rotations += 1

    def log_params(self, params: dict[str, Any]) -> None:
        self.log({"params": params})

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()


class _MultiSink:
    def __init__(self, sinks):
        self.sinks = list(sinks)

    def log(self, metrics, *, step=None):
        for s in self.sinks:
            s.log(metrics, step=step)

    def log_params(self, params):
        for s in self.sinks:
            s.log_params(params)


def multi_sink(*sinks: MetricsSink) -> MetricsSink:
    return _MultiSink(sinks)


# captures whose profiler is running: a process has one profiler, so the
# /debug/profile capture (utils/flight.capture_profile) refuses to start
# beside one
_LIVE_CAPTURES: "weakref.WeakSet[TraceCapture]" = weakref.WeakSet()


def live_captures() -> list["TraceCapture"]:
    return list(_LIVE_CAPTURES)


class TraceCapture:
    """Captures exactly ``steps`` train steps with ``torch.profiler``
    (the CPU and, on the card, CUDA activity) into a Chrome trace file
    under ``log_dir``, then stops itself. Poll ``tick()`` once a step;
    the capture starts at the first tick AFTER ``skip`` ticks, so warm-up
    never pollutes the trace, and ticks are no-ops once the window
    closed.

    ``arm=False`` constructs it DISARMED: ticks are free no-ops until
    ``arm()`` (the anomaly path, ``utils/obs.AnomalyMonitor``; ``skip``
    counts from the arming, so the window lands on the steps right after
    the anomaly). One window an instance: arming is one-way and a
    finished capture never re-arms. ``trace_path`` names the written
    file once the window closed. A window due while a ``/debug/profile``
    capture holds the profiler starts at the first tick after it."""

    def __init__(self, log_dir: str, *, steps: int = 5, skip: int = 3,
                 arm: bool = True):
        self.log_dir = log_dir
        self.steps = steps
        self.skip = skip
        self._armed = arm
        self._seen = 0
        self._prof = None
        self._done = False
        self.trace_path: str | None = None

    @property
    def armed(self) -> bool:
        return self._armed and not self._done

    @property
    def active(self) -> bool:
        return self._prof is not None

    def arm(self) -> None:
        if self._done or self._armed:
            return
        self._armed = True
        self._seen = 0

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .flight import live_profile_sessions
        if live_profile_sessions():
            return   # the profiler is a /debug/profile's: the next tick
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        _LIVE_CAPTURES.add(self)

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        _LIVE_CAPTURES.discard(self)
        prof.__exit__(None, None, None)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    def tick(self) -> None:
        if self._done or not self._armed:
            return
        self._seen += 1
        if self._prof is None and self._seen > self.skip:
            self._start()
        elif self._prof is not None and self._seen > self.skip + self.steps:
            self._stop()

    def close(self) -> None:
        """Stop an in-flight capture (role shutdown mid-window); what it
        caught is still written."""
        if self._prof is not None:
            self._stop()


# (psutil module, Process handle) once probed, False when it is missing
_PSUTIL_STATE = None
_NET_BASELINE = None   # (bytes_sent, bytes_recv) at the first sample


def _psutil_state():
    global _PSUTIL_STATE, _NET_BASELINE
    if _PSUTIL_STATE is None:
        try:
            import psutil
            proc = psutil.Process()
            psutil.cpu_percent()  # prime: the first call reads 0.0
            net = psutil.net_io_counters()
            if _NET_BASELINE is None:
                _NET_BASELINE = (net.bytes_sent, net.bytes_recv)
            _PSUTIL_STATE = (psutil, proc)
        except Exception:
            _PSUTIL_STATE = False
    return _PSUTIL_STATE


def _cuda_devices() -> list[int]:
    """This process's own card, the counterpart of JAX's
    ``local_devices()`` for one process a card (none on the CPU, and
    none before the process touched CUDA). Only the current card is
    read: querying another would create a context on it."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [torch.cuda.current_device()]


def _device_stats(i: int) -> dict | None:
    """``(in use, peak, limit)`` bytes of card ``i`` from the caching
    allocator's ``memory_stats`` and ``mem_get_info``; host calls only,
    no synchronisation."""
    import torch
    try:
        st = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
    except Exception:
        return None
    return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}


def device_memory_watermarks() -> dict[str, float]:
    """Device memory of this process's card: ``mem_in_use_bytes``
    (its bytes live now), ``mem_peak_bytes`` (its
    high-water mark) and ``mem_limit_bytes``. An empty dict on the
    CPU, so callers can surface these as gauges unconditionally."""
    out: dict[str, float] = {}
    for i in _cuda_devices():
        stats = _device_stats(i)
        if not stats:
            continue
        for key, name in (("bytes_in_use", "mem_in_use_bytes"),
                          ("peak_bytes_in_use", "mem_peak_bytes"),
                          ("bytes_limit", "mem_limit_bytes")):
            v = stats.get(key)
            if v:
                out[name] = max(out.get(name, 0.0), float(v))
    return out


def device_metrics() -> dict[str, float]:
    """System metrics at the log cadence: each card's bytes in use,
    peak and fraction of its memory (``device{i}_*``), the abandoned
    chain-call workers (``chain_abandoned_workers``, ``_total``:
    ``utils/timeout.py``) and, where ``psutil`` is installed, the host's
    CPU share, the process's RSS and the network bytes since this
    process's first sample."""
    out: dict[str, float] = {}
    # numbered as JAX numbers its local devices, from 0
    for i, card in enumerate(_cuda_devices()):
        stats = _device_stats(card)
        if not stats:
            continue
        out[f"device{i}_bytes_in_use"] = float(stats["bytes_in_use"])
        if stats["peak_bytes_in_use"]:
            out[f"device{i}_peak_bytes"] = float(stats["peak_bytes_in_use"])
        if stats["bytes_limit"]:
            out[f"device{i}_mem_fraction"] = (
                float(stats["bytes_in_use"]) / float(stats["bytes_limit"]))
    # chain-RPC hygiene (utils/timeout.py): live parked workers and
    # lifetime timeouts, in the JAX package's order
    from .timeout import abandoned_total, abandoned_workers
    out["chain_abandoned_workers"] = float(abandoned_workers())
    out["chain_abandoned_total"] = float(abandoned_total())
    state = _psutil_state()
    if state:
        psutil, proc = state
        try:
            out["cpu_percent"] = psutil.cpu_percent()
            out["rss_mb"] = proc.memory_info().rss / 1e6
            net = psutil.net_io_counters()
            out["net_sent_mb"] = (net.bytes_sent - _NET_BASELINE[0]) / 1e6
            out["net_recv_mb"] = (net.bytes_recv - _NET_BASELINE[1]) / 1e6
        except Exception:
            pass
    return out
