"""Flight recorder and postmortem plane — the port of the JAX package's
``utils/flight.py``: forensics recorded before a failure, retrievable
after it.

Every role keeps a bounded in-memory ring of structured events
(:class:`FlightRecorder`): span closes and registry snapshots (through
``obs.attach_flight`` when the instruments are on), anomaly triggers,
publish outcomes (torn base shard sets included), lineage records and
drifts, crashes, and the role's sanitized boot config. On a quality
drift or a crash (``sys.excepthook``, ``threading.excepthook``,
``atexit``, or the role's ``finally`` through :func:`shutdown`) the ring
freezes into a content-addressed postmortem bundle, a JSON document whose
``bundle_id`` hashes its contents, published through the role's transport
under the reserved ``__pm__.<role>.<hotkey>`` id, where any peer reads it
(:func:`fetch_bundle`), a dead node's included.

The producer refuses event kinds outside :data:`EVENT_KINDS` at
``record()``; :func:`parse_bundle` re-validates everything a peer sent.
Bundles and their digests are the JAX package's, byte for byte: a bundle
of either package parses in the other. Everything is a no-op until
:func:`configure` runs; a bundle travels through the transport.

:func:`capture_profile` is the ``/debug/profile`` capture of
``--obs-port`` (``utils/obs_http.py``): ``ms`` milliseconds of
``torch.profiler`` (the CPU, and CUDA activity on the card; every
thread's ops, where this PyTorch can record them: the request's thread
is not the loop's) written as a Chrome trace into ``log_dir``. A
process has one profiler: a capture beside another, or beside an active
``utils/metrics.TraceCapture`` window, raises RuntimeError (the
endpoint's 409). Sessions in flight are listed by
:func:`live_profile_sessions`.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import logging
import os
import re
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any

from . import obs

logger = logging.getLogger(__name__)

PM_VERSION = 1

# hard cap on one serialized bundle (the publisher drops the oldest events
# to fit; a reader refuses anything bigger)
PM_MAX_BYTES = 1 << 20

# the closed event vocabulary: kind -> description (the JAX package's)
EVENT_KINDS: dict[str, str] = {
    "config": "sanitized role configuration at recorder boot",
    "span": "one obs.span close (name, dur_ms, cid, error flag)",
    "metrics": "registry snapshot, taken when the metric vocabulary "
               "(registry digest) changed",
    "anomaly": "AnomalyMonitor trigger (reason + armed capture)",
    "slo": "SLO rule fired against a fleet node (engine/health.py)",
    "lease": "publication-lease transition: acquired / lost / "
             "renew_failed / takeover (engine/remediate.py)",
    "swap": "serving-plane base hot-swap outcome (engine/serve.py)",
    "publish": "delta/base publish outcome: ok / failed / torn "
               "(engine/publish.py)",
    "heartbeat": "heartbeat sent (own) or fresh beat observed (fleet)",
    "remediation": "quarantine / probation / readmission action",
    "crash": "unhandled exception or process-exit capture",
    "lineage.record": "a merge's provenance record frozen/published "
                      "(engine/lineage.py)",
    "lineage.drift": "merged-model quality drift detected by the "
                     "EWMA/CUSUM detector (engine/lineage.py)",
    "serve.trace.exemplar": "one tail-exemplar request frozen by the "
                            "reqtrace reservoir: request_id, status, "
                            "ttft/tpot, stage count (utils/reqtrace.py)",
    "serve.trace.stage": "one stage of a frozen exemplar's timeline: "
                         "request_id, stage, rel_ms/dur_ms, batched "
                         "step count + stage fields (utils/reqtrace.py)",
    "note": "free-form operator/debug annotation",
}

_MAX_STR = 400
_MAX_EVENT_FIELDS = 24
_MAX_BUNDLE_EVENTS = 4096
_MAX_TB_LINES = 40

# config keys matching this have their VALUES redacted in the config event
_SECRET_RE = re.compile(r"wallet|token|secret|password|credential|privkey",
                        re.IGNORECASE)


def check_event_kind(kind: str) -> str:
    """Producer-side lint: a kind outside the closed vocabulary fails at
    the call site."""
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown flight event kind {kind!r}; expected "
                         f"one of {sorted(EVENT_KINDS)}")
    return kind


def sanitize_config(cfg) -> dict:
    """A RunConfig (or a plain dict) as a bundle-safe dict: scalars only,
    strings capped, secret-looking keys redacted by NAME."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        items = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        items = cfg
    else:
        return {}
    out: dict[str, Any] = {}
    for k, v in items.items():
        if v is None:
            continue
        if _SECRET_RE.search(str(k)):
            out[str(k)[:_MAX_STR]] = "<redacted>"
        elif isinstance(v, bool):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = float(v)
        elif isinstance(v, str):
            out[k] = v[:_MAX_STR]
        else:   # nested structures (MeshSpec) flatten to their repr
            out[k] = str(v)[:_MAX_STR]
    return out


def _clean_fields(fields: dict) -> dict:
    """Bound one event's payload: capped keys and strings, numbers and
    bools verbatim, one flat numeric dict allowed (a registry snapshot)."""
    out: dict[str, Any] = {}
    for k, v in list(fields.items())[:_MAX_EVENT_FIELDS]:
        k = str(k)[:64]
        if v is None:
            continue
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, str):
            out[k] = v[:_MAX_STR]
        elif isinstance(v, dict):
            out[k] = {str(dk)[:120]: float(dv)
                      for dk, dv in list(v.items())[:256]
                      if isinstance(dv, (int, float))}
        else:
            out[k] = str(v)[:_MAX_STR]
    return out


class FlightRecorder:
    """Bounded ring of structured events for ONE (role, hotkey). The
    train loop, the publish worker and the ingest pool record
    concurrently: everything that touches the ring holds ``_lock``."""

    def __init__(self, role: str, hotkey: str, *, capacity: int = 512,
                 transport=None, config=None, clock=time.time):
        if capacity < 8:
            raise ValueError(f"capacity must be >= 8, got {capacity}")
        self.role = role
        self.hotkey = hotkey
        self.capacity = capacity
        self.transport = transport
        self.clock = clock
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.recorded = 0           # lifetime events (the ring keeps the tail)
        self.seq = 0                # bundles frozen by this recorder
        self.published = 0
        self.publish_failures = 0
        self.last_bundle: dict | None = None
        self._names_seen = 0        # registry vocabulary size at last check
        self._config = sanitize_config(config) if config is not None else None
        if self._config:
            self.record("config", keys=float(len(self._config)))

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        check_event_kind(kind)
        ev = {"t": round(float(self.clock()), 6), "kind": kind,
              **_clean_fields(fields)}
        with self._lock:
            self._ring.append(ev)
            self.recorded += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # -- obs hooks -----------------------------------------------------------
    def on_span(self, name: str, dur_ms: float, cid: str | None,
                ok: bool) -> None:
        f: dict[str, Any] = {"name": name, "dur_ms": round(dur_ms, 3)}
        if cid is not None:
            f["cid"] = cid
        if not ok:
            f["error"] = True
        self.record("span", **f)
        self._maybe_snapshot_metrics()

    def on_flush(self, snap: dict) -> None:
        self._maybe_snapshot_metrics()

    def _maybe_snapshot_metrics(self) -> None:
        """A registry snapshot whenever the metric VOCABULARY grew."""
        reg = obs.registry()
        n = len(reg)
        if n == self._names_seen:
            return
        self._names_seen = n
        self.record("metrics", digest=reg.digest(), names=float(n),
                    snapshot=reg.snapshot())

    # -- freezing ------------------------------------------------------------
    def freeze(self, reason: str, *, exc=None) -> dict:
        """The ring as a content-addressed postmortem bundle. ``exc`` is
        an (exc_type, exc, tb) triple for crash captures."""
        self.seq += 1
        bundle: dict[str, Any] = {
            "pm": PM_VERSION, "role": self.role, "hotkey": self.hotkey,
            "t": float(self.clock()), "seq": self.seq,
            "reason": str(reason)[:_MAX_STR],
            "recorded": self.recorded, "capacity": self.capacity,
            "events": self.events(),
            "registry": {k: float(v)
                         for k, v in obs.registry().snapshot().items()},
            "registry_digest": obs.registry_digest(),
        }
        if self._config is not None:
            bundle["config"] = dict(self._config)
        if exc is not None:
            et, ev, tb = exc
            bundle["crash"] = {
                "type": getattr(et, "__name__", str(et))[:_MAX_STR],
                "message": str(ev)[:_MAX_STR],
                "traceback": "".join(
                    traceback.format_exception(et, ev, tb)
                )[-_MAX_TB_LINES * 120:],
            }
        bundle["bundle_id"] = bundle_digest(bundle)
        self.last_bundle = bundle
        obs.count("flight.bundles")
        return bundle

    def publish(self, bundle: dict) -> bool:
        """Ship one bundle through the transport (the reserved ``__pm__``
        id). Never raises. An oversized ring drops its OLDEST events to
        fit :data:`PM_MAX_BYTES` (the newest evidence wins)."""
        if self.transport is None:
            return False
        from ..transport import base as tbase
        data = json.dumps(bundle, default=float).encode()
        while len(data) > PM_MAX_BYTES and bundle["events"]:
            drop = max(1, len(bundle["events"]) // 4)
            bundle = dict(bundle, events=bundle["events"][drop:],
                          truncated=True)
            bundle["bundle_id"] = bundle_digest(bundle)
            data = json.dumps(bundle, default=float).encode()
        try:
            tbase.publish_postmortem(self.transport, self.role,
                                     self.hotkey, data)
            self.published += 1
            obs.count("flight.bundles_published")
            logger.info("flight: published postmortem %s (%s, %d events)",
                        bundle["bundle_id"], bundle["reason"],
                        len(bundle["events"]))
            return True
        except Exception:
            self.publish_failures += 1
            obs.count("flight.publish_failures")
            logger.warning("flight: postmortem publish failed (%s)",
                           bundle["reason"], exc_info=True)
            return False


def bundle_digest(bundle: dict) -> str:
    """Content address of a bundle: sha256 over the canonical JSON of
    everything but the id itself."""
    body = {k: v for k, v in bundle.items() if k != "bundle_id"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=float).encode()
    ).hexdigest()[:16]


def parse_bundle(data) -> dict | None:
    """Defensive read of a PEER-CONTROLLED bundle (bytes or a decoded
    dict): size-capped, versioned, role/hotkey/reason validated, every
    event re-screened against :data:`EVENT_KINDS` (unknown kinds are
    dropped and counted in ``events_rejected``). A normalized dict or
    None; never raises."""
    if isinstance(data, (bytes, bytearray)):
        if len(data) > PM_MAX_BYTES:
            return None
        try:
            data = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return None
    if not isinstance(data, dict):
        return None
    v = data.get("pm")
    if not isinstance(v, (int, float)) or int(v) < 1:
        return None
    role, hotkey = data.get("role"), data.get("hotkey")
    if not (isinstance(role, str) and 0 < len(role) <= 200):
        return None
    if not (isinstance(hotkey, str) and 0 < len(hotkey) <= 200):
        return None
    out: dict[str, Any] = {
        "pm": int(v), "role": role, "hotkey": hotkey,
        "t": float(data["t"]) if isinstance(data.get("t"),
                                            (int, float)) else 0.0,
        "reason": str(data.get("reason", ""))[:_MAX_STR],
    }
    bid = data.get("bundle_id")
    if isinstance(bid, str) and 0 < len(bid) <= 64:
        out["bundle_id"] = bid
    events, rejected = [], 0
    raw = data.get("events")
    if isinstance(raw, list):
        for ev in raw[:_MAX_BUNDLE_EVENTS]:
            if not (isinstance(ev, dict) and ev.get("kind") in EVENT_KINDS
                    and isinstance(ev.get("t"), (int, float))):
                rejected += 1
                continue
            events.append({"t": float(ev["t"]), "kind": ev["kind"],
                           **_clean_fields({k: v for k, v in ev.items()
                                            if k not in ("t", "kind")})})
    out["events"] = events
    out["events_rejected"] = rejected
    for key in ("registry", "config", "crash"):
        if isinstance(data.get(key), dict):
            out[key] = data[key]
    return out


def fetch_bundle(transport, role: str, hotkey: str) -> dict | None:
    """``role``/``hotkey``'s current postmortem bundle from the
    transport, validated: how a survivor reads a dead peer's forensics."""
    from ..transport import base as tbase
    try:
        data = tbase.fetch_postmortem_bytes(transport, role, hotkey)
    except Exception:
        obs.count("flight.fetch_errors")
        logger.warning("flight: bundle fetch failed for %s/%s", role,
                       hotkey, exc_info=True)
        return None
    if data is None:
        return None
    from .. import signing
    try:
        return parse_bundle(signing.strip_envelope(data))
    except ValueError:   # a truncated envelope (serialization.PayloadError)
        return None


# ---------------------------------------------------------------------------
# Process-wide state (off until configured)
# ---------------------------------------------------------------------------

class _FlightState:
    def __init__(self):
        self.recorder: FlightRecorder | None = None
        self.hooks_installed = False
        self.prev_excepthook = None
        self.prev_threading_hook = None


_STATE = _FlightState()


def configure(role: str, hotkey: str, *, transport=None,
              capacity: int = 512, config=None) -> FlightRecorder:
    """Bind the process's flight recorder (one a role process).
    Re-configuring replaces it."""
    rec = FlightRecorder(role, hotkey, capacity=capacity,
                         transport=transport, config=config)
    _STATE.recorder = rec
    obs.attach_flight(rec)
    return rec


def recorder() -> FlightRecorder | None:
    return _STATE.recorder


def hooks_installed() -> bool:
    return _STATE.hooks_installed


def record(kind: str, **fields) -> None:
    """Record one event: a single-branch no-op when no recorder is
    configured, so call sites may call it unconditionally."""
    rec = _STATE.recorder
    if rec is None:
        return
    rec.record(kind, **fields)


def freeze_and_publish(reason: str, *, exc=None) -> str | None:
    """Freeze the ring and ship the bundle; its ``bundle_id``, or None
    when no recorder is configured. Never raises."""
    rec = _STATE.recorder
    if rec is None:
        return None
    try:
        bundle = rec.freeze(reason, exc=exc)
        rec.publish(bundle)
        return bundle["bundle_id"]
    except Exception:
        logger.exception("flight: freeze/publish failed (%s)", reason)
        return None


def reset() -> None:
    """Drop the recorder and uninstall the crash hooks."""
    uninstall_crash_hooks()
    _STATE.recorder = None
    obs.attach_flight(None)


def shutdown() -> None:
    """The role main's ``finally``: when the role is leaving on an
    unhandled exception (KeyboardInterrupt and SystemExit are normal
    exits), freeze a crash bundle first, then :func:`reset`."""
    et, ev, tb = sys.exc_info()
    if (et is not None and _STATE.recorder is not None
            and not issubclass(et, (KeyboardInterrupt, SystemExit,
                                    GeneratorExit))):
        record("crash", where="shutdown",
               type=getattr(et, "__name__", str(et)), message=str(ev))
        freeze_and_publish("crash", exc=(et, ev, tb))
    reset()


# ---------------------------------------------------------------------------
# Crash hooks
# ---------------------------------------------------------------------------

def _atexit_freeze() -> None:
    # the last bundle on interpreter exit
    if _STATE.recorder is not None:
        freeze_and_publish("exit")


def install_crash_hooks() -> None:
    """Install the unhandled-exception and atexit freeze triggers
    (idempotent). Role entry points call this after building; library
    code must not."""
    if _STATE.hooks_installed:
        return
    _STATE.hooks_installed = True
    _STATE.prev_excepthook = sys.excepthook

    def _hook(et, ev, tb):
        try:
            if _STATE.recorder is not None:
                record("crash", where="main",
                       type=getattr(et, "__name__", str(et)),
                       message=str(ev))
                freeze_and_publish("crash", exc=(et, ev, tb))
        finally:
            (_STATE.prev_excepthook or sys.__excepthook__)(et, ev, tb)

    sys.excepthook = _hook
    _STATE.prev_threading_hook = threading.excepthook

    def _thook(args):
        try:
            if (_STATE.recorder is not None
                    and not issubclass(args.exc_type, SystemExit)):
                record("crash", where="thread",
                       thread=getattr(args.thread, "name", "?"),
                       type=getattr(args.exc_type, "__name__",
                                    str(args.exc_type)),
                       message=str(args.exc_value))
                freeze_and_publish(
                    "thread_crash",
                    exc=(args.exc_type, args.exc_value, args.exc_traceback))
        finally:
            prev = _STATE.prev_threading_hook or threading.__excepthook__
            prev(args)

    threading.excepthook = _thook
    atexit.register(_atexit_freeze)


def uninstall_crash_hooks() -> None:
    if not _STATE.hooks_installed:
        return
    _STATE.hooks_installed = False
    if _STATE.prev_excepthook is not None:
        sys.excepthook = _STATE.prev_excepthook
        _STATE.prev_excepthook = None
    if _STATE.prev_threading_hook is not None:
        threading.excepthook = _STATE.prev_threading_hook
        _STATE.prev_threading_hook = None
    atexit.unregister(_atexit_freeze)


# ---------------------------------------------------------------------------
# On-demand profiler capture (the /debug/profile endpoint)
# ---------------------------------------------------------------------------

MAX_PROFILE_MS = 10_000

# sessions whose profiler is running (a test module that leaves one live
# has leaked the process's one profiler)
_LIVE_PROFILES: set = set()
_PROFILE_LOCK = threading.Lock()


def _profiler(activities):
    """A ``torch.profiler.profile`` recording every thread's CPU ops
    where this PyTorch has the option (the capture runs on an HTTP
    handler's thread, the programs on the loop's)."""
    from torch.profiler import profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=activities,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=activities)


class ProfileSession:
    """One time-bounded ``torch.profiler`` window (against the
    step-driven ``TraceCapture``), started and stopped by
    :func:`capture_profile`; ``trace_path`` names its Chrome trace once
    stopped."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.active = False
        self.trace_path: str | None = None
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = _profiler(acts)
        self._prof.__enter__()
        self.active = True
        _LIVE_PROFILES.add(self)

    def stop(self) -> None:
        if not self.active:
            return
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(None, None, None)
            path = os.path.join(
                self.log_dir, f"profile_{os.getpid()}_"
                f"{int(time.time() * 1e3)}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        finally:
            self.active = False
            _LIVE_PROFILES.discard(self)

    def __repr__(self):
        return f"ProfileSession({self.log_dir!r}, active={self.active})"


def live_profile_sessions() -> list[ProfileSession]:
    return list(_LIVE_PROFILES)


def capture_profile(log_dir: str, ms: float, *,
                    sleep=time.sleep) -> dict:
    """Capture ``ms`` milliseconds (1 to :data:`MAX_PROFILE_MS`) of
    ``torch.profiler`` trace into ``log_dir``, synchronously on the
    calling thread. One capture a process: a concurrent request, or an
    active ``TraceCapture`` window, raises RuntimeError. Records a
    ``note`` (``debug_profile``) in the flight ring and counts
    ``flight.profiles_captured``."""
    from .metrics import live_captures
    ms = max(1.0, min(float(ms), float(MAX_PROFILE_MS)))
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    try:
        if live_captures():
            raise RuntimeError("a TraceCapture window holds the profiler")
        sess = ProfileSession(log_dir)
        try:
            sess.start()
            sleep(ms / 1e3)
        finally:
            sess.stop()
    finally:
        _PROFILE_LOCK.release()
    obs.count("flight.profiles_captured")
    record("note", what="debug_profile", trace_dir=log_dir, ms=ms)
    return {"trace_dir": log_dir, "ms": ms, "trace": sess.trace_path}
