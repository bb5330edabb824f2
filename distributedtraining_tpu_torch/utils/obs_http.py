"""Zero-dependency Prometheus-text HTTP exporter for the obs registry and
the fleet health ledger — the port of the JAX package's
``utils/obs_http.py``, with its text.

``--obs-port N`` makes a role scrapeable: a standard-library
``ThreadingHTTPServer`` on a daemon thread serves

- ``/metrics``: Prometheus text exposition (version 0.0.4). Every
  registry counter and gauge as ``dt_<name>`` (dots become
  underscores), every histogram as its flattened
  ``_count/_sum/_p50/_p95/_p99`` gauges, ``serve.ttft_ms`` and
  ``serve.tpot_ms`` also as one labeled family each
  (``dt_serve_ttft_ms{q="0.5|0.95|0.99"}``), the device observatory's
  ``dt_prog_*{prog,bucket}`` and ``dt_compile_ms{prog,bucket}``
  (``utils/devprof.prom_lines``), the serving SLO burn rates
  ``dt_slo_burn{slo,window}`` (``engine/health.live_burn_monitor``) and,
  with a FleetMonitor attached, the ledger as
  ``dt_fleet_*{role=...,hotkey=...}`` series and the breaches;
- ``/healthz``: a JSON liveness probe (role, metric count, fleet size);
- ``/debug/dump``: the flight ring frozen into a postmortem bundle NOW,
  returned as JSON (``?publish=1`` also ships it through the transport
  under the reserved ``__pm__`` id);
- ``/debug/profile?ms=N``: N milliseconds of ``torch.profiler`` trace
  into the exporter's profile dir (``utils/flight.capture_profile``; 409
  while a capture or a ``TraceCapture`` window runs);
- ``/debug/stacks``: every thread's stack (text/plain).

No TLS, binds 127.0.0.1 by default: a scrape endpoint for a co-located
agent, not a public surface. Live exporters are listed by
:func:`live_exporters`, so a test can fail one that leaves a socket
listening.
"""

from __future__ import annotations

import json
import logging
import math
import sys
import threading
import traceback
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from . import devprof, obs

logger = logging.getLogger(__name__)

_LIVE_EXPORTERS: "weakref.WeakSet[ObsHTTPExporter]" = weakref.WeakSet()


def live_exporters() -> list["ObsHTTPExporter"]:
    return list(_LIVE_EXPORTERS)


def prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name (the registry's
    ``[a-z0-9_.]`` lint plus the ``dt_`` prefix make it legal)."""
    return "dt_" + name.replace(".", "_")


def _prom_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _label_escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
                 .replace("\n", r"\n")


# ledger field -> (prometheus suffix, help): the numeric per-node series
_FLEET_SERIES = (
    ("beats", "fleet_beats", "distinct heartbeats observed"),
    ("last_seen_age_s", "fleet_last_seen_age_seconds",
     "seconds since the last fresh heartbeat"),
    ("steps", "fleet_steps", "lifetime steps reported"),
    ("step_rate", "fleet_step_rate", "steps per second"),
    ("loss_ema", "fleet_loss_ema", "node loss EMA"),
    ("pushes", "fleet_pushes", "deltas the node reports published"),
    ("pushes_failed", "fleet_pushes_failed", "exhausted publish retries"),
    ("published", "fleet_published", "distinct delta revisions staged"),
    ("accepted", "fleet_accepted", "deltas accepted into merges"),
    ("declined", "fleet_declined", "deltas declined at staging"),
    ("stale_rounds", "fleet_stale_rounds",
     "rounds since the delta revision changed"),
    ("score", "fleet_score", "latest validator score"),
    ("credit", "lineage_credit",
     "accumulated leave-one-out improvement credit across base "
     "revisions (engine/lineage.py)"),
    ("mem_peak_bytes", "fleet_mem_peak_bytes",
     "node device-memory high-water mark"),
    ("quarantined", "fleet_quarantined",
     "1 while the node is quarantined out of the ingest set"),
    ("probation", "fleet_probation",
     "1 while the node is re-admitted on probation"),
    ("kv_exported", "serve_kv_exported",
     "requests whose prefill KV pages were published for a decode "
     "worker (disaggregated serving, prefill phase)"),
    ("kv_adopted", "serve_kv_adopted",
     "requests admitted on adopted prefill KV instead of a local "
     "prefill (disaggregated serving, decode phase)"),
)


# serving histograms also exported as ONE labeled gauge family each, so
# a latency panel selects quantiles by label
_QUANTILE_HISTS = ("serve.ttft_ms", "serve.tpot_ms")
_QUANTILE_LABELS = ((50.0, "0.5"), (95.0, "0.95"), (99.0, "0.99"))


def render(registry=None, fleet=None) -> str:
    """The exposition body (separable from the server for tests and
    one-shot dumps)."""
    reg = registry if registry is not None else obs.registry()
    lines: list[str] = []
    snap = reg.snapshot()
    for name in sorted(snap):
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_prom_value(snap[name])}")
    peek = getattr(reg, "peek", None)
    for name in (_QUANTILE_HISTS if peek is not None else ()):
        hist = peek(name)
        if hist is None or not hasattr(hist, "percentiles") \
                or not hist.count:
            continue
        ps = hist.percentiles(tuple(q for q, _ in _QUANTILE_LABELS))
        pn = prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        for q, label in _QUANTILE_LABELS:
            lines.append(
                f'{pn}{{q="{label}"}} {_prom_value(ps[f"p{int(q)}"])}')
    try:
        # the device observatory: dt_prog_*{prog,bucket} and the labeled
        # dt_compile_ms{prog,bucket}; its max_programs cap bounds the
        # cardinality; empty while it is off
        lines.extend(devprof.prom_lines())
    except Exception:  # a broken observatory must not 500 the registry
        logger.exception("obs_http: devprof render failed")
    try:
        # SLO burn rates: dt_slo_burn{slo,window} (utils must not import
        # engine at module load)
        from ..engine import health as _health
        burn = _health.live_burn_monitor()
        if burn is not None:
            lines.append("# HELP dt_slo_burn error-budget burn rate "
                         "(bad_fraction/budget) per SLO per window")
            lines.append("# TYPE dt_slo_burn gauge")
            for (slo, window), v in sorted(burn.gauges().items()):
                lines.append(
                    f'dt_slo_burn{{slo="{_label_escape(slo)}",'
                    f'window="{_label_escape(window)}"}} '
                    f"{_prom_value(v)}")
    except Exception:  # a broken monitor must not 500 the registry
        logger.exception("obs_http: burn render failed")
    if fleet is not None:
        try:
            ledger = fleet.ledger()
        except Exception:  # a broken monitor must not 500 the registry
            logger.exception("obs_http: fleet ledger render failed")
            ledger = {}
        for field, pn_suffix, help_txt in _FLEET_SERIES:
            rows = [(rec, rec.get(field)) for rec in ledger.values()
                    if isinstance(rec.get(field), (int, float))]
            if not rows:
                continue
            pn = "dt_" + pn_suffix
            lines.append(f"# HELP {pn} {help_txt}")
            lines.append(f"# TYPE {pn} gauge")
            for rec, v in rows:
                labels = (f'role="{_label_escape(rec["role"])}",'
                          f'hotkey="{_label_escape(rec["hotkey"])}"')
                lines.append(f"{pn}{{{labels}}} {_prom_value(v)}")
        breaches = [rec for rec in ledger.values() if rec.get("breaches")]
        if breaches:
            lines.append("# TYPE dt_fleet_slo_breached gauge")
            for rec in breaches:
                for rule in rec["breaches"]:
                    lines.append(
                        f'dt_fleet_slo_breached{{role='
                        f'"{_label_escape(rec["role"])}",hotkey='
                        f'"{_label_escape(rec["hotkey"])}",rule='
                        f'"{_label_escape(rule)}"}} 1.0')
    return "\n".join(lines) + "\n"


def render_stacks() -> str:
    """Every thread's stack (the /debug/stacks body): thread name,
    daemon flag and current frames, newest frame last."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        t = by_ident.get(ident)
        name = t.name if t is not None else f"ident-{ident}"
        daemon = " daemon" if t is not None and t.daemon else ""
        out.append(f"--- thread {name}{daemon} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out) + "\n"


class ObsHTTPExporter:
    """Serve :func:`render` on ``http://host:port/metrics`` and the
    debug endpoints.

    ``port=0`` binds an ephemeral port; :meth:`start` returns the bound
    port (also ``.port``). The server thread and every handler thread
    are daemons; :meth:`close` shuts the listener down and joins the
    serve thread (idempotent)."""

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry=None, fleet=None, role: str | None = None,
                 profile_dir: str | None = None):
        self.host = host
        self.port = port
        self.registry = registry
        self.fleet = fleet
        self.role = role
        # where /debug/profile writes its traces; None falls back to a
        # temporary directory at the first capture
        self.profile_dir = profile_dir
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        if self._server is not None:
            return self.port
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: no per-scrape spam
                logger.debug("obs_http: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj) -> None:
                self._send(code, (json.dumps(obj, default=float)
                                  + "\n").encode(), "application/json")

            def _debug(self, path: str, query: dict) -> None:
                from . import flight
                if path == "/debug/stacks":
                    self._send(200, render_stacks().encode(),
                               "text/plain; charset=utf-8")
                elif path == "/debug/dump":
                    rec = flight.recorder()
                    if rec is None:
                        self._send_json(503, {
                            "error": "no flight recorder configured "
                                     "(--flight-events 0?)"})
                        return
                    bundle = rec.freeze("debug_dump")
                    if query.get("publish", ["0"])[0] not in ("0", ""):
                        rec.publish(bundle)
                    self._send_json(200, bundle)
                elif path == "/debug/profile":
                    try:
                        ms = float(query.get("ms", ["500"])[0])
                    except ValueError:
                        self._send_json(400, {"error": "ms must be a "
                                                       "number"})
                        return
                    pdir = exporter.profile_dir
                    if pdir is None:
                        import tempfile
                        pdir = exporter.profile_dir = tempfile.mkdtemp(
                            prefix="dt-debug-profile-")
                    try:
                        info = flight.capture_profile(pdir, ms)
                    except RuntimeError as e:
                        self._send_json(409, {"error": str(e)})
                        return
                    except Exception:
                        logger.exception("obs_http: profile capture "
                                         "failed")
                        self._send_json(500, {"error": "profile capture "
                                                       "failed"})
                        return
                    self._send_json(200, info)
                else:
                    self._send_json(404, {"error": "unknown debug "
                                                   "endpoint"})

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path, _, rawq = self.path.partition("?")
                if path.startswith("/debug/"):
                    self._debug(path, parse_qs(rawq))
                    return
                if path in ("/metrics", "/"):
                    try:
                        body = render(exporter.registry,
                                      exporter.fleet).encode()
                    except Exception:
                        logger.exception("obs_http: render failed")
                        self._send(500, b"render failed\n", "text/plain")
                        return
                    self._send(200, body,
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    reg = (exporter.registry if exporter.registry
                           is not None else obs.registry())
                    info = {"ok": True, "role": exporter.role,
                            "metrics": len(reg),
                            "fleet_nodes": (len(exporter.fleet.nodes)
                                            if exporter.fleet is not None
                                            else None)}
                    self._send(200, (json.dumps(info) + "\n").encode(),
                               "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"obs-http-{self.port}",
                                        daemon=True)
        self._thread.start()
        _LIVE_EXPORTERS.add(self)
        logger.info("obs exporter serving on http://%s:%d/metrics",
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
        _LIVE_EXPORTERS.discard(self)
