"""Load-aware generation router and admission controller — the port of
the JAX package's ``engine/router.py``: stdlib HTTP in, ``urllib`` out,
no model and no torch. Its JSON is the protocol: it routes to the JAX
package's serving frontends and the port's alike.

- **Spread.** ``/generate`` goes to the least-loaded healthy backend,
  scored on what each backend's ``/healthz`` reports (queue depth,
  active slots, ``ttft_ms_p95`` / ``tpot_ms_p95``, a speculating
  backend's accept rate). Backends on the majority base revision are
  preferred, so a straggler mid-swap does not answer from a stale model.
- **Shed.** When every admissible backend sits at its queue bound the
  router answers ``429`` with ``Retry-After`` at once, instead of
  queueing the caller past the knee (``router.shed``).
- **Disaggregation.** Backends declare a worker class in ``/healthz``
  (``phase=prefill|decode|unified``). With an admissible prefill and an
  admissible decode backend a request routes as two legs: ``/prefill`` on
  the prefill worker (the KV manifest ref and the first token), then
  ``/generate`` on the decode worker carrying them (engine/kv_transfer.py
  moves the pages). Either class missing, overloaded or failing mid-way
  falls back to the unified route (``router.disagg_fallbacks``), where a
  prefill worker is never a candidate.

Backend states refresh from ``/healthz`` on a poll thread; the router
holds no tokens and no KV, so killing it loses only the routing table.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils import obs, reqtrace
from . import serve as _serve

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BackendState:
    """Last-known load picture of one serving backend (from its
    ``/healthz``; ``healthy`` flips false after consecutive poll
    failures, true again on the first success)."""
    url: str
    healthy: bool = False
    queue_depth: int = 0
    active: int = 0
    tokens_per_sec: float = 0.0
    ttft_ms_p95: float = 0.0
    tpot_ms_p95: float = 0.0
    revision: str | None = None
    shed: int = 0
    spec_accept_rate: float = 0.0
    spec_k: int = 0
    # worker class (disaggregated serving): prefill | decode | unified.
    # An old backend's healthz carries no "phase" field and defaults to
    # unified — the no-flag-day negotiation: a mixed fleet keeps
    # routing every request somewhere that can serve it end to end.
    phase: str = "unified"
    kv_exported: int = 0
    kv_adopted: int = 0
    last_poll_t: float = 0.0
    consecutive_failures: int = 0

    def update(self, health: dict) -> None:
        self.healthy = bool(health.get("ok", False))
        self.queue_depth = int(health.get("queue_depth", 0))
        self.active = int(health.get("active", 0))
        self.tokens_per_sec = float(health.get("tokens_per_sec", 0.0))
        self.ttft_ms_p95 = float(health.get("ttft_ms_p95", 0.0))
        self.tpot_ms_p95 = float(health.get("tpot_ms_p95", 0.0))
        self.revision = health.get("revision")
        self.shed = int(health.get("shed", 0))
        self.spec_accept_rate = float(health.get("spec_accept_rate", 0.0))
        self.spec_k = int(health.get("spec_k", 0))
        phase = health.get("phase", "unified")
        self.phase = phase if phase in ("prefill", "decode", "unified") \
            else "unified"
        self.kv_exported = int(health.get("kv_exported", 0))
        self.kv_adopted = int(health.get("kv_adopted", 0))
        self.consecutive_failures = 0
        self.last_poll_t = time.monotonic()

    @property
    def speed_factor(self) -> float:
        """Tokens emitted per decode step: 1 for a plain backend,
        ``1 + accept_rate * K`` for a speculating one (each verify pass
        commits the accepted draft prefix plus the target's own pick).
        Defaults keep non-speculating fleets at exactly 1.0."""
        return 1.0 + max(0.0, self.spec_accept_rate) * max(0, self.spec_k)


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Pure routing decision — separated from the HTTP plumbing so the
    open-loop harness (utils/loadgen.py) and the unit tests exercise the
    exact policy the live router runs.

    ``max_queue_depth`` is the admission bound PER BACKEND: a backend
    with ``queue_depth + active`` work items at or past it is
    overloaded and not admissible. When every live backend is
    overloaded the verdict is shed (429), which is the whole point —
    bounded queues are what keep admitted-request ttft off the
    collapse curve."""

    max_queue_depth: int = 6
    shed_ttft_ms: float = 0.0    # >0: also shed on backend p95 above this
    prefer_revision: bool = True

    def overloaded(self, b: BackendState) -> bool:
        if b.queue_depth + b.active >= self.max_queue_depth > 0:
            return True
        if self.shed_ttft_ms > 0 and b.ttft_ms_p95 > self.shed_ttft_ms:
            return True
        return False

    def score(self, b: BackendState) -> float:
        """Lower is better: outstanding work dominates, observed
        latency percentiles break ties between equally-queued
        backends (a slow backend at depth 2 loses to a fast one).
        Outstanding work is divided by the backend's speculative
        speed factor — a drafting backend accepting 3 of 4 proposals
        drains its queue ~4x faster, so the same depth costs less.
        Non-speculating backends have factor 1.0 (score unchanged)."""
        return ((b.queue_depth + b.active) / b.speed_factor
                + (b.ttft_ms_p95 + b.tpot_ms_p95) / 100.0)

    def choose(self, backends: list[BackendState]) -> BackendState | None:
        """Pick the backend for one request, or None ⇒ shed."""
        live = [b for b in backends if b.healthy]
        if not live:
            return None
        pool = live
        if self.prefer_revision and len(live) > 1:
            revs = [b.revision for b in live if b.revision is not None]
            if revs:
                # majority revision wins; deterministic tie-break
                pref = max(set(revs), key=lambda r: (revs.count(r), r))
                on_pref = [b for b in live if b.revision == pref]
                # ...but never shed while an off-revision backend has room
                if any(not self.overloaded(b) for b in on_pref):
                    pool = on_pref
        admit = [b for b in pool if not self.overloaded(b)]
        if not admit:
            return None
        return min(admit, key=lambda b: (self.score(b), b.url))

    def retry_after(self, backends: list[BackendState]) -> float:
        """Seconds a shed caller should back off: the least-loaded
        backend's queue drained at its observed token rate."""
        live = [b for b in backends if b.healthy]
        if not live:
            return 1.0
        b = min(live, key=self.score)
        if b.tokens_per_sec > 0:
            est = (b.queue_depth + b.active) * 32 / b.tokens_per_sec
        else:
            est = 1.0
        return min(max(est, 1.0), 30.0)


class RouterHTTPFrontend:
    """HTTP router over N serving backends.

    - ``POST /generate`` — forwarded verbatim to the policy's chosen
      backend; on backend error / 429 / 503 the next-best backend is
      tried once before giving up. Policy shed ⇒ ``429`` +
      ``Retry-After`` without touching any backend.
    - ``GET /healthz`` — router's own view: per-backend states plus
      routed/shed counters.

    Backend states refresh on a daemon poll thread (``router-poll``);
    tests can drive :meth:`refresh` synchronously instead. Registered
    with the serve module's live-frontend set
    (``engine/serve.live_frontends``), beside the serving frontends.
    """

    def __init__(self, backend_urls: list[str], port: int = 0, *,
                 host: str = "127.0.0.1",
                 policy: RouterPolicy | None = None,
                 poll_interval_s: float = 1.0,
                 unhealthy_after: int = 3,
                 timeout_s: float = 120.0,
                 retry_after_cap_s: float = 0.25):
        if not backend_urls:
            raise ValueError("router needs at least one backend url")
        self.backends = [BackendState(url=u.rstrip("/"))
                         for u in backend_urls]
        self.policy = policy or RouterPolicy()
        self.host = host
        self.port = port
        self.poll_interval_s = poll_interval_s
        self.unhealthy_after = unhealthy_after
        self.timeout_s = timeout_s
        # how long the router is willing to honor a backend's
        # Retry-After before the next-best retry (0 disables the wait);
        # tests monkeypatch _sleep to observe without stalling
        self.retry_after_cap_s = retry_after_cap_s
        self._sleep = time.sleep
        self.routed = 0
        self.shed = 0
        self.retry_after_honored = 0
        self.disagg_routed = 0      # completed prefill->decode routes
        self.disagg_fallbacks = 0   # two-leg attempts that fell back
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- backend state ------------------------------------------------------
    def refresh(self) -> None:
        """One poll sweep over every backend's ``/healthz``."""
        for b in self.backends:
            try:
                with urllib.request.urlopen(b.url + "/healthz",
                                            timeout=2.0) as r:
                    health = json.loads(r.read().decode())
                with self._lock:
                    b.update(health)
            except (urllib.error.URLError, OSError, ValueError):
                with self._lock:
                    b.consecutive_failures += 1
                    if b.consecutive_failures >= self.unhealthy_after:
                        b.healthy = False

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.refresh()
            except Exception:
                logger.exception("router poll sweep failed")

    # -- routing ------------------------------------------------------------
    def _fetch_json(self, backend: BackendState, path: str,
                    body: bytes, request_id: str) -> dict:
        """POST one leg to one backend under optimistic in-flight
        accounting (the same active+=1 discipline the unified loop
        uses, so concurrent routes between health polls spread)."""
        with self._lock:
            backend.active += 1
        try:
            req = urllib.request.Request(
                backend.url + path, data=body,
                headers={"Content-Type": "application/json",
                         reqtrace.REQUEST_ID_HEADER: request_id})
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        finally:
            with self._lock:
                backend.active = max(0, backend.active - 1)

    def _route_disagg(self, body: bytes, request_id: str,
                      rid_hdr: dict) -> tuple[int, dict, dict] | None:
        """The two-leg disaggregated route: prefill leg on a
        prefill-phase worker (``/prefill`` → kv_ref + first_token),
        decode leg on a decode-phase worker (``/generate`` with the
        manifest ref merged into the body). Returns the completed
        response, or None ⇒ fall back to the unified loop — taken
        whenever EITHER class has no admissible backend or either leg
        fails for any reason (the fallback matrix: mixed fleets, an
        unhealthy class, a failed export, a mid-flight error all
        degrade to the classic single-worker route, counted)."""
        with self._lock:
            pre = self.policy.choose(
                [b for b in self.backends if b.phase == "prefill"])
            dec = self.policy.choose(
                [b for b in self.backends if b.phase == "decode"])
        if pre is None or dec is None:
            return None
        try:
            leg1 = self._fetch_json(pre, "/prefill", body, request_id)
            if not leg1.get("kv_ref") or leg1.get("first_token") is None:
                # export failed on the worker (already counted there):
                # a unified worker can still serve the request whole
                raise ValueError("prefill leg returned no kv_ref")
            payload = json.loads(body or b"{}")
            payload["kv_ref"] = leg1["kv_ref"]
            payload["first_token"] = leg1["first_token"]
            out = self._fetch_json(dec, "/generate",
                                   json.dumps(payload).encode(),
                                   request_id)
        except Exception:
            obs.count("router.disagg_fallbacks")
            with self._lock:
                self.disagg_fallbacks += 1
            logger.info("disaggregated route failed (prefill=%s "
                        "decode=%s); falling back to unified",
                        pre.url, dec.url, exc_info=True)
            return None
        with self._lock:
            self.routed += 1
            self.disagg_routed += 1
        obs.count("router.routed")
        obs.count("router.disagg_routed")
        out["backend"] = dec.url
        out["prefill_backend"] = pre.url
        out.setdefault("request_id", request_id)
        return 200, out, dict(rid_hdr)

    def _route(self, body: bytes,
               request_id: str | None = None) -> tuple[int, dict, dict]:
        """Forward one /generate body. Returns (code, obj, headers).

        ``request_id`` is the caller's ``X-DT-Request-Id`` (minted here
        from the body when absent — the router is the outermost
        frontend, so the identity every downstream trace stage carries
        is born at this line); it is forwarded to every backend tried
        and echoed on every outcome, including the router's own shed."""
        obs.count("router.requests")
        request_id = request_id or reqtrace.mint_request_id(body)
        rid_hdr = {reqtrace.REQUEST_ID_HEADER: request_id}
        routed = self._route_disagg(body, request_id, rid_hdr)
        if routed is not None:
            return routed
        with self._lock:
            # unified / fallback leg: prefill-phase workers cannot
            # serve /generate end to end, everything else can (a
            # decode worker degrades to local prefill)
            states = [b for b in self.backends if b.phase != "prefill"]
            chosen = self.policy.choose(states)
        tried: set[str] = set()
        while chosen is not None:
            tried.add(chosen.url)
            with self._lock:
                # optimistic in-flight accounting so concurrent routes
                # between health polls don't all pile onto one backend
                chosen.active += 1
            try:
                req = urllib.request.Request(
                    chosen.url + "/generate", data=body,
                    headers={"Content-Type": "application/json",
                             reqtrace.REQUEST_ID_HEADER: request_id})
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as r:
                        out = json.loads(r.read().decode())
                finally:
                    with self._lock:
                        chosen.active = max(0, chosen.active - 1)
                with self._lock:
                    self.routed += 1
                obs.count("router.routed")
                out["backend"] = chosen.url
                out.setdefault("request_id", request_id)
                return 200, out, dict(rid_hdr)
            except urllib.error.HTTPError as e:
                code = e.code
                try:
                    payload = json.loads(e.read().decode())
                except Exception:
                    payload = {"error": str(e)}
                if code not in (429, 503):
                    # backend answered with a real verdict (400/504/...):
                    # relay it, retrying elsewhere would double-generate
                    return code, payload, dict(rid_hdr)
                obs.count("router.backend_errors")
                retry_after = (e.headers or {}).get("Retry-After")
                with self._lock:
                    # the backend told us it is saturated; trust it
                    # until the next poll sweep says otherwise
                    chosen.queue_depth = max(chosen.queue_depth,
                                             self.policy.max_queue_depth)
                if retry_after is not None and self.retry_after_cap_s > 0:
                    # honor the backend's own back-pressure signal
                    # before piling onto the next-best backend — capped,
                    # so one saturated server never stalls the router
                    try:
                        wait = min(float(retry_after),
                                   self.retry_after_cap_s)
                    except ValueError:
                        wait = 0.0
                    if wait > 0:
                        with self._lock:
                            self.retry_after_honored += 1
                        obs.count("router.retry_after_honored")
                        self._sleep(wait)
            except (urllib.error.URLError, OSError, ValueError):
                obs.count("router.backend_errors")
                with self._lock:
                    chosen.consecutive_failures += 1
                    if chosen.consecutive_failures >= self.unhealthy_after:
                        chosen.healthy = False
            with self._lock:
                remaining = [b for b in self.backends
                             if b.url not in tried
                             and b.phase != "prefill"]
                chosen = self.policy.choose(remaining)
        with self._lock:
            self.shed += 1
            retry = self.policy.retry_after(list(self.backends))
        obs.count("router.shed")
        return 429, {"error": "all backends overloaded",
                     "retry_after_s": retry,
                     "request_id": request_id}, \
            {"Retry-After": str(max(1, int(retry))), **rid_hdr}

    # -- http ---------------------------------------------------------------
    def start(self) -> int:
        if self._server is not None:
            return self.port
        fe = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("router_http: " + fmt, *args)

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

            def do_GET(self):  # noqa: N802
                if self.path.split("?", 1)[0] == "/healthz":
                    with fe._lock:
                        out = {
                            "ok": True, "role": "router",
                            "routed": fe.routed, "shed": fe.shed,
                            "retry_after_honored":
                                fe.retry_after_honored,
                            "disagg_routed": fe.disagg_routed,
                            "disagg_fallbacks": fe.disagg_fallbacks,
                            "backends": [dataclasses.asdict(b)
                                         for b in fe.backends]}
                    self._send(200, out)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                if self.path.split("?", 1)[0] != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) or b"{}"
                code, obj, headers = fe._route(
                    body, self.headers.get(reqtrace.REQUEST_ID_HEADER))
                self._send(code, obj, headers)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"router-http-{self.port}",
                                        daemon=True)
        self._thread.start()
        self.refresh()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="router-poll", daemon=True)
        self._poller.start()
        _serve._LIVE_FRONTENDS.add(self)
        logger.info("routing /generate across %d backends on http://%s:%d",
                    len(self.backends), self.host, self.port)
        return self.port

    @property
    def running(self) -> bool:
        return self._server is not None

    def close(self) -> None:
        self._stop.set()
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        poller, self._poller = self._poller, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        if poller is not None:
            poller.join(timeout=5.0)
        _serve._LIVE_FRONTENDS.discard(self)
