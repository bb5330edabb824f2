"""Fleet health plane — the port of the JAX package's
``engine/health.py``: transport-published heartbeats, the per-node
contribution ledger, declarative SLO rules, and serving burn-rate
alerting.

- every role publishes a compact, versioned **heartbeat**
  (:class:`HeartbeatPublisher`) on the delta-meta rider channel under
  the reserved ``__hb__.<role>.<hotkey>`` id (``transport/base.
  heartbeat_id``): collected on its own daemon timer thread from host
  values (``Vitals``: report counters, ``last_loss`` as a host float,
  the allocator's memory numbers; never a device read), uploaded by a
  depth-1 ``PublishWorker`` so a beat still in flight is superseded,
  never queued. The body's bytes are the JAX package's, so a fleet of
  port and JAX roles shares one store.
- the delta-consuming roles run a :class:`FleetMonitor`: one
  ``poll(hotkeys)`` an observation round folds fresh beats into
  :class:`NodeHealth` records, the role's staging observer folds its
  own accept/decline decisions in (the contribution ledger), and
  ``evaluate_slos`` judges :class:`SLORule` s (stale node, loss
  divergence from the fleet median, push-failure streak, step-rate
  collapse) once a round. A breach fires once per (node, rule): a
  counter ``fleet.slo.<rule>``, a flight record and frozen bundle, an
  ``{"slo_breach": ...}`` sink record, and the anomaly monitor.
- the serving burn-rate part (``BurnRule``, ``BurnRateMonitor``) judges
  every request outcome of the request-trace stream over sliding
  windows (below).

Heartbeat contents are PEER-CONTROLLED: producers lint field names
(``[a-z0-9_.]+``) and cap the encoded size; ``parse_heartbeat``
re-validates every field and drops what does not conform. Health-plane
failures are logged and counted, never raised into a round.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import statistics
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Iterable, Sequence

from ..transport.base import META_MAX_BYTES, heartbeat_id
from ..utils import flight, obs
from ..utils.metrics import device_memory_watermarks

logger = logging.getLogger(__name__)

HEARTBEAT_VERSION = 1

# the versioned schema: field -> (kind, description). ``kind`` is "str"
# or "num"; consumers drop non-conforming values, docs/observability.md
# renders this table. Producers may add extra NUMERIC fields (linted
# names) — consumers keep them, reports show what they know.
HEARTBEAT_FIELDS: dict[str, tuple[str, str]] = {
    "hb": ("num", f"schema version (currently {HEARTBEAT_VERSION})"),
    "role": ("str", "publishing role: miner | validator | averager"),
    "hotkey": ("str", "publishing hotkey"),
    "t": ("num", "publisher wall-clock at collection (unix seconds)"),
    "seq": ("num", "monotonic per-process beat sequence"),
    "base_revision": ("str", "base-model revision the node is tracking"),
    "steps": ("num", "lifetime train steps (miner) / rounds (others)"),
    "step_rate": ("num", "steps per second over the last beat interval"),
    "loss_ema": ("num", "EMA of the node's own loss signal"),
    "pushes": ("num", "deltas published (MinerReport.pushes)"),
    "pushes_failed": ("num", "publishes whose retries exhausted"),
    "rounds": ("num", "validation/averaging rounds completed"),
    "last_accepted": ("num", "deltas accepted into the last merge"),
    "last_rejected": ("num", "deltas rejected at the last gather"),
    "registry_digest": ("str", "obs registry vocabulary digest "
                               "(version-drift detection)"),
    "mem_in_use_bytes": ("num", "max per-device HBM bytes in use"),
    "mem_peak_bytes": ("num", "max per-device HBM high-water mark"),
    "phase": ("str", "serving worker class: unified | prefill | decode"),
    "kv_exported": ("num", "KV page-set manifests exported "
                           "(prefill-phase serving worker)"),
    "kv_adopted": ("num", "KV page-set manifests adopted "
                          "(decode-phase serving worker)"),
}

_MAX_STR = 200
_MAX_EXTRA_FIELDS = 32


def build_heartbeat(role: str, hotkey: str, seq: int, *, now: float,
                    **fields) -> dict:
    """Assemble one heartbeat body. Producer-side lint: every field name
    must pass the registry name lint (the same ``[a-z0-9_.]+`` rule as
    metric names — heartbeats feed reports and exporters, so a field
    that cannot be a metric name must fail HERE, at the producer, not
    parse-time at every consumer)."""
    hb: dict[str, Any] = {"hb": HEARTBEAT_VERSION, "role": role,
                          "hotkey": hotkey, "t": float(now),
                          "seq": int(seq)}
    for k, v in fields.items():
        obs.check_metric_name(k)
        if v is None:
            continue
        hb[k] = v if isinstance(v, str) else float(v)
    return hb


def parse_heartbeat(meta) -> dict | None:
    """Defensive read of a PEER-CONTROLLED heartbeat rider (the dict the
    transport's ``fetch_delta_meta`` returned, already size-capped by
    parse_delta_meta). Returns a normalized dict or None; non-conforming
    fields are dropped, never raised on."""
    if not isinstance(meta, dict):
        return None
    v = meta.get("hb")
    if not isinstance(v, (int, float)) or int(v) < 1:
        return None  # not a heartbeat (e.g. a plain delta rider)
    role, hotkey = meta.get("role"), meta.get("hotkey")
    if not (isinstance(role, str) and 0 < len(role) <= _MAX_STR):
        return None
    if not (isinstance(hotkey, str) and 0 < len(hotkey) <= _MAX_STR):
        return None
    out: dict[str, Any] = {"hb": int(v), "role": role, "hotkey": hotkey}
    extras = 0
    for k, val in meta.items():
        if k in out:
            continue
        try:
            obs.check_metric_name(k)
        except ValueError:
            continue
        kind = HEARTBEAT_FIELDS.get(k, (None,))[0]
        if isinstance(val, str) and kind != "num":
            if len(val) <= _MAX_STR:
                out[k] = val
        elif isinstance(val, (int, float)) and kind != "str":
            out[k] = float(val)
        else:
            continue
        if k not in HEARTBEAT_FIELDS:
            extras += 1
            if extras > _MAX_EXTRA_FIELDS:
                out.pop(k, None)
    if not isinstance(out.get("seq"), float):
        return None
    out["seq"] = int(out["seq"])
    if not isinstance(out.get("t"), float):
        out["t"] = 0.0
    return out


# ---------------------------------------------------------------------------
# Vitals: what a role reports about itself
# ---------------------------------------------------------------------------

class Vitals:
    """Derives a heartbeat body from zero-arg suppliers: ``steps`` (a
    lifetime step/round counter — the step RATE is computed here from
    consecutive samples), ``loss`` (latest loss; the EMA lives here so a
    noisy sample cannot whipsaw fleet-median comparisons), ``counters``
    (a numeric dict, e.g. from a MinerReport), ``base_revision``. The
    registry digest, device memory watermarks and the device
    observatory's ``anat.*`` step anatomy (``utils/devprof.anatomy``:
    host-blocked vs device vs data-wait, while the observatory is on)
    ride along automatically."""

    def __init__(self, *, steps: Callable[[], float] | None = None,
                 loss: Callable[[], float] | None = None,
                 counters: Callable[[], dict] | None = None,
                 base_revision: Callable[[], str | None] | None = None,
                 ema_alpha: float = 0.2,
                 clock=None):
        from .scheduler import RealClock
        self._steps = steps
        self._loss = loss
        self._counters = counters
        self._base_revision = base_revision
        self._ema_alpha = ema_alpha
        self._clock = clock or RealClock()
        self._last_steps: float | None = None
        self._last_t: float | None = None
        self._loss_ema: float | None = None

    def collect(self) -> dict:
        now = self._clock.now()
        body: dict[str, Any] = {}
        if self._steps is not None:
            steps = float(self._steps())
            body["steps"] = steps
            if self._last_t is not None and now > self._last_t:
                body["step_rate"] = max(
                    0.0, (steps - self._last_steps) / (now - self._last_t))
            self._last_steps, self._last_t = steps, now
        if self._loss is not None:
            loss = self._loss()
            if loss is not None and math.isfinite(float(loss)):
                loss = float(loss)
                self._loss_ema = loss if self._loss_ema is None else (
                    self._loss_ema
                    + self._ema_alpha * (loss - self._loss_ema))
            if self._loss_ema is not None:
                body["loss_ema"] = self._loss_ema
        if self._counters is not None:
            for k, v in self._counters().items():
                if v is None:
                    continue
                if isinstance(v, str):
                    # string extras (e.g. a serving worker's phase) ride
                    # the same path build_heartbeat already allows
                    body[k] = v[:_MAX_STR]
                elif math.isfinite(float(v)):
                    body[k] = float(v)
        if self._base_revision is not None:
            rev = self._base_revision()
            if isinstance(rev, str) and rev:
                body["base_revision"] = rev[:_MAX_STR]
        body["registry_digest"] = obs.registry_digest()
        body.update(device_memory_watermarks())
        try:
            # step-time anatomy: numeric anat.* extras, so older
            # consumers show what they know
            from ..utils import devprof
            body.update(devprof.anatomy())
        except Exception:
            logger.debug("heartbeat anatomy collection failed",
                         exc_info=True)
        return body


def report_vitals(report, *, base_revision=None, clock=None) -> Vitals:
    """Vitals over a role report dataclass (MinerReport, AveragerReport):
    every known numeric field becomes a heartbeat counter; ``steps``/
    ``rounds`` drives the rate; ``last_loss`` drives the EMA."""
    fields = [f for f in ("steps", "pushes", "pushes_failed",
                          "pushes_superseded", "base_pulls", "val_reverts",
                          "rounds", "last_accepted", "last_rejected",
                          "skipped_publishes")
              if hasattr(report, f)]
    step_field = "steps" if hasattr(report, "steps") else (
        "rounds" if hasattr(report, "rounds") else None)
    return Vitals(
        steps=(lambda: getattr(report, step_field))
        if step_field else None,
        loss=(lambda: getattr(report, "last_loss"))
        if hasattr(report, "last_loss") else None,
        counters=lambda: {f: getattr(report, f) for f in fields},
        base_revision=base_revision, clock=clock)


# ---------------------------------------------------------------------------
# The publisher
# ---------------------------------------------------------------------------

class HeartbeatPublisher:
    """Periodic background heartbeat publication for one (role, hotkey).

    A daemon TIMER thread (named ``heartbeat-<role>-<hotkey>``) wakes
    every ``interval`` seconds, collects the vitals on ITS thread (cheap,
    host-side — the training loop never stalls for a beat), and hands
    the upload to a depth-1 :class:`~.publish.PublishWorker`: transport
    latency lives on the worker, and a beat still uploading when the
    next fires is superseded. Publish failures are counted and logged,
    never raised — a flaky transport degrades the health plane, not the
    role."""

    def __init__(self, transport, role: str, hotkey: str, *,
                 interval: float = 60.0, vitals: Vitals | None = None,
                 collect: Callable[[], dict] | None = None,
                 clock=None):
        from .publish import PublishWorker
        from .scheduler import RealClock
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.transport = transport
        self.role = role
        self.hotkey = hotkey
        self.interval = interval
        self.node_id = heartbeat_id(role, hotkey)
        # public + late-bindable: role entry points construct the plane
        # before the loop whose report the vitals read, then bind here
        self.vitals = vitals
        self._collect = collect
        self._clock = clock or RealClock()
        self._worker = PublishWorker(
            name=f"heartbeat-upload-{hotkey}", depth=1,
            counter_prefix="health")
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.seq = 0
        self.sent = 0
        self.failed = 0
        self._warned_no_channel = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "HeartbeatPublisher":
        """Start the timer thread (idempotent). The first beat fires
        immediately so a fresh node is visible within one poll, not one
        interval."""
        with self._lock:
            if self._thread is not None or self._stop.is_set():
                return self
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"heartbeat-{self.role}-{self.hotkey}")
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            self._submit_beat()
            if self._stop.wait(self.interval):
                return

    def _submit_beat(self) -> None:
        try:
            body = self._body()
        except Exception:
            logger.exception("heartbeat %s: vitals collection failed",
                             self.node_id)
            return
        self._worker.submit(lambda: self._publish(body))

    def _body(self) -> dict:
        self.seq += 1
        fields: dict[str, Any] = {}
        if self.vitals is not None:
            fields.update(self.vitals.collect())
        if self._collect is not None:
            fields.update(self._collect())
        return build_heartbeat(self.role, self.hotkey, self.seq,
                               now=self._clock.now(), **fields)

    def _publish(self, body: dict) -> None:
        pm = getattr(self.transport, "publish_delta_meta", None)
        if pm is None:
            if not self._warned_no_channel:
                self._warned_no_channel = True
                logger.warning(
                    "heartbeat %s: transport has no rider channel; "
                    "health plane is publish-disabled", self.node_id)
            return
        import json as _json
        if len(_json.dumps(body)) > META_MAX_BYTES:
            # never ship a rider the size cap would make unreadable
            logger.warning("heartbeat %s: body exceeds %d bytes, dropped",
                           self.node_id, META_MAX_BYTES)
            return
        try:
            with obs.span("health.beat", hotkey=self.hotkey):
                pm(self.node_id, body)
            self.sent += 1
            obs.count("health.beats")
            # flight ring: the LAST beats this node managed to send are
            # exactly what a postmortem of its death wants to show
            flight.record("heartbeat", role=self.role, hotkey=self.hotkey,
                          seq=body.get("seq", 0), sent=True)
        except Exception:
            self.failed += 1
            obs.count("health.beat_failures")
            logger.warning("heartbeat %s: publish failed", self.node_id,
                           exc_info=True)

    def beat_now(self, *, wait: bool = True,
                 timeout: float | None = 5.0) -> None:
        """Collect and publish one beat immediately (loop flush / final
        state before shutdown). ``wait`` drains the upload."""
        self._submit_beat()
        if wait:
            self._worker.flush(timeout=timeout)

    def flush(self, timeout: float | None = 5.0) -> bool:
        return self._worker.flush(timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the timer, drain in-flight uploads. Idempotent."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)
        self._worker.close(timeout=timeout)


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeHealth:
    """One node's folded heartbeat state + contribution ledger entry."""
    role: str
    hotkey: str
    # ledger tier: "miner" for ordinary submissions, "agg" when the
    # staged artifact is a sub-averager's partial aggregate
    # (transport/base.__agg__.* — engine/hier_average.py), so the
    # fleet_report table tells aggregates from miner deltas at a glance
    tier: str = "miner"
    # -- heartbeat-derived ---------------------------------------------------
    beats: int = 0                      # distinct sequences observed
    seq: int = -1
    t: float = 0.0                      # publisher's own clock at last beat
    last_seen_wall: float | None = None  # monitor clock at last fresh beat
    last_seen_round: int | None = None
    steps: float = 0.0
    step_rate: float = 0.0
    peak_step_rate: float = 0.0
    loss_ema: float = float("nan")
    pushes: float = 0.0
    pushes_failed: float = 0.0
    push_fail_streak: float = 0.0       # derived across beats
    base_revision: str | None = None
    registry_digest: str | None = None
    mem_peak_bytes: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)
    # -- contribution ledger (this role's own staging/merge decisions) ------
    published: int = 0                  # distinct delta revisions staged
    accepted: int = 0                   # deltas that entered a merge/score
    declined: int = 0                   # withheld (stale/screen/fetch error)
    last_reason: str = ""
    last_delta_revision: str | None = None
    last_accepted_round: int | None = None
    stale_rounds: int = 0               # rounds since the revision changed
    wire_bytes: int = 0                 # transport bytes this role fetched
    #                                     staging this miner (0 on cache
    #                                     hits; manifest + changed shards
    #                                     only on the v2 wire)
    score: float = float("nan")
    score_history: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32))
    # accumulated leave-one-out improvement credit across base revisions
    # (engine/lineage.py CreditLedger via FleetMonitor.record_credit) —
    # the attribution twin of ``score`` (which is per-round)
    credit: float = 0.0
    breaches: list = dataclasses.field(default_factory=list)
    # -- remediation state (engine/remediate.py owns the transitions) --------
    quarantined: bool = False           # dropped from the ingest hotkey set
    probation: bool = False             # re-admitted, still under watch
    # content-address of the postmortem bundle frozen when this node's
    # latest breach/remediation fired (utils/flight.py) — the forensic
    # pointer the remediation layer attaches to its decisions
    pm_ref: str | None = None

    def as_record(self, now: float | None = None) -> dict:
        rec = {
            "role": self.role, "hotkey": self.hotkey, "tier": self.tier,
            "beats": self.beats,
            "seq": self.seq, "steps": self.steps,
            "step_rate": round(self.step_rate, 4),
            "loss_ema": self.loss_ema, "pushes": self.pushes,
            "pushes_failed": self.pushes_failed,
            "base_revision": self.base_revision,
            "registry_digest": self.registry_digest,
            "published": self.published, "accepted": self.accepted,
            "declined": self.declined, "last_reason": self.last_reason,
            "stale_rounds": self.stale_rounds,
            "wire_bytes": self.wire_bytes, "score": self.score,
            "credit": round(self.credit, 8),
            "breaches": list(self.breaches),
            # numeric so the exporter can serve dt_fleet_quarantined
            "quarantined": int(self.quarantined),
            "probation": int(self.probation),
        }
        if self.mem_peak_bytes:
            rec["mem_peak_bytes"] = self.mem_peak_bytes
        if self.pm_ref:
            rec["pm_ref"] = self.pm_ref
        if now is not None and self.last_seen_wall is not None:
            rec["last_seen_age_s"] = round(now - self.last_seen_wall, 3)
        # producer extras (already name-linted + type-screened by
        # parse_heartbeat) ride into the ledger record without clobbering
        # schema fields — the server's tokens_per_sec/queue_depth reach
        # fleet_report's tok_s column through here
        for k, v in self.extra.items():
            rec.setdefault(k, v)
        return rec


# ---------------------------------------------------------------------------
# SLO rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLORule:
    """One declarative service-level objective.

    Kinds (the vocabulary; docs/observability.md):

    - ``stale``: no fresh heartbeat for more than ``threshold``
      observation rounds (a killed or wedged node).
    - ``loss_divergence``: the node's ``loss_ema`` exceeds
      ``factor`` x the fleet median AND sits more than ``threshold``
      above it (needs >= 3 reporting nodes — a two-node fleet has no
      meaningful median).
    - ``push_failures``: ``threshold`` consecutive failed pushes with no
      success in between, derived from heartbeat counter deltas (the
      fleet-level twin of AnomalyMonitor's local streak rule).
    - ``step_rate_collapse``: the node's step rate fell below
      ``factor`` x its own observed peak (after ``warmup`` beats —
      a cold start is not a collapse).
    """
    name: str
    kind: str
    threshold: float
    factor: float = 1.0
    warmup: int = 3

    _KINDS = ("stale", "loss_divergence", "push_failures",
              "step_rate_collapse")

    def __post_init__(self):
        obs.check_metric_name(self.name)
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {self._KINDS}")

    def evaluate(self, node: NodeHealth, *, round_num: int,
                 fleet_median_loss: float | None) -> str | None:
        """Breach detail string, or None when within objective."""
        if node.beats < 1:
            return None  # never-seen nodes are absent, not breaching
        if self.kind == "stale":
            last = node.last_seen_round
            if last is not None and round_num - last > self.threshold:
                return (f"no heartbeat for {round_num - last} rounds "
                        f"(> {self.threshold:g})")
            return None
        if self.kind == "loss_divergence":
            if (fleet_median_loss is None
                    or not math.isfinite(node.loss_ema)):
                return None
            if (node.loss_ema > fleet_median_loss * self.factor
                    and node.loss_ema - fleet_median_loss > self.threshold):
                return (f"loss_ema {node.loss_ema:.4g} vs fleet median "
                        f"{fleet_median_loss:.4g}")
            return None
        if self.kind == "push_failures":
            if node.push_fail_streak >= self.threshold:
                return f"{node.push_fail_streak:g} consecutive failed pushes"
            return None
        # step_rate_collapse
        if (node.beats >= self.warmup and node.peak_step_rate > 0
                and node.step_rate < self.factor * node.peak_step_rate):
            return (f"step_rate {node.step_rate:.4g} < {self.factor:g} x "
                    f"peak {node.peak_step_rate:.4g}")
        return None


def default_slo_rules() -> tuple[SLORule, ...]:
    """The default objectives (docs/observability.md documents each)."""
    return (
        SLORule("stale_node", "stale", threshold=3),
        SLORule("loss_divergence", "loss_divergence", threshold=0.5,
                factor=1.5),
        SLORule("push_failure_streak", "push_failures", threshold=3),
        SLORule("step_rate_collapse", "step_rate_collapse", threshold=0.0,
                factor=0.25, warmup=3),
    )


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------

class FleetMonitor:
    """Aggregates heartbeats + this role's own merge/score decisions into
    the contribution ledger, and evaluates the SLO rules each round.

    ``poll(hotkeys)`` is ONE observation round: heartbeat riders for
    every (role, hotkey) pair are fetched concurrently (the ingest
    pool's daemon threads — transport latency overlaps across nodes) and
    folded in; each fresh heartbeat is also logged through ``metrics``
    as an ``{"heartbeat": ...}`` record, which is what
    scripts/fleet_report.py joins offline. Staleness is measured in
    observation ROUNDS, so the verdicts are cadence-relative rather than
    wall-clock-relative (a slow averaging cadence must not mark the
    whole fleet stale).

    Breaches fire ONCE per (node, rule) per monitor lifetime; the first
    breach of any kind arms ``anomaly`` (AnomalyMonitor.trigger_external
    — the same one-shot TraceCapture budget as the local detectors).

    Pod discipline: the monitor issues plain transport READS and no
    collectives; a world of several processes runs it on the coordinator
    only (``neurons/common.build_health_plane``), which broadcasts what
    the ranks must agree on (the validator's cohort size and exclusion
    set).
    """

    # servers (neurons/server.py) heartbeat like every other role; the
    # monitor polls them alongside miners so the fleet table shows the
    # served revision next to the trained/merged ones (a hotkey running
    # no server simply yields no rider under that reserved id)
    def __init__(self, transport, *,
                 roles: Sequence[str] = ("miner", "server"),
                 rules: Sequence[SLORule] | None = None,
                 anomaly=None, metrics=None, clock=None, workers: int = 4):
        from .ingest import IngestPool
        from .scheduler import RealClock
        self.transport = transport
        self.roles = tuple(roles)
        self.rules = tuple(rules if rules is not None
                           else default_slo_rules())
        self.anomaly = anomaly
        self.metrics = metrics
        self.clock = clock or RealClock()
        self.pool = IngestPool(workers)
        self.nodes: dict[tuple[str, str], NodeHealth] = {}
        self.round = 0
        self._fired: set[tuple[str, str, str]] = set()
        # the ledger is read/written across threads: the validator's
        # staging observer runs on the cohort stager thread while the
        # HTTP exporter renders ledger() from its handler threads
        self._lock = threading.RLock()

    def close(self) -> None:
        self.pool.close()

    # -- heartbeat ingestion -------------------------------------------------
    def node(self, role: str, hotkey: str) -> NodeHealth:
        key = (role, hotkey)
        n = self.nodes.get(key)
        if n is None:
            from ..transport.base import is_agg_id
            n = self.nodes[key] = NodeHealth(
                role=role, hotkey=hotkey,
                tier="agg" if is_agg_id(hotkey) else "miner")
        return n

    def _fetch(self, key: tuple[str, str]) -> dict | None:
        fm = getattr(self.transport, "fetch_delta_meta", None)
        if fm is None:
            return None
        try:
            return parse_heartbeat(fm(heartbeat_id(*key)))
        except Exception:
            obs.count("fleet.fetch_errors")
            logger.warning("fleet: heartbeat fetch failed for %s", key,
                           exc_info=True)
            return None

    def poll(self, hotkeys: Iterable[str], *,
             roles: Sequence[str] | None = None) -> int:
        """One observation round over ``hotkeys`` x ``roles``; returns how
        many FRESH heartbeats (new sequence numbers) were folded in.

        ``hotkeys`` is the chain registry's CURRENT view, so it doubles as
        the ledger's membership list: entries for (polled-role, hotkey)
        pairs that are no longer registered are PRUNED — a deregistered
        node would otherwise accumulate forever and keep skewing
        ``fleet_median_loss`` with its final loss_ema. Pruned records are
        tagged into the flush sink (``{"fleet_pruned": ...}``) so the
        node's last ledger state survives in the JSONL stream even though
        the live ledger forgets it."""
        self.round += 1
        active_roles = tuple(roles or self.roles)
        active = set(dict.fromkeys(hotkeys))
        keys = [(role, h) for role in active_roles for h in active]
        with obs.span("fleet.poll", nodes=len(keys)):
            beats = self.pool.map(self._fetch, keys)
        fresh = 0
        with self._lock:
            for key, hb in zip(keys, beats):
                if hb is None:
                    continue
                if self._ingest(key, hb):
                    fresh += 1
            pruned = self._prune_locked(active, active_roles)
        for rec in pruned:
            obs.count("fleet.pruned")
            logger.info("fleet: pruned %s/%s (left the chain registry)",
                        rec["role"], rec["hotkey"])
            if self.metrics is not None:
                try:
                    self.metrics.log({"fleet_pruned": rec,
                                      "fleet_round": self.round})
                except Exception:
                    logger.exception("fleet: prune sink emit failed")
        obs.count("fleet.polls")
        obs.gauge("fleet.nodes", float(sum(1 for n in self.nodes.values()
                                           if n.beats > 0)))
        return fresh

    def _prune_locked(self, active: set, roles: Sequence[str]) -> list[dict]:
        """Drop ledger entries (and their fired-breach memory) for hotkeys
        the registry no longer lists. Only roles THIS poll covered are
        pruned — an averager-role entry must not vanish because a
        miner-only poll didn't name it."""
        now = self.clock.now()
        gone = [k for k, n in self.nodes.items()
                if k[0] in roles and k[1] not in active]
        records = []
        for key in gone:
            records.append(self.nodes.pop(key).as_record(now))
            self._fired = {f for f in self._fired if (f[0], f[1]) != key}
        return records

    def _ingest(self, key: tuple[str, str], hb: dict) -> bool:
        node = self.node(*key)
        if hb["seq"] == node.seq:
            return False  # same beat as last round: the node went quiet
        prev_pushes, prev_failed = node.pushes, node.pushes_failed
        had_beats = node.beats > 0
        node.beats += 1
        node.seq = hb["seq"]
        node.t = hb.get("t", 0.0)
        node.last_seen_wall = self.clock.now()
        node.last_seen_round = self.round
        node.steps = hb.get("steps", node.steps)
        node.step_rate = hb.get("step_rate", 0.0)
        node.peak_step_rate = max(node.peak_step_rate, node.step_rate)
        node.loss_ema = hb.get("loss_ema", float("nan"))
        node.pushes = hb.get("pushes", node.pushes)
        node.pushes_failed = hb.get("pushes_failed", node.pushes_failed)
        node.base_revision = hb.get("base_revision", node.base_revision)
        node.registry_digest = hb.get("registry_digest",
                                      node.registry_digest)
        node.mem_peak_bytes = hb.get("mem_peak_bytes", node.mem_peak_bytes)
        node.extra = {k: v for k, v in hb.items()
                      if k not in HEARTBEAT_FIELDS}
        # failure-streak derivation (counter deltas, like
        # AnomalyMonitor.observe_push_counters): successes reset it
        if had_beats:
            if node.pushes > prev_pushes:
                node.push_fail_streak = 0
            if node.pushes_failed > prev_failed:
                node.push_fail_streak += node.pushes_failed - prev_failed
        obs.count("fleet.heartbeats")
        flight.record("heartbeat", role=key[0], hotkey=key[1],
                      seq=hb["seq"], observed=True)
        if self.metrics is not None:
            try:
                self.metrics.log({"heartbeat": dict(hb),
                                  "observed_round": self.round})
            except Exception:
                logger.exception("fleet: heartbeat sink emit failed")
        return True

    # -- contribution ledger -------------------------------------------------
    def record_staging(self, staged: Iterable) -> None:
        """Fold one gather's ``StagedDelta`` outcomes (engine/ingest.py)
        into the ledger — called by the role that made the decisions, so
        accepted/declined counts ARE the merge decisions, not an
        inference. Hotkeys with no submission and no history stay out of
        the ledger (validator hotkeys never publish deltas)."""
        with self._lock:
            self._record_staging_locked(staged)

    def _record_staging_locked(self, staged: Iterable) -> None:
        for s in staged:
            key = ("miner", s.hotkey)
            if s.revision is None and key not in self.nodes \
                    and s.reason == "no_delta":
                continue
            node = self.node(*key)
            if s.revision is not None \
                    and s.revision != node.last_delta_revision:
                node.published += 1
                node.last_delta_revision = s.revision
                node.stale_rounds = 0
            else:
                node.stale_rounds += 1
            node.last_reason = s.reason
            # transport cost attribution: what staging this miner's
            # submissions actually pulled over the wire (the per-miner
            # half of the wire.* registry counters)
            node.wire_bytes += int(getattr(s, "wire_bytes", 0) or 0)
            if s.delta is not None:
                node.accepted += 1
                node.last_accepted_round = self.round
            elif s.reason != "no_delta":
                node.declined += 1

    def record_scores(self, scores: dict[str, float]) -> None:
        """Fold a validation round's per-hotkey scores (score history).
        Only ACTIVE nodes get ledger rows: a validator scores every
        metagraph hotkey (zero for the absent ones), and folding all ~100
        of those in would bloat the ledger — and the exporter's label
        space — with never-seen identities."""
        with self._lock:
            for hotkey, score in scores.items():
                if ("miner", hotkey) not in self.nodes and not score:
                    continue
                node = self.node("miner", hotkey)
                node.score = float(score)
                node.score_history.append(float(score))

    def record_credit(self, credits: dict[str, float]) -> None:
        """Fold the credit ledger's accumulated per-hotkey totals
        (engine/lineage.py CreditLedger.totals) into the contribution
        ledger. Same active-node rule as :meth:`record_scores`: a
        never-seen hotkey with zero credit gets no row."""
        with self._lock:
            for hotkey, credit in credits.items():
                if ("miner", hotkey) not in self.nodes and not credit:
                    continue
                self.node("miner", hotkey).credit = float(credit)

    def clear_fired(self, role: str, hotkey: str,
                    rule: str | None = None) -> None:
        """Re-arm breach firing for a node (one rule, or all of them).
        Breaches are one-shot per (node, rule) per monitor lifetime; the
        remediation layer clears them when it re-admits a quarantined
        node, so a RELAPSE can breach — and be quarantined — again."""
        with self._lock:
            self._fired = {f for f in self._fired
                           if not (f[0] == role and f[1] == hotkey
                                   and (rule is None or f[2] == rule))}
            node = self.nodes.get((role, hotkey))
            if node is not None:
                node.breaches = [b for b in node.breaches
                                 if rule is not None and b != rule]

    # -- SLO evaluation ------------------------------------------------------
    def fleet_median_loss(self) -> float | None:
        losses = [n.loss_ema for n in self.nodes.values()
                  if n.beats > 0 and math.isfinite(n.loss_ema)]
        if len(losses) < 3:
            return None
        return float(statistics.median(losses))

    def evaluate_slos(self) -> list[dict]:
        """Evaluate every rule against every node; returns this call's NEW
        breaches. Each (node, rule) pair fires once per monitor lifetime;
        the first breach overall arms the AnomalyMonitor one-shot."""
        with self._lock:
            median = self.fleet_median_loss()
            node_list = list(self.nodes.values())
        breaches = []
        for node in node_list:
            for rule in self.rules:
                fired_key = (node.role, node.hotkey, rule.name)
                if fired_key in self._fired:
                    continue
                detail = rule.evaluate(node, round_num=self.round,
                                       fleet_median_loss=median)
                if detail is None:
                    continue
                self._fired.add(fired_key)
                node.breaches.append(rule.name)
                rec = {"slo_breach": rule.name, "role": node.role,
                       "hotkey": node.hotkey, "detail": detail,
                       "round": self.round}
                obs.count(f"fleet.slo.{rule.name}")
                logger.warning("SLO breach: %s on %s/%s — %s", rule.name,
                               node.role, node.hotkey, detail)
                # postmortem trigger: record the breach into the flight
                # ring FIRST (so the frozen bundle names it), then freeze
                # + publish — the bundle_id is the reference every
                # downstream consumer (ledger, remediation, reports)
                # attaches to this breach
                flight.record("slo", rule=rule.name, role=node.role,
                              hotkey=node.hotkey, detail=detail,
                              round=self.round)
                ref = flight.freeze_and_publish(f"slo_{rule.name}")
                if ref:
                    rec["pm_ref"] = ref
                    node.pm_ref = ref
                breaches.append(rec)
                if self.metrics is not None:
                    try:
                        self.metrics.log(rec)
                    except Exception:
                        logger.exception("fleet: breach sink emit failed")
                if self.anomaly is not None:
                    self.anomaly.trigger_external(
                        f"slo_{rule.name}", hotkey=node.hotkey,
                        detail=detail)
        obs.gauge("fleet.slo_breaches", float(len(self._fired)))
        return breaches

    # -- exposure ------------------------------------------------------------
    def ledger(self) -> dict:
        """JSON-able snapshot: ``{"<role>/<hotkey>": {...}}`` — ONE
        structured record however many nodes, the same bounded-
        cardinality rule as the validator's round_scores."""
        now = self.clock.now()
        with self._lock:
            return {f"{n.role}/{n.hotkey}": n.as_record(now)
                    for n in sorted(self.nodes.values(),
                                    key=lambda n: (n.role, n.hotkey))}

    def flush(self, sink=None, *, step: int | None = None) -> dict:
        """Log the ledger snapshot through ``sink`` (default: the role's
        metrics) and refresh the fleet gauges — the round-cadence twin of
        obs.flush."""
        led = self.ledger()
        with self._lock:
            stale = sum(1 for n in self.nodes.values()
                        if n.beats > 0 and n.last_seen_round is not None
                        and self.round - n.last_seen_round > 1)
            quarantined = sum(1 for n in self.nodes.values()
                              if n.quarantined)
        obs.gauge("fleet.stale_nodes", float(stale))
        obs.gauge("fleet.quarantined", float(quarantined))
        sink = sink if sink is not None else self.metrics
        if sink is not None and led:
            try:
                sink.log({"fleet_ledger": led, "fleet_round": self.round},
                         step=step)
            except Exception:
                logger.exception("fleet: ledger sink emit failed")
        return led


# ---------------------------------------------------------------------------
# SLO burn-rate alerting (fed from the request-trace stream)
# ---------------------------------------------------------------------------

# multi-window / multi-burn-rate pairs (the SRE-workbook shape): a pair
# fires only when BOTH its short and long window burn faster than the
# factor — the short window gives detection speed, the long window
# suppresses blips. Factors are the canonical 2%-of-budget-in-1h /
# 5%-of-budget-in-6h alerts for a 30-day budget.
BURN_WINDOWS: dict[str, tuple[float, float, float]] = {
    # label: (short_s, long_s, burn factor)
    "fast": (300.0, 3600.0, 14.4),       # 5m / 1h
    "slow": (1800.0, 21600.0, 6.0),      # 30m / 6h
}

# the window labels of the dt_slo_burn{slo,window} series, in render
# order (short windows of each pair first)
BURN_WINDOW_LABELS: tuple[tuple[str, float], ...] = (
    ("5m", 300.0), ("30m", 1800.0), ("1h", 3600.0), ("6h", 21600.0))


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One serving SLO expressed as an error budget.

    ``slo`` picks the trace-stream signal (closed vocabulary):

    - ``ttft``: a request whose time-to-first-token exceeded
      ``objective_ms`` burned budget.
    - ``tpot``: same over mean time-per-output-token.
    - ``shed``: every refused request (429 shed / 503 drain) burns;
      every completed request doesn't. ``objective_ms`` is unused.

    ``budget`` is the allowed bad fraction — burn rate is
    bad_fraction / budget, so burn 1.0 = exactly on budget.
    """
    slo: str
    objective_ms: float = 0.0
    budget: float = 0.01

    _SLOS = ("ttft", "tpot", "shed")

    def __post_init__(self):
        if self.slo not in self._SLOS:
            raise ValueError(f"unknown burn SLO {self.slo!r}; "
                             f"expected one of {self._SLOS}")
        if not 0.0 < self.budget < 1.0:
            raise ValueError(f"budget must be in (0, 1), "
                             f"got {self.budget}")
        if self.slo != "shed" and self.objective_ms <= 0:
            raise ValueError(f"{self.slo} rule needs objective_ms > 0")


def default_burn_rules() -> tuple[BurnRule, ...]:
    """The default serving objectives (docs/observability.md)."""
    return (
        BurnRule("ttft", objective_ms=250.0, budget=0.02),
        BurnRule("tpot", objective_ms=50.0, budget=0.02),
        BurnRule("shed", budget=0.02),
    )


class BurnRateMonitor:
    """Multi-window burn-rate alerting over the request-trace stream.

    Every request outcome the TraceBook feeds it (``observe``) is
    judged over sliding wall- or injected-clock windows, so a latency
    regression fires within minutes of arriving. A (rule, pair) alert
    fires once per monitor lifetime: flight "slo" record -> frozen and
    published bundle (``pm_ref``) -> metrics sink -> AnomalyMonitor
    one-shot. ``clock`` is injectable (a scripted clock in the tests).

    Thread contract: ``observe`` may be called from the engine's
    scheduler thread and HTTP handler threads (sheds); ``evaluate`` /
    ``gauges`` from anywhere — all state mutations hold ``_lock``.
    """

    def __init__(self, rules: Sequence[BurnRule] | None = None, *,
                 clock: Callable[[], float] = time.time,
                 anomaly=None, metrics=None,
                 min_samples: int = 12, max_events: int = 65536):
        self.rules = tuple(rules if rules is not None
                           else default_burn_rules())
        if len({r.slo for r in self.rules}) != len(self.rules):
            raise ValueError("one BurnRule per slo")
        self.clock = clock
        self.anomaly = anomaly
        self.metrics = metrics
        self.min_samples = min_samples
        # (t, bad) outcome streams; "shed" sees every request (good on
        # completion, bad on refusal), latency slos see completions
        self._events: dict[str, deque] = {
            r.slo: deque(maxlen=max_events) for r in self.rules}
        self._fired: set[tuple[str, str]] = set()
        self.alerts: list[dict] = []
        self._lock = threading.Lock()

    # -- the trace-stream feed ----------------------------------------------
    def observe(self, t: float | None = None, *,
                ttft_ms: float | None = None,
                tpot_ms: float | None = None,
                shed: bool = False) -> None:
        """Fold one request outcome in (TraceBook.finish / .reject)."""
        now = float(self.clock()) if t is None else float(t)
        with self._lock:
            for rule in self.rules:
                ev = self._events[rule.slo]
                if rule.slo == "shed":
                    ev.append((now, shed))
                elif shed:
                    continue  # a refused request has no latency sample
                elif rule.slo == "ttft" and ttft_ms is not None:
                    ev.append((now, ttft_ms > rule.objective_ms))
                elif rule.slo == "tpot" and tpot_ms is not None:
                    ev.append((now, tpot_ms > rule.objective_ms))

    # -- window math ---------------------------------------------------------
    def _burn_locked(self, rule: BurnRule, window_s: float,
                     now: float) -> float:
        """bad_fraction / budget over [now - window_s, now]; 0.0 below
        ``min_samples`` (sparse traffic must not page)."""
        cutoff = now - window_s
        good = bad = 0
        ev = self._events[rule.slo]
        for t, is_bad in reversed(ev):
            if t < cutoff:
                break
            if is_bad:
                bad += 1
            else:
                good += 1
        n = good + bad
        if n < self.min_samples:
            return 0.0
        return (bad / n) / rule.budget

    def burn(self, slo: str, window_s: float,
             now: float | None = None) -> float:
        now = float(self.clock()) if now is None else now
        rule = next(r for r in self.rules if r.slo == slo)
        with self._lock:
            return self._burn_locked(rule, window_s, now)

    def gauges(self, now: float | None = None) -> dict[tuple[str, str],
                                                       float]:
        """{(slo, window_label): burn} for every rule x export window —
        the dt_slo_burn{slo,window} series."""
        now = float(self.clock()) if now is None else now
        out = {}
        with self._lock:
            for rule in self.rules:
                for label, win_s in BURN_WINDOW_LABELS:
                    out[(rule.slo, label)] = round(
                        self._burn_locked(rule, win_s, now), 4)
        return out

    def max_burn(self, now: float | None = None) -> float:
        """Worst burn across rules over the fast short window — the
        single number the server heartbeat ships (fleet_report's
        slo_burn column)."""
        now = float(self.clock()) if now is None else now
        short_s = BURN_WINDOWS["fast"][0]
        with self._lock:
            return round(max((self._burn_locked(r, short_s, now)
                              for r in self.rules), default=0.0), 4)

    # -- alerting ------------------------------------------------------------
    def evaluate(self, now: float | None = None, *,
                 round_num: int | None = None) -> list[dict]:
        """Fire any (rule, window-pair) whose short AND long windows
        both burn past the pair's factor. Returns this call's NEW
        alerts; each fires once per monitor lifetime."""
        now = float(self.clock()) if now is None else now
        fired = []
        for rule in self.rules:
            for pair, (short_s, long_s, factor) in BURN_WINDOWS.items():
                key = (rule.slo, pair)
                with self._lock:
                    if key in self._fired:
                        continue
                    b_short = self._burn_locked(rule, short_s, now)
                    b_long = self._burn_locked(rule, long_s, now)
                    if not (b_short > factor and b_long > factor):
                        continue
                    self._fired.add(key)
                name = f"slo_burn.{rule.slo}.{pair}"
                detail = (f"burn {b_short:.1f}x short / {b_long:.1f}x "
                          f"long (> {factor:g}x budget "
                          f"{rule.budget:g})")
                rec = {"slo_burn": rule.slo, "window": pair,
                       "burn_short": round(b_short, 3),
                       "burn_long": round(b_long, 3),
                       "factor": factor, "detail": detail, "t": now}
                if round_num is not None:
                    rec["round"] = round_num
                obs.count(f"serve.slo_burn.{rule.slo}")
                logger.warning("SLO burn alert: %s — %s", name, detail)
                # record the alert into the flight ring FIRST, then
                # freeze + publish; the bundle id is the alert's pm_ref
                flight.record("slo", rule=name, role="server",
                              hotkey="", detail=detail,
                              round=round_num or 0)
                ref = flight.freeze_and_publish(name.replace(".", "_"))
                if ref:
                    rec["pm_ref"] = ref
                fired.append(rec)
                if self.metrics is not None:
                    try:
                        self.metrics.log(rec)
                    except Exception:
                        logger.exception("burn: alert sink emit failed")
                if self.anomaly is not None:
                    self.anomaly.trigger_external(
                        name, hotkey="", detail=detail)
        if fired:
            with self._lock:
                self.alerts.extend(fired)
        return fired


# the process's exported burn monitor (weakref: a closed engine must not
# pin its monitor alive)
_LIVE_BURN: Any = None


def attach_burn(monitor: BurnRateMonitor | None) -> None:
    """Make ``monitor`` the process's exported burn monitor
    (``None`` detaches)."""
    global _LIVE_BURN
    _LIVE_BURN = None if monitor is None else weakref.ref(monitor)


def live_burn_monitor() -> BurnRateMonitor | None:
    ref = _LIVE_BURN
    return ref() if ref is not None else None
