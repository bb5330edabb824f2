"""Remediation — the port of the JAX package's ``engine/remediate.py``:
act on SLO breaches (quarantine, elastic cohorts) and keep base
publication single-writer across an averager failover.

- **Quarantine** (:class:`RemediationEngine`): a miner breaching one of
  the policy's rules (default: push-failure streak, loss divergence,
  stale node) is dropped from the staging set (``is_excluded``, the
  ingest exclude hook: no transport bytes move, the ledger records
  ``reason="quarantined"``), and its score decays each round
  (``decay_scores``). After ``probation_beats`` fresh heartbeats that
  evaluate clean against the quarantining rule it is re-admitted on
  probation for ``probation_rounds`` rounds (``FleetMonitor.clear_fired``
  re-arms the rule, so a relapse re-quarantines), then healthy.
- **Elastic cohorts** (:func:`elastic_cohort`): when quarantine shrinks
  the healthy count below the configured cohort, the validator's cohort
  steps down the bucket ladder, preferring a bucket already dispatched
  (``BatchedCohortEvaluator.compiled_buckets``).
- **Failover** (:class:`LeaseManager`, :class:`StandbyAverager`): the
  arbitration token is a transport-published **lease** on the reserved
  ``__lease__.<role>`` rider slot — ``{"lease": 1, "epoch", "holder",
  "t"[, "base_revision"]}``, the JAX package's token, so either
  package's primary and standby share one store. A primary
  ``acquire``s at (highest epoch seen) + 1 and verifies its own write,
  ``renew``s immediately before every publish (a higher epoch, or the
  same epoch under another holder, stands it down) and ``stamp``s the
  token with each revision it publishes. A standby watches the lease,
  the base revision and the holder's ``__hb__.averager.<holder>``
  heartbeat; only a signal read successfully with a new value resets
  its stall clock (a read fault is no evidence), and ``deadline_s``
  without such evidence takes the lease at the next epoch and
  bootstraps the wrapped loop from the current published base.

On a world of several processes the coordinator alone reads and writes
the lease; the verdicts (renew, the standby's poll) reach every rank by
broadcast, so the ranks publish, stand down and take over together.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Sequence

from ..transport.base import heartbeat_id, lease_id
from ..utils import flight, obs
from .batched_eval import BUCKETS
from .health import FleetMonitor, parse_heartbeat

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Elastic cohort sizing
# ---------------------------------------------------------------------------

def elastic_cohort(configured: int, healthy: int, *,
                   compiled: Iterable[int] = (),
                   buckets: Sequence[int] = BUCKETS) -> int:
    """Effective cohort size for ``healthy`` stageable miners under a
    ``configured`` cohort: unchanged while the fleet covers it, else the
    smallest ladder bucket covering the healthy count — preferring an
    ALREADY-COMPILED bucket so the shrink reuses a cached program instead
    of compiling the exact-fit one. Never exceeds ``configured``."""
    if configured <= 1 or healthy >= configured:
        return configured
    healthy = max(1, int(healthy))
    comp = sorted(b for b in set(compiled) if healthy <= b <= configured)
    if comp:
        return comp[0]
    ladder = [b for b in buckets if b >= healthy]
    target = ladder[0] if ladder else buckets[-1]
    return max(1, min(configured, target))


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RemediationPolicy:
    """Declarative knobs (docs/resilience.md documents each).

    ``quarantine_rules``: SLO rule NAMES whose breach quarantines a miner
    (names, not kinds — deployments rename/duplicate rules with custom
    thresholds). ``probation_beats``: fresh clean heartbeats required to
    re-admit. ``probation_rounds``: rounds a re-admitted node stays on
    probation (a breach there re-quarantines at once). ``score_decay``:
    multiplier applied to a quarantined miner's score each round — decay,
    not zeroing, so a recovered node re-enters weight-setting from a
    discounted history rather than from nothing."""
    quarantine_rules: tuple = ("push_failure_streak", "loss_divergence",
                               "stale_node")
    probation_beats: int = 3
    probation_rounds: int = 2
    score_decay: float = 0.25

    def __post_init__(self):
        if self.probation_beats < 1:
            raise ValueError(f"probation_beats must be >= 1, "
                             f"got {self.probation_beats}")
        if self.probation_rounds < 0:
            raise ValueError(f"probation_rounds must be >= 0, "
                             f"got {self.probation_rounds}")
        if not 0.0 <= self.score_decay <= 1.0:
            raise ValueError(f"score_decay must be in [0, 1], "
                             f"got {self.score_decay}")


@dataclasses.dataclass
class _Case:
    """One miner's remediation case file."""
    hotkey: str
    rule: str                       # the rule that quarantined it
    state: str                      # "quarantined" | "probation"
    opened_round: int
    beats_seen: int                 # node.beats at the last observation
    clean_beats: int = 0
    probation_until: int | None = None


class RemediationEngine:
    """Subscribe a :class:`~.health.FleetMonitor`'s breaches to actions.

    Drive it at the round cadence from the loop that owns the monitor:
    ``observe_round(breaches)`` right after ``fleet.evaluate_slos()``.
    The staging exclude hook (:meth:`is_excluded`) and score decay
    (:meth:`decay_scores`) read the current case files; both are cheap
    dict lookups, O(hotkeys) a round. On a world of several processes
    the engine lives on the coordinator alone: its exclusions reach the
    other ranks inside the staging broadcast, and the validator
    broadcasts the cohort size.
    """

    def __init__(self, fleet: FleetMonitor, *,
                 policy: RemediationPolicy | None = None,
                 metrics=None, role: str = "miner"):
        self.fleet = fleet
        self.policy = policy or RemediationPolicy()
        self.metrics = metrics
        self.role = role            # the role this engine quarantines
        self.cases: dict[str, _Case] = {}
        self._ever: set[str] = set()  # hotkeys ever quarantined (relapse tag)
        self.quarantines = 0        # lifetime counters (reports/tests)
        self.readmissions = 0

    # -- the filter hook -----------------------------------------------------
    def is_excluded(self, hotkey: str) -> bool:
        """True while ``hotkey`` is quarantined (the ingest exclude hook:
        probation nodes are NOT excluded — re-admission means staging)."""
        case = self.cases.get(hotkey)
        return case is not None and case.state == "quarantined"

    def quarantined(self) -> set[str]:
        return {h for h, c in self.cases.items()
                if c.state == "quarantined"}

    def filter_hotkeys(self, hotkeys: Iterable[str]) -> list[str]:
        """The stageable subset of ``hotkeys`` (order preserved)."""
        return [h for h in hotkeys if not self.is_excluded(h)]

    def decay_scores(self, scores: dict[str, float]) -> dict[str, float]:
        """Quarantined miners' scores decay by ``score_decay`` per round
        (applied to whatever the validator computed — usually 0 for a
        quarantined miner, but the decayed value is what feeds the chain
        EMA, pulling the on-chain weight down each round it stays out)."""
        if not self.cases:
            return scores
        return {h: (s * self.policy.score_decay
                    if self.is_excluded(h) else s)
                for h, s in scores.items()}

    def cohort_size(self, configured: int, healthy: int,
                    compiled: Iterable[int] = ()) -> int:
        return elastic_cohort(configured, healthy, compiled=compiled)

    # -- transitions ---------------------------------------------------------
    def _emit(self, action: str, case: _Case, detail: str = "",
              pm_ref: str | None = None) -> dict:
        # postmortem attachment (utils/flight.py): every quarantine and
        # probation flip carries a bundle reference — the TRIGGERING
        # breach's bundle when the monitor froze one, else a fresh
        # freeze of this role's ring at the moment of the action — and
        # the reference lands on the node's ledger entry, so
        # fleet_report/postmortem joins go straight from decision to
        # evidence.
        flight.record("remediation", action=action, hotkey=case.hotkey,
                      rule=case.rule, round=self.fleet.round)
        if pm_ref is None:
            pm_ref = flight.freeze_and_publish(f"remediation_{action}")
        rec = {"remediation": action, "hotkey": case.hotkey,
               "rule": case.rule, "round": self.fleet.round,
               "detail": detail}
        if pm_ref:
            rec["pm_ref"] = pm_ref
            node = self.fleet.nodes.get((self.role, case.hotkey))
            if node is not None:
                node.pm_ref = pm_ref
        obs.count(f"remediate.{action}")
        logger.warning("remediation: %s %s/%s (%s) %s", action, self.role,
                       case.hotkey, case.rule, detail)
        if self.metrics is not None:
            try:
                self.metrics.log(rec)
            except Exception:
                logger.exception("remediation: sink emit failed")
        return rec

    def _quarantine(self, hotkey: str, rule: str, detail: str,
                    pm_ref: str | None = None) -> dict:
        node = self.fleet.node(self.role, hotkey)
        node.quarantined, node.probation = True, False
        relapse = hotkey in self._ever
        self._ever.add(hotkey)
        self.cases[hotkey] = case = _Case(
            hotkey=hotkey, rule=rule, state="quarantined",
            opened_round=self.fleet.round, beats_seen=node.beats)
        self.quarantines += 1
        return self._emit("requarantined" if relapse else "quarantined",
                          case, detail, pm_ref)

    def _rule(self, name: str):
        for r in self.fleet.rules:
            if r.name == name:
                return r
        return None

    def observe_round(self, breaches: Iterable[dict] | None) -> list[dict]:
        """One remediation round: fold this round's NEW breaches, then
        advance every open case (clean-beat counting, probation expiry).
        Returns the action records it emitted. Never raises — the caller
        is a training round."""
        try:
            return self._observe_round(list(breaches or ()))
        except Exception:
            logger.exception("remediation: round observation failed")
            return []

    def _observe_round(self, breaches: list[dict]) -> list[dict]:
        actions = []
        for b in breaches:
            if b.get("role") != self.role:
                continue
            rule = b.get("slo_breach")
            if rule not in self.policy.quarantine_rules:
                continue
            hotkey = b.get("hotkey")
            case = self.cases.get(hotkey)
            if case is not None and case.state == "quarantined":
                continue        # already out; nothing more to do
            actions.append(self._quarantine(hotkey, rule,
                                            b.get("detail", ""),
                                            b.get("pm_ref")))
        median = self.fleet.fleet_median_loss()
        for case in list(self.cases.values()):
            node = self.fleet.nodes.get((self.role, case.hotkey))
            if node is None:    # pruned from the registry: case closed
                del self.cases[case.hotkey]
                continue
            if case.state == "quarantined":
                fresh = node.beats - case.beats_seen
                case.beats_seen = node.beats
                if fresh <= 0:
                    continue
                rule = self._rule(case.rule)
                clean = rule is None or rule.evaluate(
                    node, round_num=self.fleet.round,
                    fleet_median_loss=median) is None
                if not clean:
                    case.clean_beats = 0
                    continue
                case.clean_beats += fresh
                if case.clean_beats >= self.policy.probation_beats:
                    case.state = "probation"
                    case.probation_until = (self.fleet.round
                                            + self.policy.probation_rounds)
                    node.quarantined, node.probation = False, True
                    # re-arm the breach so a relapse can fire (and
                    # re-quarantine) instead of being one-shot-swallowed
                    self.fleet.clear_fired(self.role, case.hotkey,
                                           case.rule)
                    self.readmissions += 1
                    actions.append(self._emit(
                        "readmitted", case,
                        f"{case.clean_beats} clean heartbeats"))
            elif case.state == "probation":
                if self.fleet.round >= (case.probation_until or 0):
                    node.probation = False
                    del self.cases[case.hotkey]
                    actions.append(self._emit("healthy", case))
        obs.gauge("remediate.active_quarantines",
                  float(len(self.quarantined())))
        return actions


# ---------------------------------------------------------------------------
# The publication lease
# ---------------------------------------------------------------------------

LEASE_VERSION = 1
_MAX_STR = 200


def parse_lease(meta) -> dict | None:
    """Defensive read of the (peer-visible) lease token; None when absent
    or malformed."""
    if not isinstance(meta, dict):
        return None
    v = meta.get("lease")
    if not isinstance(v, (int, float)) or int(v) < 1:
        return None
    epoch = meta.get("epoch")
    holder = meta.get("holder")
    if not isinstance(epoch, (int, float)) or int(epoch) < 1:
        return None
    if not (isinstance(holder, str) and 0 < len(holder) <= _MAX_STR):
        return None
    out = {"lease": int(v), "epoch": int(epoch), "holder": holder,
           "t": float(meta["t"]) if isinstance(meta.get("t"),
                                               (int, float)) else 0.0}
    rev = meta.get("base_revision")
    if isinstance(rev, str) and 0 < len(rev) <= _MAX_STR:
        out["base_revision"] = rev
    return out


class LeaseManager:
    """The failover token of one single-writer role.

    ``epoch`` is this node's held epoch (0: not holding); ``seen`` the
    highest epoch ever observed. ``acquire`` bumps past ``seen`` and
    verifies its own write, ``renew`` re-reads before the caller
    publishes and stands down at a higher epoch, ``stamp`` writes the
    just-published revision into the token."""

    def __init__(self, transport, hotkey: str, *, role: str = "averager",
                 clock=None):
        from .scheduler import RealClock
        self.transport = transport
        self.hotkey = hotkey
        self.role = role
        self.id = lease_id(role)
        self.clock = clock or RealClock()
        self.epoch = 0
        self.seen = 0

    # -- raw I/O -------------------------------------------------------------
    def read(self) -> dict | None:
        """The current token, or None (absent or unreadable; callers that
        need the difference use :meth:`read_strict`)."""
        try:
            return self.read_strict()
        except Exception:
            obs.count("lease.read_errors")
            logger.warning("lease %s: read failed", self.id, exc_info=True)
            return None

    def read_strict(self) -> dict | None:
        fm = getattr(self.transport, "fetch_delta_meta", None)
        if fm is None:
            return None
        cur = parse_lease(fm(self.id))
        if cur is not None:
            self.seen = max(self.seen, cur["epoch"])
        return cur

    def _publish(self, epoch: int, base_revision: str | None) -> None:
        pm = getattr(self.transport, "publish_delta_meta", None)
        if pm is None:
            raise OSError(f"transport has no rider channel; lease "
                          f"{self.id} cannot be published")
        body = {"lease": LEASE_VERSION, "epoch": epoch,
                "holder": self.hotkey, "t": self.clock.now()}
        if base_revision:
            body["base_revision"] = base_revision
        pm(self.id, body)

    # -- protocol ------------------------------------------------------------
    def holds(self) -> bool:
        return self.epoch > 0

    def acquire(self) -> bool:
        """Claim the lease at (highest observed epoch) + 1 and verify the
        claim landed. Transport errors raise: acquiring blind against a
        store that cannot be read is how two holders happen."""
        cur = self.read_strict()
        nxt = max(self.seen, cur["epoch"] if cur else 0) + 1
        self._publish(nxt, None)
        check = self.read_strict()
        if check and check["holder"] == self.hotkey \
                and check["epoch"] == nxt:
            self.epoch = nxt
            obs.count("lease.acquired")
            obs.gauge(f"{self.role}.lease_epoch", float(nxt))
            flight.record("lease", action="acquired", epoch=nxt,
                          holder=self.hotkey, role=self.role)
            logger.info("lease %s: acquired epoch %d as %s", self.id, nxt,
                        self.hotkey)
            return True
        # lost the write race: the winner's epoch is remembered
        return False

    def renew(self) -> bool:
        """Confirm ownership immediately before a publish. Fail-safe: any
        doubt (an unreadable token, a higher epoch, another holder)
        answers False, and the caller must not publish."""
        if self.epoch == 0:
            try:
                return self.acquire()   # lazy first acquisition (primary)
            except Exception:
                logger.warning("lease %s: lazy acquire failed", self.id,
                               exc_info=True)
                return False
        try:
            cur = self.read_strict()
        except Exception:
            obs.count("lease.read_errors")
            flight.record("lease", action="renew_failed", epoch=self.epoch,
                          holder=self.hotkey, role=self.role)
            logger.warning("lease %s: renew read failed; standing down "
                           "this round", self.id, exc_info=True)
            return False
        if cur is None:
            # the token vanished (a storage reset): reclaim at a fresh
            # epoch, so the sequence stays monotone
            try:
                return self.acquire()
            except Exception:
                return False
        if cur["epoch"] > self.epoch or (cur["epoch"] == self.epoch
                                         and cur["holder"] != self.hotkey):
            obs.count("lease.lost")
            logger.warning(
                "lease %s: superseded (held epoch %d, current epoch %d "
                "holder %s) — standing down", self.id, self.epoch,
                cur["epoch"], cur["holder"])
            # the deposed side's forensic moment
            flight.record("lease", action="lost", epoch=cur["epoch"],
                          holder=cur["holder"], role=self.role)
            flight.freeze_and_publish("lease_lost")
            self.epoch = 0
            return False
        try:
            self._publish(self.epoch, cur.get("base_revision"))
        except Exception:
            # ownership was confirmed; the publish that follows surfaces a
            # real outage itself
            logger.warning("lease %s: renewal write failed", self.id,
                           exc_info=True)
        return True

    def stamp(self, base_revision: str | None) -> None:
        """Write the just-published revision into the held token (the
        epoch the publication carries). Best effort."""
        if self.epoch == 0:
            return
        try:
            self._publish(self.epoch, base_revision)
        except Exception:
            logger.warning("lease %s: stamp failed", self.id, exc_info=True)


class StandbyAverager:
    """A passive averager that takes over publication when the primary
    goes quiet.

    Each :meth:`poll_once` reads the lease token (epoch, renewal time,
    holder), the base revision and the holder's heartbeat (its ``seq``
    and ``t``). A signal read successfully with
    a new value resets the stall clock; ``deadline_s`` without one takes
    over: acquire the lease at the next epoch, then bootstrap the wrapped
    :class:`~.average.AveragerLoop` from the current published base and
    run its rounds. Nothing is published before the takeover."""

    def __init__(self, loop, lease: LeaseManager, *,
                 deadline_s: float = 90.0, poll_s: float = 5.0,
                 clock=None):
        from .scheduler import RealClock
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.loop = loop
        self.lease = lease
        self.deadline_s = deadline_s
        self.poll_s = poll_s
        self.clock = clock or RealClock()
        self.active = False
        self.takeovers = 0
        # the last successfully read value of each signal
        self._last_sig: list | None = None
        self._last_change: float | None = None

    # -- observation ---------------------------------------------------------
    def _signature(self) -> tuple:
        """What a live primary advances: (lease, base revision, the
        holder's heartbeat sequence). A read that fails contributes
        None, never aborts."""
        transport = self.loop.transport
        lease = self.lease.read()
        sig = [(lease["epoch"], lease["t"], lease["holder"])
               if lease else None]
        try:
            sig.append(transport.base_revision())
        except Exception:
            sig.append(None)
        holder = lease["holder"] if lease else None
        if holder and holder != self.lease.hotkey:
            try:
                hb = parse_heartbeat(transport.fetch_delta_meta(
                    heartbeat_id("averager", holder)))
                sig.append((hb["seq"], hb["t"]) if hb else None)
            except Exception:
                sig.append(None)
        else:
            sig.append(None)
        return tuple(sig)

    def stalled_for(self) -> float:
        if self._last_change is None:
            return 0.0
        return self.clock.now() - self._last_change

    def _progressed(self, sig: tuple) -> bool:
        """True when ``sig`` shows the primary moved: some element read
        successfully AND differs from its last successful read. A None
        (a read fault) is no evidence, so a flaky transport cannot keep
        resetting the stall clock."""
        if self._last_sig is None:
            self._last_sig = list(sig)
            return True
        moved = False
        for i, v in enumerate(sig):
            if v is not None and v != self._last_sig[i]:
                self._last_sig[i] = v
                moved = True
        return moved

    # -- the state machine ---------------------------------------------------
    def _multi(self) -> bool:
        from .train import mesh_spans
        return mesh_spans(getattr(self.loop, "engine", None))

    def poll_once(self) -> str:
        """One watch step: "active", "following" or "takeover". On a
        world of several processes the coordinator watches and takes the
        lease; its verdict is broadcast, so every rank takes over and
        bootstraps (a collective) together."""
        if self.active:
            return "active"
        if self._multi():
            from .train import coordinator_call
            try:
                verdict = coordinator_call(self._watch, "standby poll")
            except RuntimeError:
                verdict = "following"
        else:
            verdict = self._watch()
        if verdict != "takeover":
            return verdict
        self.takeovers += 1
        # bootstrap after winning the lease: the current published base,
        # never a local guess
        self.loop.bootstrap()
        self.active = True
        return "takeover"

    def _watch(self) -> str:
        """The stall clock and, past the deadline, the acquire: the
        coordinator's half of :meth:`poll_once`."""
        now = self.clock.now()
        if self._progressed(self._signature()) \
                or self._last_change is None:
            self._last_change = now
            return "following"
        if now - self._last_change < self.deadline_s:
            return "following"
        obs.count("standby.deadline_missed")
        logger.warning(
            "standby %s: no primary activity for %.0fs (deadline %.0fs); "
            "attempting takeover", self.lease.hotkey, now - self._last_change,
            self.deadline_s)
        try:
            acquired = self.lease.acquire()
        except Exception:
            logger.warning("standby %s: takeover acquire failed; will "
                           "retry", self.lease.hotkey, exc_info=True)
            return "following"
        if not acquired:
            # another node moved the epoch between the reads: it is the
            # new primary; restart the stall clock on its activity
            self._last_sig = None
            self._last_change = None
            return "following"
        obs.count("standby.takeovers")
        logger.warning("standby %s: took over publication at epoch %d",
                       self.lease.hotkey, self.lease.epoch)
        # the standby's ring (what it watched before the silence), its
        # bundle reference on its own ledger entry
        flight.record("lease", action="takeover", epoch=self.lease.epoch,
                      holder=self.lease.hotkey, role=self.lease.role)
        ref = flight.freeze_and_publish("takeover")
        fleet = getattr(self.loop, "fleet", None)
        if ref and fleet is not None:
            try:
                fleet.node("averager", self.lease.hotkey).pm_ref = ref
            except Exception:
                logger.exception("standby: ledger pm_ref attach failed")
        return "takeover"

    def run(self, *, interval: float = 1200.0,
            rounds: int | None = None) -> int:
        """Watch until takeover, then run the wrapped loop's rounds;
        returns the merged-round count."""
        while not self.active:
            self.poll_once()
            if not self.active:
                self.clock.sleep(self.poll_s)
        return self.loop.run_periodic(interval=interval, rounds=rounds)
