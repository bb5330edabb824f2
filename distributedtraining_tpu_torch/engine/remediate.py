"""Averager failover — the publication lease and the standby of the JAX
package's ``engine/remediate.py`` (``parse_lease``, ``LeaseManager``,
``StandbyAverager``). The rest of that module (quarantine, elastic
cohorts: ``RemediationEngine``) is slice 7, with the fleet plane.

Base publication is single-writer, so a standby cannot start publishing
because the primary looks dead: that is a one-sided observation. The
arbitration token is a transport-published **lease** on the reserved
``__lease__.<role>`` rider slot — ``{"lease": 1, "epoch", "holder",
"t"[, "base_revision"]}``, the JAX package's token — so either package's
primary and standby share one store:

- a primary ``acquire``s at (highest epoch seen) + 1 and verifies its own
  write, ``renew``s immediately before every publish (a higher epoch, or
  the same epoch under another holder, stands it down) and ``stamp``s the
  token with each revision it publishes;
- a standby watches the lease, the base revision and the primary's
  heartbeat (heartbeats are slice 7, so that signal reads absent here);
  only a signal read successfully with a new value resets its stall
  clock (a read fault is no evidence), and ``deadline_s`` without such
  evidence takes the lease at the next epoch and bootstraps the wrapped
  loop from the current published base.
"""

from __future__ import annotations

import logging

from ..transport.base import lease_id
from ..utils import flight, obs

logger = logging.getLogger(__name__)

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
    holder), the base revision and the primary's heartbeat slot (absent
    in the port: heartbeats are slice 7). A signal read successfully with
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
        """What a live primary advances: (lease, base revision,
        heartbeat). A read that fails contributes None, never aborts."""
        lease = self.lease.read()
        sig = [(lease["epoch"], lease["t"], lease["holder"])
               if lease else None]
        try:
            sig.append(self.loop.transport.base_revision())
        except Exception:
            sig.append(None)
        sig.append(None)   # the primary's heartbeat: slice 7
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
    def poll_once(self) -> str:
        """One watch step: "active", "following" or "takeover"."""
        if self.active:
            return "active"
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
        self.takeovers += 1
        obs.count("standby.takeovers")
        logger.warning("standby %s: took over publication at epoch %d",
                       self.lease.hotkey, self.lease.epoch)
        flight.record("lease", action="takeover", epoch=self.lease.epoch,
                      holder=self.lease.hotkey, role=self.lease.role)
        flight.freeze_and_publish("takeover")
        # bootstrap after winning the lease: the current published base,
        # never a local guess
        self.loop.bootstrap()
        self.active = True
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
