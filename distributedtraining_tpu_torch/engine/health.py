"""Serving SLO burn-rate alerting — the burn part of the JAX package's
``engine/health.py`` (``BurnRule``, ``default_burn_rules``,
``BurnRateMonitor``, ``attach_burn``, ``live_burn_monitor``).

The request-trace stream (``utils/reqtrace.TraceBook``) feeds every
finished and refused request into a :class:`BurnRateMonitor`, which
judges each serving SLO (ttft, tpot, shed) as an error budget over
sliding windows and fires a (rule, window pair) once when both its
windows burn faster than the pair's factor: a flight ``slo`` record,
a frozen and published bundle, the metrics sink, the anomaly monitor.
Firings on one clock are the JAX package's.

Heartbeats, the fleet monitor and its ledger, and the exporter that
renders ``dt_slo_burn{slo,window}`` are the fleet planes (ROADMAP
'Slices of the port', slice 7).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Sequence

from ..utils import flight, obs

logger = logging.getLogger(__name__)


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
