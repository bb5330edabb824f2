"""Bounded retry with jittered exponential backoff for transport publishes —
a copy of the JAX package's ``transport/retry.py``.

The reference retries uploads with ad-hoc fixed loops (a blocking double
retry in the rider path, bare try/except elsewhere). This is the ONE home
of the retry rule for every publish — the async publisher worker
(engine/publish.py) and the sync push path both call through here, so the
two paths cannot drift on attempt counts or pacing.

Jitter matters at fleet scale: a hundred miners whose pushes all fail on
the same Hub hiccup would otherwise re-hit it in lockstep at exactly
base_delay, 2*base_delay, ... — the classic retry storm. The +/-``jitter``
fraction decorrelates them.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts = TOTAL tries (1 = no retry). Delay before try n+1 is
    ``base_delay * 2**(n-1)`` capped at ``max_delay``, scaled by a uniform
    factor in [1-jitter, 1+jitter].

    ``max_elapsed`` is a TOTAL-ELAPSED deadline (seconds) across the whole
    retry loop — calls plus backoff sleeps. An attempt budget alone is the
    wrong bound on a PARTITIONED backend: each try can block for its full
    transport timeout (tens of seconds on a black-holed TCP connection),
    so "3 attempts" can silently eat a whole round. Once the deadline
    passes — or the next backoff sleep would overshoot it — the loop
    abandons remaining attempts and re-raises, counted as
    ``transport.retry_deadline`` so a fleet report can tell deadline
    abandonment from ordinary budget exhaustion. None = no deadline."""
    attempts: int = 3
    base_delay: float = 0.25
    max_delay: float = 8.0
    jitter: float = 0.5
    max_elapsed: Optional[float] = None

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.max_elapsed is not None and self.max_elapsed <= 0:
            raise ValueError(f"max_elapsed must be > 0 or None, "
                             f"got {self.max_elapsed}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff after the ``attempt``-th (1-based) failed try."""
        d = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return max(0.0, d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))


# the rider is tiny and best-effort; the artifact is the protocol payload.
# The elapsed deadlines are generous next to the attempt budgets (which
# bound the healthy case); they exist for the PARTITIONED case, where a
# single blocked call can otherwise exceed the round cadence.
DEFAULT_PUBLISH_RETRY = RetryPolicy(attempts=3, base_delay=0.25,
                                    max_delay=8.0, max_elapsed=120.0)
DEFAULT_META_RETRY = RetryPolicy(attempts=3, base_delay=0.1, max_delay=2.0,
                                 max_elapsed=30.0)
# ingest-side reads (revision probes, artifact fetches): a shorter budget
# than publishes — a missed miner this round merges next round, whereas a
# lost publish drops the artifact. Failures after the budget are isolated
# per miner by the ingest pool (engine/ingest.py), never round-fatal.
DEFAULT_FETCH_RETRY = RetryPolicy(attempts=2, base_delay=0.2, max_delay=2.0,
                                  max_elapsed=60.0)


def call_with_retry(fn: Callable, *, policy: RetryPolicy | None = None,
                    sleep: Callable[[float], None] = time.sleep,
                    rng: Optional[random.Random] = None,
                    describe: str = "publish",
                    monotonic: Callable[[], float] = time.monotonic):
    """Run ``fn`` under ``policy``; returns its value or raises the LAST
    failure once the attempt budget is spent (callers decide whether a
    terminal failure is fatal — for a miner push it never is).

    ``sleep`` is injectable so loops pass their Clock's sleep (FakeClock
    tests retry pacing in microseconds) and workers stay real-time;
    ``monotonic`` pairs with it so the ``max_elapsed`` deadline is
    testable on the same fake timebase.

    Every try feeds the observability registry (utils/obs.py, no-ops
    unless a sink is configured): ``transport.retry.attempts`` counts
    total tries, ``transport.retry.retries`` the failed-then-retried
    ones, ``transport.retry.exhausted`` spent budgets,
    ``transport.retry_deadline`` the retries abandoned because
    ``max_elapsed`` ran out mid-loop, and ``transport.retry.call_ms`` the
    per-try latency — the fleet-level view of a flaky Hub that per-role
    logs cannot show."""
    from ..utils import obs

    policy = policy or DEFAULT_PUBLISH_RETRY
    rng = rng or random.Random()
    start = monotonic()
    for attempt in range(1, policy.attempts + 1):
        obs.count("transport.retry.attempts")
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:
            obs.observe("transport.retry.call_ms",
                        (time.perf_counter() - t0) * 1e3)
            if attempt >= policy.attempts:
                obs.count("transport.retry.exhausted")
                raise
            delay = policy.delay(attempt, rng)
            if policy.max_elapsed is not None and \
                    monotonic() - start + delay > policy.max_elapsed:
                # the next sleep would overshoot the round budget: a retry
                # loop on a partitioned backend must surrender the rest of
                # its attempts rather than blow the cadence it serves
                obs.count("transport.retry_deadline")
                logger.warning(
                    "%s failed (attempt %d/%d); abandoning %d remaining "
                    "attempt(s) — %.1fs elapsed of the %.1fs deadline: %s",
                    describe, attempt, policy.attempts,
                    policy.attempts - attempt,
                    monotonic() - start, policy.max_elapsed, e)
                raise
            obs.count("transport.retry.retries")
            logger.warning("%s failed (attempt %d/%d), retrying in %.2fs: %s",
                           describe, attempt, policy.attempts, delay, e)
            sleep(delay)
        else:
            obs.observe("transport.retry.call_ms",
                        (time.perf_counter() - t0) * 1e3)
            return out
