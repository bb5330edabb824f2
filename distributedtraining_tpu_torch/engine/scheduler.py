"""Clocks and periodic actions — a copy of the JAX package's
``engine/scheduler.py`` (the port imports nothing of that package).

The reference interleaves wall-clock interval checks directly into its hot
loops (``time.time() - last_pull > check_update_interval`` at
training_manager.py:361-378, 405-427; ``time.sleep`` loops at
validation_logic.py:191-196, averaging_logic.py:544-583). Here the same
cadences are expressed against a Clock protocol so tests drive them with a
FakeClock in microseconds instead of real seconds.
"""

from __future__ import annotations

import time
from typing import Callable, Protocol


class Clock(Protocol):
    def now(self) -> float: ...
    def sleep(self, seconds: float) -> None: ...


class RealClock:
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock:
    """Deterministic test clock; sleep() advances it instantly."""

    def __init__(self, start: float = 0.0):
        self._t = start

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += seconds

    def advance(self, seconds: float) -> None:
        self._t += seconds


class PeriodicAction:
    """Fire ``fn`` at most once per ``interval`` seconds, polled in-loop.

    ``fire_immediately`` controls whether the first poll fires (the miner's
    push timer starts counting from loop start — training_manager.py:358 —
    while its pull check fires on the first batch).

    ``decide`` post-processes the local elapsed-time verdict into the final
    fire decision. Multi-host SPMD roles pass a broadcast hook here: each
    process's wall clock skews, and ``fn`` bodies contain collectives, so
    every process must reach the identical fire decision at the identical
    poll site or the pod's programs diverge and hang.
    """

    def __init__(self, interval: float, fn: Callable[[], None], clock: Clock,
                 *, fire_immediately: bool = False,
                 decide: Callable[[bool], bool] | None = None):
        self.interval = interval
        self.fn = fn
        self.clock = clock
        self.decide = decide
        self.last_fired = float("-inf") if fire_immediately else clock.now()

    def poll(self) -> bool:
        now = self.clock.now()
        fire = now - self.last_fired >= self.interval
        if self.decide is not None:
            fire = self.decide(fire)
        if fire:
            self.last_fired = now
            self.fn()
            return True
        return False
