"""Deadline wrapper for hang-prone external calls — the port of the JAX
package's ``utils/timeout.py`` (standard library only).

The reference forks a subprocess per chain RPC with a 60 s TTL because
substrate connections wedge. A forked child would inherit the parent's
CUDA context, so the same hygiene is a daemon worker thread and a
deadline: the caller gets :class:`ChainTimeout` and moves on; an
abandoned thread parks on dead IO and never touches device state.

A parked Python thread cannot be killed, so abandonment is accounted for
instead of ignored:

- every timeout registers its worker in a live-abandoned set;
  ``abandoned_workers()`` (live, self-pruning) and ``abandoned_total()``
  (monotonic) ride ``utils.metrics.device_metrics()`` into every role's
  metric stream as ``chain_abandoned_workers`` and
  ``chain_abandoned_total``;
- ``on_timeout`` may kill the IO object the worker is parked on (closing
  a dead socket unblocks the blocked read, the worker raises and exits);
- past ``ABANDON_WARN_THRESHOLD`` live abandoned workers a warning logs
  on every further timeout, naming the remedy.

Nothing in the port calls a chain RPC yet (``--chain bittensor`` needs
the network); the accounting is what the metric stream carries.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# above this many LIVE parked workers the wrapper complains loudly
ABANDON_WARN_THRESHOLD = 8

_abandoned_lock = threading.Lock()
_abandoned: list[threading.Thread] = []
_abandoned_total = 0


class ChainTimeout(TimeoutError):
    pass


def abandoned_workers() -> int:
    """Live worker threads abandoned by a past timeout (workers whose IO
    returned, or was killed through ``on_timeout``, drop out)."""
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)


def abandoned_total() -> int:
    """Monotonic count of timeouts that abandoned a worker."""
    return _abandoned_total


def run_with_timeout(fn: Callable[[], T], timeout: float, *,
                     name: str = "op",
                     on_timeout: Optional[Callable[[], None]] = None) -> T:
    """Run ``fn`` on a daemon thread; raise ChainTimeout after ``timeout``
    seconds. ``on_timeout`` runs on the CALLER's thread right after the
    deadline fires (close the connection ``fn`` is blocked on there). An
    exception ``fn`` raises in time reaches the caller unchanged."""
    global _abandoned_total
    q: queue.Queue = queue.Queue(maxsize=1)

    def worker():
        try:
            q.put(("ok", fn()))
        except BaseException as e:  # every failure reaches the caller
            q.put(("err", e))

    t = threading.Thread(target=worker, daemon=True, name=f"timeout-{name}")
    t.start()
    try:
        kind, val = q.get(timeout=timeout)
    except queue.Empty:
        with _abandoned_lock:
            _abandoned[:] = [x for x in _abandoned if x.is_alive()]
            _abandoned.append(t)
            _abandoned_total += 1
            live = len(_abandoned)
        if on_timeout is not None:
            try:
                on_timeout()
            except Exception:
                logger.exception("%s: on_timeout hook failed", name)
        if live > ABANDON_WARN_THRESHOLD:
            logger.warning(
                "%s timed out; %d abandoned worker threads are still "
                "parked (total timeouts: %d) — pass on_timeout to kill "
                "the wedged connection so they can exit", name, live,
                _abandoned_total)
        raise ChainTimeout(f"{name} exceeded {timeout}s") from None
    if kind == "err":
        raise val
    return val
