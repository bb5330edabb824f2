"""Background input pipeline: overlap host work with device steps — a copy
of the JAX package's ``data/prefetch.py``.

A bounded background thread runs the host side of the pipeline — tokenize
→ pack → stack → (optionally) the copy to the card — ahead of the
training loop, so the card never waits on Python between steps even when
a single host step is slower than a device step (the miner's
``--prefetch-depth``, 2 by default).

Threads, not processes: numpy stacking and the host-to-device copy
release the GIL, and staying in-process means device placement can happen
inside the worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Iterate ``source`` on a daemon thread, ``depth`` items ahead.

    ``transform`` runs inside the worker (use it for
    ``TrainEngine.place_batch`` so the host-to-device copy overlaps
    compute). Exceptions in the source/transform
    surface on the consuming thread at the next ``__next__``; ``close()``
    stops the worker promptly and is idempotent (also called by ``__del__``
    and on exhaustion).
    """

    def __init__(self, source: Iterable, *, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, args=(iter(source), transform), daemon=True)
        self._worker.start()

    def _run(self, it: Iterator, transform: Optional[Callable]) -> None:
        try:
            for item in it:
                if transform is not None:
                    item = transform(item)
                self._put(item)
                if self._stop.is_set():
                    return
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - re-raised on consumer
            if isinstance(e, StopIteration):
                # PEP 479: a StopIteration leaking from the transform would
                # masquerade as clean exhaustion on the consumer — surface
                # it as the bug it is instead (cause-chained so the
                # offending transform frame survives)
                wrapped = RuntimeError(
                    "prefetch source/transform raised StopIteration")
                wrapped.__cause__ = e
                e = wrapped
            self._put(e)

    def _put(self, item) -> None:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        # bounded get + stop re-check: a cross-thread close() can land after
        # this thread committed to a get() — the worker's pending _put then
        # drops its item and an unbounded get would never return
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if item is _SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(source: Iterable, *, depth: int = 2,
             transform: Optional[Callable] = None) -> PrefetchIterator:
    """Wrap any batch iterable (e.g. ``batch_iterator``) with background
    prefetch. Typical miner wiring::

        batches = prefetch(batch_iterator(...), transform=engine.place_batch)
        loop.run(batches, ...)
    """
    return PrefetchIterator(source, depth=depth, transform=transform)


def map_prefetch(fn: Callable, items: Iterable, *,
                 depth: int = 1) -> PrefetchIterator:
    """Map ``fn`` over ``items`` on the background thread, bounded
    ``depth`` results ahead of the consumer: the staging half of a
    fetch/compute pipeline (the validator's cohort stager,
    ``engine/batched_eval.stage_cohorts``). ``close()`` stops the worker
    early (a failed round)."""
    return PrefetchIterator(items, depth=depth, transform=fn)
