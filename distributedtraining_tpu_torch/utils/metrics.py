"""Bounded profiler capture — the port of the JAX package's
``utils/metrics.TraceCapture`` onto ``torch.profiler``. The JSONL and
MLflow sinks and the device metrics of that module are slice 7.
"""

from __future__ import annotations

import os


class TraceCapture:
    """Captures exactly ``steps`` train steps with ``torch.profiler``
    (the CPU and, on the card, CUDA activity) into a Chrome trace file
    under ``log_dir``, then stops itself. Poll ``tick()`` once a step;
    the capture starts at the first tick AFTER ``skip`` ticks, so warm-up
    never pollutes the trace, and ticks are no-ops once the window
    closed.

    ``arm=False`` constructs it DISARMED: ticks are free no-ops until
    ``arm()`` (the anomaly path, ``utils/obs.AnomalyMonitor``; ``skip``
    counts from the arming, so the window lands on the steps right after
    the anomaly). One window an instance: arming is one-way and a
    finished capture never re-arms. ``trace_path`` names the written
    file once the window closed."""

    def __init__(self, log_dir: str, *, steps: int = 5, skip: int = 3,
                 arm: bool = True):
        self.log_dir = log_dir
        self.steps = steps
        self.skip = skip
        self._armed = arm
        self._seen = 0
        self._prof = None
        self._done = False
        self.trace_path: str | None = None

    @property
    def armed(self) -> bool:
        return self._armed and not self._done

    @property
    def active(self) -> bool:
        return self._prof is not None

    def arm(self) -> None:
        if self._done or self._armed:
            return
        self._armed = True
        self._seen = 0

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        prof.__exit__(None, None, None)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    def tick(self) -> None:
        if self._done or not self._armed:
            return
        self._seen += 1
        if self._prof is None and self._seen > self.skip:
            self._start()
        elif self._prof is not None and self._seen > self.skip + self.steps:
            self._stop()

    def close(self) -> None:
        """Stop an in-flight capture (role shutdown mid-window); what it
        caught is still written."""
        if self._prof is not None:
            self._stop()
