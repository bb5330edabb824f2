"""Local checkpoint and resume — the port of the JAX package's
``checkpoint.py`` (``Snapshot``, ``CheckpointStore``) for a miner that
restarts mid-round with its optimizer moments and step counter intact.

The JAX package writes through Orbax, which the card machine does not
have; a checkpoint is local, not a wire artifact, so the port keeps the
store's semantics on its own msgpack codec plus a JSON meta file:

- numbered steps: keys are a monotonic save sequence (:meth:`next_step`),
  not the train step, which resets on every base pull;
- retention: after each save, the oldest steps beyond ``max_to_keep`` go;
- atomic step directories: a save writes ``state.msgpack`` and
  ``meta.json`` into a temporary directory, fsyncs both, renames it to
  ``<step>`` and fsyncs the parent, so a crash mid-save leaves no step a
  restore would read (the debris is removed by the next save);
- meta: ``base_revision``, ``lifetime_steps`` and ``has_base`` (a base
  recoverable from the transport by its revision is not persisted);
- a restore checked against a template: every leaf's shape and dtype must
  match, else (or on an unreadable file) it returns None;
- ``save_async`` on the supersede worker of ``engine/publish.py``: the
  caller hands over device copies, the worker runs the ``precondition``
  (the miner's non-finite screen, read there), resolves the step number
  and writes; ``flush`` drains it.

``state.msgpack`` holds ``{"state": {"step", "params", "opt_state":
{"count", "mu", "nu"}}, "base_params"?}`` with the params and moments as
flat maps keyed by state-dict key.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Mapping, Optional

import numpy as np
import torch

from . import serialization as ser
from .delta import _dtype_name

logger = logging.getLogger(__name__)

Params = Any

_STATE_FILE = "state.msgpack"
_META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"


@dataclasses.dataclass
class Snapshot:
    """What a role persists between process lives."""
    state: Any                    # engine TrainState (params, opt_state, step)
    base_params: Params | None    # the miner's delta base (a state dict)
    base_revision: str | None     # the transport revision it came from
    lifetime_steps: int | None = None  # monotonic across base pulls


def _host(t):
    """A leaf as the file holds it: a numpy array, or a CPU tensor for
    bf16 (an optimizer's ``mu_dtype`` moment), which the codec writes as
    flax does."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _tree(snapshot: Snapshot) -> dict:
    """The snapshot's tensors as the host tree the file holds."""
    st = snapshot.state
    opt = st.opt_state
    tree = {"state": {
        "step": np.int64(int(st.step)),
        "params": {k: _host(v) for k, v in st.params.items()},
        "opt_state": {"count": np.int64(int(opt.count)),
                      "mu": {k: _host(v) for k, v in opt.mu.items()},
                      "nu": {k: _host(v) for k, v in opt.nu.items()}}}}
    if snapshot.base_params is not None:
        tree["base_params"] = {k: _host(v)
                               for k, v in snapshot.base_params.items()}
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _matches(raw: Mapping, template: Mapping) -> bool:
    """Every template leaf present with its shape and dtype."""
    for k, t in template.items():
        v = raw.get(k)
        if v is None or tuple(v.shape) != tuple(t.shape) \
                or _dtype_name(v) != _dtype_name(t):
            return False
    return set(raw) == set(template)


def _tensors(raw: Mapping) -> dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in raw.items()}


class CheckpointStore:
    """Numbered local checkpoints under ``directory`` with retention GC;
    ``save``/``restore`` round-trip a :class:`Snapshot`."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # created on the first save_async: sync-only stores own no thread
        self._async_worker = None

    # -- write --------------------------------------------------------------
    def save(self, step: int, snapshot: Snapshot) -> None:
        """Write ``snapshot`` as step ``step``, atomically, then GC."""
        step = int(step)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        meta = {"base_revision": snapshot.base_revision,
                "lifetime_steps": snapshot.lifetime_steps,
                "has_base": snapshot.base_params is not None}
        ser.save_file(_tree(snapshot), os.path.join(tmp, _STATE_FILE))
        with open(os.path.join(tmp, _META_FILE), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        self._gc()

    def _gc(self) -> None:
        """Drop steps beyond ``max_to_keep`` and any write debris."""
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(step)),
                          ignore_errors=True)

    def save_async(self, snapshot: Snapshot, *, precondition=None) -> None:
        """Queue a save on the store's worker (a one-slot SUPERSEDE queue:
        a pending save not yet started when the next arrives is dropped).
        The caller hands over an independent snapshot (device copies: the
        train step updates its state in place). ``precondition`` runs on
        the worker just before the write and aborts it when False; the
        step number is resolved there too. A failed save is logged,
        never raised."""
        if self._async_worker is None:
            from .engine.publish import PublishWorker
            self._async_worker = PublishWorker(
                name=f"ckpt-save-{os.path.basename(self.directory)}",
                counter_prefix="ckpt")

        def job():
            if precondition is not None and not precondition():
                return
            self.save(self.next_step(), snapshot)

        self._async_worker.submit(job)

    def flush(self, timeout: float | None = None) -> bool:
        """Drain pending and in-flight async saves (True when drained)."""
        if self._async_worker is None:
            return True
        return self._async_worker.flush(timeout=timeout)

    def next_step(self) -> int:
        """The next free key: one past the latest step."""
        latest = self.latest_step()
        return 0 if latest is None else latest + 1

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, _META_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self) -> Optional[dict]:
        """The latest step's JSON meta alone (cheap): callers shape the
        restore template from it."""
        step = self.latest_step()
        if step is None:
            return None
        try:
            with open(os.path.join(self.directory, str(step),
                                   _META_FILE)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        return meta if isinstance(meta, dict) else None

    def restore(self, template: Snapshot) -> Optional[Snapshot]:
        """The latest checkpoint in the template's structure,
        as CPU tensors; None when the store is empty, the files are
        unreadable, or any leaf's shape or dtype differs from the
        template's (``template.state`` is a TrainState whose tensors may
        live on the meta device; ``template.base_params`` None means no
        base is expected)."""
        from .engine.train import AdamWState, TrainState
        step = self.latest_step()
        if step is None:
            return None
        meta = self.read_meta()
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        try:
            raw = ser.load_file(path)
            st = raw["state"]
            params, opt = st["params"], st["opt_state"]
            mu, nu = opt["mu"], opt["nu"]
            base = raw.get("base_params")
            step_no, count = int(st["step"]), int(opt["count"])
        except (OSError, ser.PayloadError, KeyError, TypeError,
                ValueError):
            logger.warning("checkpoint %s is unreadable", path,
                           exc_info=True)
            return None
        t = template.state
        if meta is None or not all(
                isinstance(x, dict) for x in (params, mu, nu)) \
                or not _matches(params, t.params) \
                or not _matches(mu, t.opt_state.mu) \
                or not _matches(nu, t.opt_state.nu):
            logger.warning("checkpoint %s does not match the template",
                           path)
            return None
        if (template.base_params is None) != (base is None) or (
                base is not None and not _matches(base,
                                                  template.base_params)):
            logger.warning("checkpoint %s: base does not match", path)
            return None
        return Snapshot(
            state=TrainState(step=step_no, params=_tensors(params),
                             opt_state=AdamWState(count=count,
                                                  mu=_tensors(mu),
                                                  nu=_tensors(nu))),
            base_params=None if base is None else _tensors(base),
            base_revision=meta.get("base_revision"),
            lifetime_steps=meta.get("lifetime_steps"))

    def close(self) -> None:
        if self._async_worker is not None:
            # drain first: the newest checkpoint must land
            self._async_worker.close()
            self._async_worker = None
