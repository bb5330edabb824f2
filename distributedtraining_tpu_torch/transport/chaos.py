"""ChaosTransport: deterministic fault injection over any Transport — the
port of the JAX package's ``transport/chaos.py`` (standard library only),
with its fault model, draw order and counters.

The remediation layer (``engine/remediate.py``) exists for the failure
modes fleet-scale operation makes routine (wedged miners, partitioned
backends, a dead averager), and none of those can be provoked reliably
by running long and hoping. This wrapper (the decorator pattern of
``transport/signed.py``) makes every failure mode an *input*:

- **error rates**: each publish/fetch class of operation fails with a
  configured probability, drawn from a SEEDED ``random.Random`` whose
  consumption order is fixed (one draw per faultable operation, in call
  order), so a (seed, call sequence) always produces the same faults;
- **latency**: a fixed per-operation sleep (and optional deterministic
  jitter from the same stream);
- **partitions**: every operation naming a partitioned hotkey raises;
- **kill switches per role**: ``kill_role("averager")`` makes EVERY
  operation through that role's transport raise;
- **schedule**: ``(at_op, action, target)`` events applied as the global
  operation counter passes ``at_op``.

The gate checks kill, then partition, then latency, then the rate, after
exactly one draw. Faults are ``ChaosError`` (an ``OSError``), so every
isolation and retry path exercises the code it would on a real outage,
and each is counted in the obs registry (``chaos.faults``,
``chaos.<kind>_faults``). ``neurons/common.build`` wraps the outermost
transport layer with it under ``--chaos-spec`` (a JSON object of
:class:`ChaosSpec`'s fields).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import threading
import time
from typing import Any, Callable, Sequence

from ..utils import obs

logger = logging.getLogger(__name__)

Params = Any


class ChaosError(OSError):
    """An injected transport fault (an OSError so retry/isolation paths
    treat it exactly like a real backend failure)."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Static fault configuration (the schedule/toggles are runtime state
    on the transport). Rates are per-operation probabilities in [0, 1].

    ``latency_jitter`` scales the fixed latency by a deterministic factor
    in [1-j, 1+j] drawn from the seeded stream, so latency variation is
    reproducible too.
    """
    publish_error_rate: float = 0.0
    fetch_error_rate: float = 0.0
    latency_s: float = 0.0
    latency_jitter: float = 0.0
    partitioned: tuple = ()          # hotkeys unreachable from the start
    killed_roles: tuple = ()         # roles dead from the start
    seed: int = 0

    def __post_init__(self):
        for name in ("publish_error_rate", "fetch_error_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {self.latency_s}")
        if not 0.0 <= self.latency_jitter <= 1.0:
            raise ValueError(f"latency_jitter must be in [0, 1], "
                             f"got {self.latency_jitter}")

    @classmethod
    def from_json(cls, text: str) -> "ChaosSpec":
        """Build from a JSON object (the --chaos-spec CLI surface). Lists
        become tuples; unknown keys are an error — a typo'd rate silently
        injecting nothing defeats the point of a chaos run."""
        raw = json.loads(text)
        if not isinstance(raw, dict):
            raise ValueError(f"chaos spec must be a JSON object, got "
                             f"{type(raw).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown chaos spec keys {sorted(unknown)}; "
                             f"expected a subset of {sorted(fields)}")
        for k in ("partitioned", "killed_roles"):
            if k in raw:
                raw[k] = tuple(raw[k])
        return cls(**raw)


# one schedule event: when the GLOBAL op counter reaches ``at_op``, apply
# ``action`` ("kill_role" | "revive_role" | "partition" | "heal") to
# ``target``. Events are sorted by at_op and applied at most once.
@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    at_op: int
    action: str
    target: str

    _ACTIONS = ("kill_role", "revive_role", "partition", "heal")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}; "
                             f"expected one of {self._ACTIONS}")


class ChaosTransport:
    """Wrap ``inner`` with the fault model of ``spec``.

    ``role`` is the OWNING role's name (what ``kill_role`` matches);
    ``sleep`` is injectable so tests run latency schedules on a fake
    clock. Runtime toggles (:meth:`kill_role` etc.) and the event
    schedule mutate shared state under a lock — the ingest pool calls in
    from its worker threads.
    """

    def __init__(self, inner, spec: ChaosSpec | None = None, *,
                 role: str | None = None,
                 schedule: Sequence[ChaosEvent] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.spec = spec or ChaosSpec()
        self.role = role
        self._sleep = sleep
        self._rng = random.Random(self.spec.seed)
        self._lock = threading.Lock()
        self._partitioned: set[str] = set(self.spec.partitioned)
        self._killed: set[str] = set(self.spec.killed_roles)
        self._schedule = sorted(schedule or (), key=lambda e: e.at_op)
        self._next_event = 0
        self.ops = 0            # global op counter (drives the schedule)
        self.faults = 0

    # -- runtime fault control ----------------------------------------------
    def kill_role(self, role: str) -> None:
        with self._lock:
            self._killed.add(role)

    def revive_role(self, role: str) -> None:
        with self._lock:
            self._killed.discard(role)

    def partition(self, hotkey: str) -> None:
        with self._lock:
            self._partitioned.add(hotkey)

    def heal(self, hotkey: str) -> None:
        with self._lock:
            self._partitioned.discard(hotkey)

    def partitioned(self) -> set[str]:
        with self._lock:
            return set(self._partitioned)

    # -- the fault gate ------------------------------------------------------
    def _apply(self, event: ChaosEvent) -> None:
        logger.info("chaos: op %d -> %s(%s)", self.ops, event.action,
                    event.target)
        if event.action == "kill_role":
            self._killed.add(event.target)
        elif event.action == "revive_role":
            self._killed.discard(event.target)
        elif event.action == "partition":
            self._partitioned.add(event.target)
        else:
            self._partitioned.discard(event.target)

    def _fault(self, kind: str, detail: str) -> None:
        self.faults += 1
        obs.count("chaos.faults")
        obs.count(f"chaos.{kind}_faults")
        raise ChaosError(f"chaos[{kind}]: {detail}")

    def _gate(self, kind: str, hotkey: str | None = None) -> None:
        """One faultable operation: advance the schedule, then kill switch
        -> partition -> latency -> error rate, in that order (a dead node
        fails fast; only a live, reachable one pays latency). EXACTLY ONE
        rate draw happens per gate whatever the outcome, so the seeded
        stream stays aligned across runs that toggle switches
        differently."""
        with self._lock:
            self.ops += 1
            while (self._next_event < len(self._schedule)
                   and self._schedule[self._next_event].at_op <= self.ops):
                self._apply(self._schedule[self._next_event])
                self._next_event += 1
            rate = (self.spec.publish_error_rate if kind == "publish"
                    else self.spec.fetch_error_rate)
            roll = self._rng.random()
            jitter = (self._rng.uniform(1 - self.spec.latency_jitter,
                                        1 + self.spec.latency_jitter)
                      if self.spec.latency_jitter else 1.0)
            killed = self.role is not None and self.role in self._killed
            cut = hotkey is not None and hotkey in self._partitioned
        if killed:
            self._fault("killed", f"role {self.role} is killed")
        if cut:
            self._fault("partition", f"hotkey {hotkey} is partitioned")
        if self.spec.latency_s > 0:
            self._sleep(self.spec.latency_s * jitter)
        if rate > 0 and roll < rate:
            self._fault(kind, f"injected {kind} error "
                              f"(rate {rate:g}, op {self.ops})")

    # -- miner side ---------------------------------------------------------
    def publish_delta(self, miner_id: str, delta: Params):
        self._gate("publish", miner_id)
        return self.inner.publish_delta(miner_id, delta)

    def publish_raw(self, miner_id: str, data: bytes):
        self._gate("publish", miner_id)
        return self.inner.publish_raw(miner_id, data)

    def publish_delta_raw(self, miner_id: str, data: bytes):
        self._gate("publish", miner_id)
        pdr = getattr(self.inner, "publish_delta_raw", None)
        if pdr is not None:
            return pdr(miner_id, data)
        return self.inner.publish_raw(miner_id, data)

    # wire-v2 shard ops: each shard publish/fetch is its own faultable
    # operation (that is exactly how a mid-publish failure tears a shard
    # set — the torn-set test drives this gate)
    def publish_shard(self, hotkey: str, layer_key: str, data: bytes):
        from . import base
        self._gate("publish", hotkey)
        ps = getattr(self.inner, "publish_shard", None)
        if ps is not None:
            return ps(hotkey, layer_key, data)
        return self.inner.publish_raw(base.shard_id(hotkey, layer_key), data)

    def fetch_shard(self, hotkey: str, layer_key: str):
        from . import base
        self._gate("fetch", hotkey)
        fs = getattr(self.inner, "fetch_shard", None)
        if fs is not None:
            return fs(hotkey, layer_key)
        return self.inner.fetch_delta_bytes(base.shard_id(hotkey, layer_key))

    # base-distribution ops (engine/basedist.py): each shard / manifest
    # publish or fetch is its own faultable operation — a mid-publish
    # fault is exactly how a torn base shard set happens, and a fetch
    # fault is how a fetcher's mirror-failover path gets exercised.
    # Delegation re-dispatches the module helper on the INNER transport
    # so a wrapped backend's own surface (and signing preference) is
    # preserved through the gate.
    def publish_base_shard(self, layer_key: str, data: bytes):
        from . import base
        self._gate("publish")
        return base.publish_base_shard(self.inner, layer_key, data)

    def fetch_base_shard(self, layer_key: str):
        from . import base
        self._gate("fetch")
        return base.fetch_base_shard(self.inner, layer_key)

    def publish_base_manifest(self, revision: str, data: bytes):
        from . import base
        self._gate("publish")
        return base.publish_base_manifest(self.inner, revision, data)

    def fetch_base_manifest(self, revision: str):
        from . import base
        self._gate("fetch")
        return base.fetch_base_manifest_bytes(self.inner, revision)

    def publish_delta_meta(self, miner_id: str, meta: dict) -> None:
        self._gate("publish", miner_id)
        pm = getattr(self.inner, "publish_delta_meta", None)
        if pm is not None:
            pm(miner_id, meta)

    # -- validator / averager side -----------------------------------------
    def fetch_delta(self, miner_id: str, template: Params):
        self._gate("fetch", miner_id)
        return self.inner.fetch_delta(miner_id, template)

    def fetch_delta_bytes(self, miner_id: str):
        self._gate("fetch", miner_id)
        return self.inner.fetch_delta_bytes(miner_id)

    def fetch_delta_meta(self, miner_id: str):
        self._gate("fetch", miner_id)
        fm = getattr(self.inner, "fetch_delta_meta", None)
        return fm(miner_id) if fm is not None else None

    def delta_revision(self, miner_id: str):
        self._gate("fetch", miner_id)
        return self.inner.delta_revision(miner_id)

    # -- base model ---------------------------------------------------------
    def publish_base(self, base: Params):
        self._gate("publish")
        return self.inner.publish_base(base)

    def publish_base_raw(self, data: bytes):
        self._gate("publish")
        return self.inner.publish_base_raw(data)

    def fetch_base(self, template: Params):
        self._gate("fetch")
        return self.inner.fetch_base(template)

    def fetch_base_bytes(self):
        self._gate("fetch")
        return self.inner.fetch_base_bytes()

    def base_revision(self):
        self._gate("fetch")
        return self.inner.base_revision()

    # -- lifecycle ----------------------------------------------------------
    def gc(self) -> None:
        # storage bounding is the loops' housekeeping, not a protocol
        # operation: faulting it would test nothing the publish/fetch
        # gates don't
        self.inner.gc()
