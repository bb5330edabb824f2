"""Tree aggregation — the port of the JAX package's
``engine/hier_average.py``: sub-averagers fold fanout-sized slices of the
fleet into partial aggregates; a root averager merges the aggregates.

- a :class:`SubAverager` owns a slice of the fleet (``plan_fanout``):
  each round it stages its miners through ``engine/ingest.py`` with
  ``densify=False`` (wire-v2 submissions stay packed), folds the accepted
  ones into one f32 accumulator on its device by
  ``delta.aggregate_deltas`` (a packed contribution is one launch of the
  dequantize-scatter kernel on the card; no M x params stack, no
  densify), and publishes the consensus-weighted average as an ordinary
  delta artifact under the reserved ``__agg__.<node>`` id with an
  ``{"agg": {"weight", "miners", "node"}}`` rider — dense, or under
  ``wire_spec`` the lossless v2 form (density 1, quant none);
- the root is :class:`~.average.AveragerLoop` with ``hierarchy=[node
  ids]``: it stages the ``__agg__.*`` ids, reads each subtree's mass off
  the rider, and merges the aggregates through its strategy.

Exactness: a sub publishes ``a_j = sum_{i in j} (c_i / C_j) d_i`` and
declares ``C_j`` (its clamped consensus mass; its miner count when the
subtree has no scores). The root mixes with ``C_j / sum_j C_j``, so the
tree telescopes to the flat merge ``sum_i (c_i / C) d_i`` (to f32
rounding). A dead or torn sub stages as absent or stale at the root,
which degrades to the surviving subtrees.

Per node, ``lease`` (``engine/remediate.LeaseManager``, role
``subavg.<node>``) makes publication single-writer, ``lineage`` freezes
an "agg" record per published aggregate, and ``mirror``
(``engine/basedist.MirrorDuty``) replicates the base's shards before
each fold; ``fleet`` (``engine/health.FleetMonitor``) polls the slice's
heartbeats and sees every staging outcome, and ``metrics`` gets one
record a round.

On a world of several processes (``multi=True``: ``torchrun`` or the
``--multihost-*`` flags) the coordinator reads what every rank needs —
the base revision, the assigned slice, the consensus, every submission
(``stage(multi=True)``) — and broadcasts it; every rank folds the same
contributions in the same order, a wire-v2 one packed as on one process
(so its aggregate is the one-process node's, bit for bit), and the
coordinator alone renews the lease,
publishes the ``__agg__.<node>`` artifact and stamps the lease, each
verdict broadcast.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Sequence

import numpy as np
import torch

from .. import delta as delta_lib
from ..transport.base import agg_id
from ..utils import obs
from .scheduler import Clock, RealClock

logger = logging.getLogger(__name__)


def plan_fanout(hotkeys: Sequence[str], *,
                nodes: Sequence[str] | None = None,
                fanout: int | None = None) -> dict[str, list[str]]:
    """Deterministic miner -> sub-averager assignment: round-robin over
    the SORTED hotkeys onto ``nodes`` (the stable spelling), or, with
    ``fanout`` alone, onto ``ceil(M / fanout)`` nodes named
    ``sub0..subN-1``. Every node appears, possibly with an empty slice."""
    keys = sorted(dict.fromkeys(hotkeys))
    if nodes:
        node_list = list(dict.fromkeys(nodes))
    else:
        if not fanout or fanout < 1:
            raise ValueError("plan_fanout: pass nodes=[...] or fanout >= 1")
        n = max(1, -(-len(keys) // fanout)) if keys else 1
        node_list = [f"sub{i}" for i in range(n)]
    plan: dict[str, list[str]] = {n: [] for n in node_list}
    for i, h in enumerate(keys):
        plan[node_list[i % len(node_list)]].append(h)
    return plan


def subtree_weights(ids: Sequence[str], consensus: dict[str, float] | None
                    ) -> tuple[np.ndarray, float]:
    """(normalized (m,) mixing vector, declared weight mass) of one
    subtree: ``delta.normalized_merge_weights`` and the subtree's clamped
    consensus total, or its miner count when it carries no score mass
    (under which the root's ``C_j / sum C_j`` telescopes to uniform)."""
    w = delta_lib.normalized_merge_weights(ids, consensus)
    if consensus:
        mass = float(sum(max(float(consensus.get(h, 0.0)), 0.0)
                         for h in ids))
        if np.isfinite(mass) and mass > 0:
            return w, mass
    return w, float(len(ids))


@dataclasses.dataclass
class SubAveragerReport:
    rounds: int = 0
    last_accepted: int = 0
    last_rejected: int = 0
    pushes: int = 0                 # DeltaPublisher's counter fields
    pushes_failed: int = 0
    pushes_superseded: int = 0
    skipped_publishes: int = 0      # lease stand-downs
    last_weight_sum: float = float("nan")


class SubAverager:
    """One node of the tree: gather the assigned slice, publish the
    partial aggregate.

    No engine and no eval set: delta arithmetic in wire layout against
    ``template`` (the wire-layout host template, or a zero-argument
    supplier of it), folded on ``device`` (the card unless the caller
    asks for the CPU). ``assigned`` and ``consensus`` are values or
    zero-argument callables read each round. ``wire_spec`` (True for the
    lossless ``{"format": 2, "density": 1.0, "quant": "none"}``) publishes
    the aggregate as v2 shards and a manifest; None as a dense v1
    artifact."""

    def __init__(self, transport, node_id: str, template, assigned, *,
                 consensus: Callable[[], dict] | dict | None = None,
                 max_delta_abs: float | None = 1e3,
                 stale_deltas: str = "skip",
                 accept_quant: bool = True,
                 accept_wire_v2: bool = True,
                 lora_cfg=None,
                 ingest_workers: int = 4,
                 ingest_cache_mb: int = 2048,
                 wire_spec: dict | bool | None = None,
                 lease=None,
                 lineage=None,
                 mirror=None,
                 metrics=None,
                 fleet=None,
                 multi: bool = False,
                 device="cuda",
                 clock: Clock | None = None):
        from ..models.gpt2 import resolve_device
        self.transport = transport
        self.node_id = node_id
        self.artifact_id = agg_id(node_id)
        self._template_in = template
        self._template_cache = None
        self._assigned = assigned
        self._consensus = consensus
        self.max_delta_abs = max_delta_abs
        self.stale_deltas = stale_deltas
        self.accept_quant = accept_quant
        self.accept_wire_v2 = accept_wire_v2
        # LoRA submissions (models.lora.LoRAConfig): densified at staging
        self.lora_cfg = lora_cfg
        self.ingest_workers = ingest_workers
        self.ingest_cache_mb = ingest_cache_mb
        if wire_spec is True:
            wire_spec = {"format": 2, "density": 1.0, "quant": "none"}
        self.wire_spec = wire_spec or None
        self.lease = lease
        self.lineage = lineage
        self.mirror = mirror
        self.metrics = metrics
        # the fleet health plane (the coordinator's, on a world)
        self.fleet = fleet
        self.multi = multi
        self.device = resolve_device(device)
        self.clock = clock or RealClock()
        self.report = SubAveragerReport()
        self._ingestor = None
        self._publisher = None
        self._acc_template = None

    # -- lazy plumbing -------------------------------------------------------
    def _template(self):
        if self._template_cache is None:
            t = self._template_in
            self._template_cache = t() if callable(t) else t
        return self._template_cache

    def _fold_template(self) -> dict[str, torch.Tensor]:
        """The fold's shape and device source (``aggregate_deltas``
        allocates the zeroed accumulator): the template's shapes as
        expanded views of one scalar on this node's device."""
        if self._acc_template is None:
            one = torch.zeros((), dtype=torch.float32, device=self.device)
            self._acc_template = {
                k: one.expand(tuple(np.shape(v)))
                for k, v in delta_lib.flatten_tree(self._template()).items()}
        return self._acc_template

    def _ingest(self):
        if self._ingestor is None:
            from .ingest import DeltaIngestor
            self._ingestor = DeltaIngestor(
                self.transport, self._template,
                lora_cfg=self.lora_cfg,
                accept_quant=self.accept_quant,
                accept_wire_v2=self.accept_wire_v2,
                max_delta_abs=self.max_delta_abs,
                stale_deltas=self.stale_deltas,
                workers=self.ingest_workers,
                cache_bytes=self.ingest_cache_mb * (1 << 20),
                span_prefix="subavg",
                observer=(self.fleet.record_staging
                          if self.fleet is not None else None),
                densify=False)   # packed submissions fold in packed form
        return self._ingestor

    def _pub(self):
        if self._publisher is None:
            from .publish import DeltaPublisher
            self._publisher = DeltaPublisher(
                self.transport, self.artifact_id, report=self.report,
                nan_guard=False,   # the inputs are screened finite
                wire_spec=self.wire_spec)
        return self._publisher

    def assigned(self) -> list[str]:
        a = self._assigned() if callable(self._assigned) else self._assigned
        return list(a)

    def consensus(self) -> dict[str, float]:
        c = self._consensus() if callable(self._consensus) \
            else self._consensus
        return dict(c) if c else {}

    def close(self) -> None:
        if self._ingestor is not None:
            self._ingestor.close()
        if self._publisher is not None:
            self._publisher.close()
        if self.fleet is not None:
            self.fleet.close()

    def _shared(self, fn, what: str):
        """``fn()``'s JSON-able result: on a world the coordinator's, on
        every rank."""
        if not self.multi:
            return fn()
        from .train import coordinator_call
        return coordinator_call(fn, what)

    # -- one round -----------------------------------------------------------
    def run_round(self) -> bool:
        """Gather the slice, fold, publish. True when an aggregate was
        computed (whether or not the lease let it publish); False on an
        empty round, which publishes nothing, so the root's stale skip
        retires the previous aggregate against a moved base."""
        try:
            base_revision = self._shared(self.transport.base_revision,
                                         "base revision probe")
        except Exception:
            logger.warning("subavg %s: base revision probe failed; staging "
                           "without staleness context", self.node_id,
                           exc_info=True)
            base_revision = None
        assigned = self._shared(self.assigned, "slice assignment")
        if self.mirror is not None:
            # before the fold, and on every round: the replica should be
            # warm when this subtree's miners pull the base
            try:
                with obs.span("subavg.mirror", node=self.node_id):
                    self.mirror.sync()
            except Exception:
                logger.exception("subavg %s: mirror sync failed",
                                 self.node_id)
        if self.fleet is not None:
            try:
                self.fleet.poll(assigned)
            except Exception:
                logger.exception("subavg %s: fleet poll failed",
                                 self.node_id)
        staged = (self._ingest().stage(assigned, base_revision=base_revision,
                                       multi=self.multi)
                  if assigned else [])
        ids, deltas = [], []
        staged_by_hotkey = {}
        rejected = 0
        for s in staged:
            if s.delta is None:
                if s.reason != "no_delta":
                    rejected += 1
                continue
            ids.append(s.hotkey)
            staged_by_hotkey[s.hotkey] = s
            deltas.append(s.delta)
        self.report.last_accepted = len(ids)
        self.report.last_rejected = rejected
        if not ids:
            logger.info("subavg %s: no valid deltas this round",
                        self.node_id)
            obs.count("hier.empty_sub_rounds")
            self.report.rounds += 1
            return False
        w, mass = subtree_weights(ids, self._shared(self.consensus,
                                                    "consensus read"))
        self.report.last_weight_sum = mass
        with obs.span("subavg.merge", node=self.node_id, miners=len(ids)):
            # one accumulator, one contribution at a time
            agg = delta_lib.aggregate_deltas(self._fold_template(), deltas,
                                             w)
        if self.lease is not None and not self._lease_held():
            logger.warning("subavg %s: publication lease not held; "
                           "standing down (merged but not published)",
                           self.node_id)
            obs.count("hier.lease_standdowns")
            self.report.skipped_publishes += 1
            self.report.rounds += 1
            return True
        with obs.span("subavg.publish", node=self.node_id):
            ok = self._publish(agg, base_revision, mass, len(ids),
                               ids, w, staged_by_hotkey)
        if self.metrics:
            try:
                self.metrics.log({"subavg_node": self.node_id,
                                  "accepted": len(ids),
                                  "rejected": rejected,
                                  "weight_sum": mass,
                                  "published": int(ok)},
                                 step=self.report.rounds)
                obs.flush(self.metrics, step=self.report.rounds)
            except Exception:
                logger.exception("subavg %s: metrics emit failed",
                                 self.node_id)
        self.report.rounds += 1
        return True

    def _publish(self, agg, base_revision, mass: float, miners: int,
                 ids, w, staged_by_hotkey) -> bool:
        """Publish the aggregate (packed under ``wire_spec``) and, when
        it landed, stamp the lease and freeze the lineage record: the
        coordinator's work on a world, whose verdict every rank gets."""
        def publish() -> bool:
            payload = agg
            if self.wire_spec:
                payload, _ = delta_lib.pack_delta_v2(
                    agg, density=float(self.wire_spec.get("density", 1.0)),
                    quant=self.wire_spec.get("quant", "none"))
            ok = self._pub().publish_now(
                payload, None, base_revision,
                extra_meta={"agg": {"weight": mass, "miners": miners,
                                    "node": self.node_id}})
            if ok:
                obs.count("hier.agg_publishes")
                if self.lease is not None:
                    self.lease.stamp(base_revision)
                if self.lineage is not None:
                    self._record_lineage(ids, w, staged_by_hotkey,
                                         base_revision)
            return bool(ok)
        try:
            return bool(self._shared(publish, "aggregate publish"))
        except RuntimeError:
            if not self.multi:
                raise
            logger.exception("subavg %s: the coordinator's publish failed",
                             self.node_id)
            return False

    def _lease_held(self) -> bool:
        """The renewal verdict (the coordinator's on a world); any
        failure reads as not held."""
        try:
            return bool(self._shared(self.lease.renew, "lease renew"))
        except Exception:
            logger.exception("subavg %s: lease renewal failed", self.node_id)
            return False

    def _record_lineage(self, ids: list[str], w, staged: dict,
                        base_revision: str | None) -> None:
        """The published aggregate's "agg" record: its revision is the
        aggregate artifact's (probed after the publish), its parent the
        base the fold ran against, its weights the normalized subtree
        vector. Isolated: a lineage failure never fails the round."""
        try:
            from . import lineage as lineage_lib
            try:
                rev = self.transport.delta_revision(self.artifact_id)
            except Exception:
                logger.warning("subavg %s: aggregate revision probe "
                               "failed; lineage record skipped",
                               self.node_id, exc_info=True)
                return
            if rev is None:
                return
            weights = [float(x) for x in np.asarray(w).reshape(-1)]
            contribs = lineage_lib.contributions_from_staging(
                ids, weights, staged, consensus=self.consensus())
            self.lineage.on_publish(
                kind="agg", revision=rev, parent=base_revision,
                round_no=self.report.rounds, contributions=contribs,
                strategy="weighted", replayable=not self.wire_spec
                or self.wire_spec.get("quant", "none") == "none",
                weights_kind="merge", artifact=self.artifact_id)
        except Exception:
            logger.exception("subavg %s: lineage record failed",
                             self.node_id)

    def run_periodic(self, *, interval: float = 1200.0,
                     rounds: int | None = None) -> int:
        """Run rounds forever (or ``rounds`` times); returns how many
        rounds aggregated at least one delta."""
        done = merged = 0
        while rounds is None or done < rounds:
            try:
                if self.run_round():
                    merged += 1
            except Exception:
                logger.exception("subavg %s: round failed; continuing",
                                 self.node_id)
            done += 1
            if rounds is None or done < rounds:
                self.clock.sleep(interval)
        return merged
