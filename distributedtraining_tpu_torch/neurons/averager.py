"""Averager entry point of the port: merge miner deltas into the next
base model — the port of the JAX package's ``neurons/averager.py``.

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.averager \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --rounds 1

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) Each publish is
followed by the base's changed shards and manifest (``--base-wire-v2``)
and a lineage record (``--lineage``, with the quality-drift detector);
the flight recorder keeps ``--flight-events`` events. Miners of either
package, publishing dense deltas or ``--wire-v2`` shards into the same
``--work-dir``, are merged: by meta-learned weights (``--strategy
parameterized``, the default: ``--meta-epochs``, ``--meta-lr``,
``--meta-optimizer``), or by the local chain's consensus scores
(``--strategy weighted``; a validator's ``set_weights`` in that
directory, from either package). ``--outer-momentum`` (with
``--outer-lr``) wraps the strategy in the outer Nesterov step, its
velocity kept in ``<work-dir>/averager_state/velocity_<hotkey>.msgpack``.

``--hier sub`` makes this process one node of a tree (``--hier-node``,
its slice from ``--hier-nodes`` or ``--hier-fanout``): it folds its
miners and publishes the partial aggregate (``--hier-wire-v2``: as
lossless v2 shards), mirroring the base's shards (``--base-mirror``, on
with ``--base-wire-v2``); ``--hier root`` merges those aggregates.
``--standby`` follows a primary and takes the publication lease over
after ``--failover-deadline`` seconds without progress. With
``--sign-artifacts`` every artifact is signed by the hotkey's wallet.
"""

from __future__ import annotations

import logging

from ..config import RunConfig
import os

from ..engine.average import (AveragerLoop, GeneticMerge, OuterOptMerge,
                              ParameterizedMerge, WeightedAverage)
from ..utils import flight, obs
from .common import base_mirrors, build


def make_strategy(cfg: RunConfig, model):
    """The merge strategy of ``--strategy`` (``genetic`` raises, naming
    its slice), inside ``OuterOptMerge`` with ``--outer-momentum`` > 0."""
    if cfg.strategy == "weighted":
        strategy = WeightedAverage(chunk_size=cfg.merge_chunk)
    elif cfg.strategy == "genetic":
        strategy = GeneticMerge(
            population=cfg.genetic_population,
            generations=cfg.genetic_generations, sigma=cfg.genetic_sigma,
            screen_batches=cfg.genetic_screen_batches or None)
    else:
        strategy = ParameterizedMerge(model, meta_epochs=cfg.meta_epochs,
                                      meta_lr=cfg.meta_lr,
                                      meta_optimizer=cfg.meta_optimizer)
    if cfg.outer_momentum > 0:
        strategy = OuterOptMerge(
            strategy, outer_lr=cfg.outer_lr, momentum=cfg.outer_momentum,
            # the velocity survives a supervised restart
            state_path=os.path.join(cfg.work_dir, "averager_state",
                                    f"velocity_{cfg.hotkey}.msgpack"))
    return strategy


def _hier_nodes(cfg: RunConfig) -> list[str]:
    return [n.strip() for n in (cfg.hier_nodes or "").split(",")
            if n.strip()]


def _run_sub_averager(cfg: RunConfig, c) -> int:
    """``--hier sub``: fold this node's ``plan_fanout`` slice and publish
    the partial aggregate under ``__agg__.<node>``. No eval set, no
    strategy, no base publication; with ``--standby`` a per-node
    ``subavg.<node>`` lease guards the publish."""
    from ..engine.hier_average import SubAverager, plan_fanout
    from ..engine.train import _wire_template

    nodes = _hier_nodes(cfg)
    node = cfg.hier_node or cfg.hotkey
    if not nodes and cfg.hier_fanout <= 0:
        raise SystemExit("--hier sub needs --hier-nodes or --hier-fanout "
                         "to derive this node's miner slice")
    if nodes and node not in nodes:
        raise SystemExit(f"--hier-node {node!r} is not in --hier-nodes "
                         f"{nodes} — the slice plan would never assign "
                         "it a miner")

    def assigned():
        meta = c.chain.sync()
        hotkeys = [h for h in meta.hotkeys if h != cfg.hotkey]
        plan = plan_fanout(hotkeys, nodes=nodes or None,
                           fanout=cfg.hier_fanout or None)
        return plan.get(node, [])

    lease = None
    if cfg.standby:
        from ..engine.remediate import LeaseManager
        lease = LeaseManager(c.transport, cfg.hotkey, role=f"subavg.{node}")
    lineage = None
    if cfg.lineage:
        from ..engine.lineage import LineagePlane
        lineage = LineagePlane(c.transport, node=f"subavg.{node}")
    mirror = None
    if cfg.base_wire_v2 and cfg.base_mirror:
        # this node re-publishes the base shards under __mirror__.<node>,
        # so nearby fetchers race a replica instead of the origin
        from ..engine.basedist import MirrorDuty
        mirror = MirrorDuty(c.transport, node)
    sub = SubAverager(
        c.transport, node, lambda: _wire_template(c.engine.model), assigned,
        consensus=lambda: getattr(c.chain, "consensus_scores",
                                  lambda: {})(),
        max_delta_abs=cfg.max_delta_abs,
        stale_deltas=cfg.stale_deltas or "skip",
        accept_quant=cfg.accept_quant,
        accept_wire_v2=cfg.accept_wire_v2,
        ingest_workers=cfg.ingest_workers,
        ingest_cache_mb=cfg.ingest_cache_mb,
        wire_spec=True if cfg.hier_wire_v2 else None,
        lease=lease, lineage=lineage, mirror=mirror,
        device=c.engine.device)
    try:
        merged = sub.run_periodic(interval=cfg.averaging_interval,
                                  rounds=cfg.rounds)
    except KeyboardInterrupt:
        merged = sub.report.rounds
    finally:
        sub.close()
        flight.shutdown()
        obs.reset()
    logging.info("sub-averager %s done: rounds=%d accepted=%d pushes=%d",
                 node, sub.report.rounds, sub.report.last_accepted,
                 sub.report.pushes)
    return 0 if merged else 1


def _hierarchy(cfg: RunConfig, c) -> list[str] | None:
    """``--hier root``: the sub-averager node ids to gather from
    (``--hier-nodes``, or the auto-named nodes of ``--hier-fanout`` over
    the boot-time metagraph)."""
    if cfg.hier != "root":
        return None
    from ..engine.hier_average import plan_fanout
    hierarchy = _hier_nodes(cfg)
    if not hierarchy and cfg.hier_fanout > 0:
        meta = c.chain.sync()
        hierarchy = list(plan_fanout(
            [h for h in meta.hotkeys if h != cfg.hotkey],
            fanout=cfg.hier_fanout))
    if not hierarchy:
        raise SystemExit("--hier root needs --hier-nodes (or "
                         "--hier-fanout) to know which __agg__ "
                         "artifacts to gather")
    return hierarchy


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("averager", argv)
    c = build(cfg)
    flight.install_crash_hooks()   # see neurons/miner.py
    if cfg.hier == "sub":
        return _run_sub_averager(cfg, c)
    hierarchy = _hierarchy(cfg, c)
    # the publication lease keeps base publication single-writer across a
    # standby takeover (--remediate, which also holds one in the JAX
    # package, is slice 7)
    lease = None
    if cfg.standby:
        from ..engine.remediate import LeaseManager
        lease = LeaseManager(c.transport, cfg.hotkey)
    # detection and counters only (no train loop here to tick a capture):
    # a quality drift of the lineage plane arms it
    from ..utils.obs import AnomalyMonitor
    lineage = None
    if cfg.lineage:
        from ..engine.lineage import LineagePlane
        lineage = LineagePlane(c.transport, node=cfg.hotkey,
                               anomaly=AnomalyMonitor())
    base_dist = None
    if cfg.base_wire_v2:
        from ..engine.basedist import BasePublisher
        # the tree's nodes mirror the base's shards: announce them
        mirror_nodes = list(hierarchy or [])
        mirror_nodes += [m for m in base_mirrors(cfg)
                         if m not in mirror_nodes]
        base_dist = BasePublisher(c.transport, mirrors=mirror_nodes)
    loop = AveragerLoop(c.engine, c.transport, c.chain,
                        make_strategy(cfg, c.model),
                        val_batches=c.eval_batches(),
                        address_store=c.address_store,
                        max_delta_abs=cfg.max_delta_abs,
                        accept_quant=cfg.accept_quant,
                        accept_wire_v2=cfg.accept_wire_v2,
                        stale_deltas=cfg.stale_deltas or "skip",
                        publish_policy=cfg.publish_policy,
                        ingest_workers=cfg.ingest_workers,
                        ingest_cache_mb=cfg.ingest_cache_mb,
                        lineage=lineage, base_dist=base_dist,
                        lease=lease, hierarchy=hierarchy)
    try:
        if cfg.standby:
            # a passive replica: no bootstrap (it must never publish a
            # genesis base or take the lease at boot); it follows the
            # primary and bootstraps at takeover
            from ..engine.remediate import StandbyAverager
            standby = StandbyAverager(
                loop, lease,
                deadline_s=(cfg.failover_deadline
                            or 3 * cfg.averaging_interval),
                poll_s=max(1.0, min(cfg.averaging_interval / 4, 30.0)))
            merged = standby.run(interval=cfg.averaging_interval,
                                 rounds=cfg.rounds)
        else:
            loop.bootstrap()
            merged = loop.run_periodic(interval=cfg.averaging_interval,
                                       rounds=cfg.rounds)
    except KeyboardInterrupt:
        merged = loop.report.rounds > 0
    finally:
        loop.close()   # drain the ingest pool's worker threads
        flight.shutdown()   # see neurons/miner.py
        obs.reset()
    logging.info("averager done: rounds=%d accepted=%d rejected=%d loss=%.4f",
                 loop.report.rounds, loop.report.last_accepted,
                 loop.report.last_rejected, loop.report.last_loss)
    return 0 if merged else 1


if __name__ == "__main__":
    raise SystemExit(main())
