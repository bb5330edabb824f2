"""Averager entry point of the port: merge miner deltas into the next
base model — the port of the JAX package's ``neurons/averager.py`` on the
flat path (no ``--hier``, no lease).

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
directory, from either package).
"""

from __future__ import annotations

import logging

from ..config import RunConfig
from ..engine.average import (AveragerLoop, GeneticMerge, ParameterizedMerge,
                              WeightedAverage)
from ..utils import flight, obs
from .common import base_mirrors, build


def make_strategy(cfg: RunConfig, model):
    """The merge strategy of ``--strategy`` (``genetic`` raises, naming
    its slice; ``--outer-momentum`` is refused by the config check)."""
    if cfg.strategy == "weighted":
        return WeightedAverage(chunk_size=cfg.merge_chunk)
    if cfg.strategy == "genetic":
        return GeneticMerge(
            population=cfg.genetic_population,
            generations=cfg.genetic_generations, sigma=cfg.genetic_sigma,
            screen_batches=cfg.genetic_screen_batches or None)
    return ParameterizedMerge(model, meta_epochs=cfg.meta_epochs,
                              meta_lr=cfg.meta_lr,
                              meta_optimizer=cfg.meta_optimizer)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("averager", argv)
    c = build(cfg)
    flight.install_crash_hooks()   # see neurons/miner.py
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
        base_dist = BasePublisher(c.transport, mirrors=base_mirrors(cfg))
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
                        lineage=lineage, base_dist=base_dist)
    try:
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
