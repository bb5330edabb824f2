"""Averager entry point of the port: merge miner deltas into the next
base model — the port of the JAX package's ``neurons/averager.py`` on the
flat path (no ``--hier``, no lease, no lineage, no sharded base).

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.averager \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --strategy weighted \
        --no-base-wire-v2 --no-lineage --flight-events 0 --rounds 1

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) Miners of either
package, publishing dense deltas or ``--wire-v2`` shards into the same
``--work-dir``, are merged; the weights come from the local chain's
consensus scores (a JAX validator's ``set_weights`` in that directory).
"""

from __future__ import annotations

import logging

from ..config import RunConfig
from ..engine.average import AveragerLoop, WeightedAverage
from ..utils import obs
from .common import build


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("averager", argv)
    c = build(cfg)
    loop = AveragerLoop(c.engine, c.transport, c.chain,
                        WeightedAverage(chunk_size=cfg.merge_chunk),
                        val_batches=c.eval_batches(),
                        address_store=c.address_store,
                        max_delta_abs=cfg.max_delta_abs,
                        accept_quant=cfg.accept_quant,
                        accept_wire_v2=cfg.accept_wire_v2,
                        stale_deltas=cfg.stale_deltas or "skip",
                        publish_policy=cfg.publish_policy,
                        ingest_workers=cfg.ingest_workers,
                        ingest_cache_mb=cfg.ingest_cache_mb)
    try:
        loop.bootstrap()
        merged = loop.run_periodic(interval=cfg.averaging_interval,
                                   rounds=cfg.rounds)
    except KeyboardInterrupt:
        merged = loop.report.rounds > 0
    finally:
        loop.close()   # drain the ingest pool's worker threads
        obs.reset()
    logging.info("averager done: rounds=%d accepted=%d rejected=%d loss=%.4f",
                 loop.report.rounds, loop.report.last_accepted,
                 loop.report.last_rejected, loop.report.last_loss)
    return 0 if merged else 1


if __name__ == "__main__":
    raise SystemExit(main())
