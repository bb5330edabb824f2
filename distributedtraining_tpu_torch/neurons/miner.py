"""Miner entry point of the port: train on the current base, publish
weight deltas — the port of the JAX package's ``neurons/miner.py``.

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.miner \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --fused-loss \
        --no-base-wire-v2 --checkpoint-interval 0 --no-anomaly-trace \
        --flight-events 0 --max-steps 50

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) ``--wire-v2``
publishes the packed top-k form as per-layer shards and a manifest
(``--wire-density``, ``--wire-quant`` tune it). A JAX validator or
averager, or the port's averager, pointed at the same ``--work-dir``
reads its deltas.
"""

from __future__ import annotations

import logging
import time

from ..config import RunConfig
from ..engine.train import MinerLoop
from ..utils import obs
from .common import build


def _guard_kwargs(cfg, c) -> dict:
    """Self-eval guard wiring: 0 disables; negative follows
    --send-interval (and disables when that is non-positive)."""
    if cfg.self_eval_interval == 0:
        return {}
    interval = (cfg.self_eval_interval if cfg.self_eval_interval > 0
                else cfg.send_interval)
    if interval <= 0:
        return {}
    return dict(val_batches=c.miner_val_batches(),
                val_guard_interval=interval,
                val_guard_patience=cfg.self_eval_patience,
                val_guard_margin=cfg.self_eval_margin)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("miner", argv)
    c = build(cfg)
    loop = MinerLoop(c.engine, c.transport, cfg.hotkey,
                     send_interval=cfg.send_interval,
                     check_update_interval=cfg.check_update_interval,
                     log_every=cfg.log_every,
                     delta_dtype=cfg.delta_dtype,
                     wire_v2=cfg.wire_v2,
                     wire_density=cfg.wire_density,
                     wire_quant=cfg.wire_quant,
                     keep_optimizer_on_pull=cfg.keep_optimizer_on_pull,
                     push_async=cfg.push_async,
                     push_queue_depth=cfg.push_queue_depth,
                     **_guard_kwargs(cfg, c))

    def _bootstrap():
        # bounded retry on TRANSPORT errors only (a restart is exactly
        # when the backend may still be partitioned); programming errors
        # re-raise at once, and bootstrap is idempotent
        for attempt in range(3):
            try:
                return loop.bootstrap()
            except OSError:
                if attempt == 2:
                    raise
                delay = 2.0 * (attempt + 1)
                logging.warning("miner bootstrap: transport unreachable "
                                "(attempt %d/3); retrying in %.0fs",
                                attempt + 1, delay, exc_info=True)
                time.sleep(delay)

    batches = None
    try:
        _bootstrap()
        batches = c.train_batches()
        report = loop.run(batches, max_steps=cfg.max_steps)
        loop.flush()  # the final delta, so short runs still publish
    except KeyboardInterrupt:
        report = loop.report
        loop.flush()
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()   # the look-ahead thread
        loop.close()
        obs.reset()
    logging.info("miner done: steps=%d pushes=%d (failed=%d superseded=%d) "
                 "base_pulls=%d loss=%.4f",
                 report.steps, report.pushes, report.pushes_failed,
                 report.pushes_superseded, report.base_pulls,
                 report.last_loss)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
