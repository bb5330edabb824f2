"""Validator entry point of the port: score every miner's delta, emit
chain weights — the port of the JAX package's ``neurons/validator.py``
on one host.

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.validator \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --hotkey hotkey_91 --rounds 1

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) Base pulls go
through the published manifest (``--base-wire-v2``), and the flight
recorder keeps ``--flight-events`` events. Miners of either
package publishing into the same ``--work-dir`` are scored; the weights
land in the local chain, where an averager of either package reads them
through ``consensus_scores()``. A hotkey without a validator permit is
refused unless ``--allow-no-vpermit`` is given, and then emits no
weights.
"""

from __future__ import annotations

import logging

from ..config import RunConfig
from ..engine.validate import Validator
from ..utils import flight, obs
from .common import build, build_base_fetcher


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("validator", argv)
    c = build(cfg)
    flight.install_crash_hooks()   # see neurons/miner.py
    validator = Validator(c.engine, c.transport, c.chain,
                          eval_batches=c.eval_batches(),
                          metric=cfg.score_metric,
                          max_delta_abs=cfg.max_delta_abs,
                          accept_quant=cfg.accept_quant,
                          accept_wire_v2=cfg.accept_wire_v2,
                          stale_deltas=cfg.stale_deltas or "accept",
                          cohort_size=cfg.val_cohort,
                          pipeline_depth=cfg.val_pipeline_depth,
                          ingest_workers=cfg.ingest_workers,
                          ingest_cache_mb=cfg.ingest_cache_mb,
                          base_fetcher=build_base_fetcher(cfg, c))
    # the reference gates weight-setting to staked validators
    # (btt_connector.py:358-385): refuse up front rather than spend eval
    # compute on scores no one will see
    if not validator.has_vpermit():
        if not cfg.allow_no_vpermit:
            flight.reset()
            raise SystemExit(
                f"hotkey {c.chain.my_hotkey} holds no validator permit "
                f"(stake < {cfg.vpermit_stake_limit}); pass "
                f"--allow-no-vpermit to run anyway without emitting weights")
        logging.warning("running WITHOUT a validator permit: weights will "
                        "not be emitted")
    try:
        validator.bootstrap()
        ok = validator.run_periodic(interval=cfg.validation_interval,
                                    rounds=cfg.rounds)
    except KeyboardInterrupt:
        logging.info("validator interrupted; exiting")
        return 0
    finally:
        validator.close()   # drain the ingest pool's worker threads
        flight.shutdown()   # see neurons/miner.py
        obs.reset()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
