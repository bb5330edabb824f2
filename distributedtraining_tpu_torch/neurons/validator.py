"""Validator entry point of the port: score every miner's delta, emit
chain weights — the port of the JAX package's ``neurons/validator.py``
on one host.

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.validator \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --hotkey hotkey_91 --rounds 1

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) On N cards of
one host, ``torchrun --nproc-per-node N -m
distributedtraining_tpu_torch.neurons.validator ...`` (or the
``--multihost-*`` flags, one process a card) runs one validator whose
ranks evaluate their blocks of each cohort; the coordinator reads the
transport and the chain, and alone sets weights. Base pulls go
through the published manifest (``--base-wire-v2``), and the flight
recorder keeps ``--flight-events`` events. Miners of either
package publishing into the same ``--work-dir`` are scored; the weights
land in the local chain, where an averager of either package reads them
through ``consensus_scores()``. A hotkey without a validator permit is
refused unless ``--allow-no-vpermit`` is given, and then emits no
weights. ``--heartbeat-interval S`` beats every S seconds and monitors
the fleet's beats (the contribution ledger, the SLO rules); with
``--remediate`` a breaching miner is quarantined (``--quarantine-rules``,
``--probation-beats``, ``--probation-rounds``, ``--score-decay``).
``--metrics-path`` writes each round's record, the breaches and the
ledger as JSONL. On a world the coordinator alone beats and monitors.
"""

from __future__ import annotations

import logging

from ..config import RunConfig
from ..engine.validate import Validator
from ..parallel import multihost
from ..utils import devprof, flight, obs
from .common import build, build_base_fetcher, build_health_plane


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("validator", argv)
    c = build(cfg)
    flight.install_crash_hooks()   # see neurons/miner.py
    base_fetcher = build_base_fetcher(cfg, c)
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
                          metrics=c.metrics, lora_cfg=c.lora_cfg,
                          base_fetcher=base_fetcher)
    # the reference gates weight-setting to staked validators
    # (btt_connector.py:358-385): refuse up front rather than spend eval
    # compute on scores no one will see. On a pod the coordinator's
    # verdict counts on every rank: one rank exiting alone would leave
    # the others waiting at their first collective.
    if multihost.process_count() > 1:
        from ..engine.train import broadcast_flag
        permitted = broadcast_flag(validator.has_vpermit()
                                   if multihost.is_coordinator() else False)
    else:
        permitted = validator.has_vpermit()
    if not permitted:
        if not cfg.allow_no_vpermit:
            flight.reset()
            if c.owns_world:
                multihost.shutdown()
            raise SystemExit(
                f"hotkey {c.chain.my_hotkey} holds no validator permit "
                f"(stake < {cfg.vpermit_stake_limit}); pass "
                f"--allow-no-vpermit to run anyway without emitting weights")
        logging.warning("running WITHOUT a validator permit: weights will "
                        "not be emitted")
    # the health plane after the permit gate (a refused boot leaves no
    # heartbeat timer behind): the validator beats and monitors; a
    # breach arms the anomaly monitor (detection and counters)
    from ..engine.health import Vitals
    from ..utils.obs import AnomalyMonitor
    plane = build_health_plane(cfg, c, monitor=True,
                               anomaly=AnomalyMonitor(),
                               start_heartbeat=False,
                               collect=(base_fetcher.heartbeat_fields
                                        if base_fetcher is not None
                                        else None))
    validator.fleet = plane.fleet   # before the first round's lazy ingest
    validator.remediation = plane.remediation   # and lazy evaluator
    if plane.heartbeat is not None:
        plane.heartbeat.vitals = Vitals(
            steps=lambda: validator._round,
            loss=lambda: validator.base_loss,
            counters=lambda: {"rounds": validator._round},
            base_revision=lambda: validator._base_revision)
        plane.heartbeat.start()
    try:
        validator.bootstrap(params=c.initial_params)
        ok = validator.run_periodic(interval=cfg.validation_interval,
                                    rounds=cfg.rounds)
    except KeyboardInterrupt:
        logging.info("validator interrupted; exiting")
        return 0
    finally:
        plane.close()       # the heartbeat timer, the fleet's pool
        validator.close()   # drain the ingest pool's worker threads
        flight.shutdown()   # see neurons/miner.py
        obs.reset()
        devprof.reset()
        if c.metrics is not None:
            c.metrics.close()
        if c.owns_world:   # last: the gates above still ask for the rank
            multihost.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
