"""Miner entry point of the port: train on the current base, publish
weight deltas — the port of the JAX package's ``neurons/miner.py``.

Run offline end to end on the card with::

    python -m distributedtraining_tpu_torch.neurons.miner \
        --backend local --work-dir /tmp/run --model gpt2-124m \
        --dataset synthetic --tokenizer word --fused-loss --max-steps 50

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead.) On N cards of
one host it runs one process a card::

    torchrun --nproc-per-node N -m distributedtraining_tpu_torch.neurons.miner \
        ... --fsdp N          # or --tp, --dp, --mesh-auto

(``--dp 0``, the default, takes every rank the other axes leave;
``--multihost-coordinator host:port --multihost-processes N
--multihost-id I`` start the ranks by hand). NCCL carries the
collectives, gloo on the CPU; ``DT_DIST_BACKEND=gloo`` lets several
ranks share one card. ``--batch-size`` is the global batch, and the
coordinator (rank 0) alone publishes and checkpoints. The JAX defaults
apply: base pulls go through the published manifest (``--base-wire-v2``),
a checkpoint lands in ``<work-dir>/checkpoints/<hotkey>`` every
``--checkpoint-interval`` seconds and at exit (a restart resumes from
it), an anomaly arms one profiler window into
``<work-dir>/anomaly_traces/<hotkey>`` (``--anomaly-trace``), and the
flight recorder keeps ``--flight-events`` events. ``--wire-v2``
publishes the packed top-k form as per-layer shards and a manifest
(``--wire-density``, ``--wire-quant`` tune it); ``--delta-dtype
int8|sparse8`` the v1 compressed forms (``--delta-density``).
``--lora-rank R`` (``--lora-alpha``) trains rank-R adapters on the
frozen base and publishes the adapter tree
(``engine/lora_train.LoRAMinerLoop``; on a mesh too).
``--sign-artifacts`` signs every artifact with the hotkey's wallet
(``--wallet-path``) and verifies the base (``--base-signer``);
``--my-repo-id`` registers a repo id in the address store.
``--heartbeat-interval S`` publishes a heartbeat every S seconds (the
coordinator's; the report's counters, the loss at the log cadence, the
base fetcher's bytes) and ``--metrics-path`` writes the loss records,
spans and registry flushes as JSONL. A JAX validator or averager, or the
port's, pointed at the same ``--work-dir`` reads its deltas and beats.
"""

from __future__ import annotations

import logging
import os
import time

from ..config import RunConfig
from ..engine.lora_train import LoRAEngine, LoRAMinerLoop
from ..engine.train import MinerLoop
from ..parallel import multihost
from ..utils import devprof, flight, obs
from .common import build, build_base_fetcher, build_health_plane


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
    # an unhandled exception (main or worker thread) or the interpreter's
    # exit freezes the flight ring into a published postmortem bundle
    flight.install_crash_hooks()
    from ..utils.metrics import TraceCapture
    trace = (TraceCapture(cfg.profile_dir, steps=cfg.profile_steps)
             if cfg.profile_dir else None)
    anomaly = None
    if cfg.anomaly_trace:
        # a disarmed capture: a loss spike, a push-failure streak or a
        # step-time p99 blowout arms one bounded profiler window
        from ..utils.obs import AnomalyMonitor
        anomaly = AnomalyMonitor(TraceCapture(
            cfg.anomaly_dir or os.path.join(cfg.work_dir, "anomaly_traces",
                                            cfg.hotkey),
            steps=cfg.profile_steps, arm=False))
    store = None
    if cfg.checkpoint_interval > 0:
        from ..checkpoint import CheckpointStore
        store = CheckpointStore(cfg.checkpoint_dir or os.path.join(
            cfg.work_dir, "checkpoints", cfg.hotkey))
    base_fetcher = build_base_fetcher(cfg, c)
    common = dict(send_interval=cfg.send_interval,
                  check_update_interval=cfg.check_update_interval,
                  metrics=c.metrics, log_every=cfg.log_every,
                  push_async=cfg.push_async,
                  push_queue_depth=cfg.push_queue_depth,
                  checkpoint_store=store,
                  checkpoint_interval=cfg.checkpoint_interval,
                  trace=trace, anomaly=anomaly,
                  base_fetcher=base_fetcher,
                  **_guard_kwargs(cfg, c))
    if c.lora_cfg is not None:
        # adapter-only training, adapter-tree artifacts, with the
        # composed engine's optimizer (--learning-rate, --grad-clip); on
        # a mesh the frozen base is sharded and the adapters replicated
        if cfg.keep_optimizer_on_pull:
            # adapters are defined relative to the base and reset with it
            logging.warning(
                "--keep-optimizer-on-pull has no effect for LoRA miners "
                "(adapters and their optimizer reset with the base); "
                "ignoring")
        engine = LoRAEngine(c.model, c.lora_cfg, optimizer=c.engine.tx,
                            mesh=c.engine.mesh, fused_loss=cfg.fused_loss,
                            accum_steps=cfg.accum_steps,
                            device=c.engine.device)
        loop = LoRAMinerLoop(engine, c.transport, cfg.hotkey, **common)
    else:
        loop = MinerLoop(c.engine, c.transport, cfg.hotkey,
                         delta_dtype=cfg.delta_dtype,
                         delta_density=cfg.delta_density,
                         wire_v2=cfg.wire_v2,
                         wire_density=cfg.wire_density,
                         wire_quant=cfg.wire_quant,
                         keep_optimizer_on_pull=cfg.keep_optimizer_on_pull,
                         **common)
    # the heartbeat starts with the loop and sends its last beat at
    # flush; its vitals read the loop's live report (host values)
    from ..engine.health import report_vitals
    plane = build_health_plane(
        cfg, c, start_heartbeat=False,
        vitals=report_vitals(loop.report,
                             base_revision=lambda: loop._base_revision),
        collect=(base_fetcher.heartbeat_fields
                 if base_fetcher is not None else None))
    loop.heartbeat = plane.heartbeat

    def _bootstrap():
        # bounded retry on TRANSPORT errors only (a restart is exactly
        # when the backend may still be partitioned); programming errors
        # re-raise at once, and bootstrap is idempotent
        for attempt in range(3):
            try:
                return loop.bootstrap(params=c.initial_params)
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
        loop.flush()  # the final delta and checkpoint
    except KeyboardInterrupt:
        report = loop.report
        loop.flush()
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()   # the look-ahead thread
        loop.close()
        if store is not None:
            store.close()
        plane.close()   # the heartbeat timer (idempotent)
        # a crash bundle first (while the transport is still wired), then
        # the process-wide state goes
        flight.shutdown()
        obs.reset()
        devprof.reset()
        if c.metrics is not None:
            c.metrics.close()
        if c.owns_world:   # last: the gates above still ask for the rank
            multihost.shutdown()
    logging.info("miner done: steps=%d pushes=%d (failed=%d superseded=%d) "
                 "base_pulls=%d loss=%.4f",
                 report.steps, report.pushes, report.pushes_failed,
                 report.pushes_superseded, report.base_pulls,
                 report.last_loss)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
