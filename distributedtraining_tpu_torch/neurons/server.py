"""Server entry point of the port: serve generation over the live base
model — the port of the JAX package's ``neurons/server.py``.

A continuous-batching engine (engine/serve.py) boots from the averager's
published base, watches the transport for new revisions and hot-swaps
them between decode steps. The JAX defaults are on: the prefix cache,
request traces feeding the SLO burn monitor, content-addressed base
pulls. Run it on the card with::

    python -m distributedtraining_tpu_torch.neurons.server \\
        --backend local --work-dir /tmp/run --dataset synthetic \\
        --tokenizer word --serve-port 8900

(``DT_FORCE_PLATFORM=cpu`` runs it on the CPU instead) and POST token
ids at it::

    curl -d '{"tokens": [1, 2, 3], "max_new_tokens": 16}' \\
        http://127.0.0.1:8900/generate

``--speculative`` adds a drafter (``--draft-repo preset@work_dir``; empty
drafts with the served model itself), ``--max-steps N`` bounds a run: it
ends after N engine steps, or once traffic has drained and the engine
idled for two swap polls.

``--serve-phase prefill`` runs a prefill worker (it answers ``POST
/prefill`` and exports each request's KV pages over the serving
transport); ``--serve-phase decode`` a decode worker that adopts them.
Put ``neurons/router.py`` in front of both (and of unified workers): it
routes each request prefill -> decode, and falls back to a unified
worker.

``--heartbeat-interval S`` beats every S seconds: the served revision
(as ``base_revision``), engine steps, and ``engine/serve.
heartbeat_counters`` (tokens a second, queue depth, the prefix-cache and
speculative rates, ttft / tpot p95, ``phase``, ``kv_exported``,
``kv_adopted``). ``--metrics-path`` flushes the registry (``serve.*``)
to JSONL every 15 s.
"""

from __future__ import annotations

import logging
import os
import time

from ..config import RunConfig
from ..engine import health, kv_transfer
from ..engine.serve import (BaseRevisionWatcher, GenerationEngine,
                            ServeHTTPFrontend, ServeLoop,
                            heartbeat_counters, host_param_template)
from ..utils import devprof, flight, obs
from .common import (build, build_base_fetcher, build_health_plane,
                     resolve_role_device)

logger = logging.getLogger(__name__)


def _await_base(cfg: RunConfig, c, watcher: BaseRevisionWatcher,
                device: str):
    """Boot weights ``(state, revision)``: the published base when one
    exists, else the ``--init-from`` weights (serving can come up before
    the averager's first publish; the converted tree in the unrolled
    layout the engine serves), else a published base polled for (at
    most ``--rounds`` x ``--swap-poll`` when ``--rounds`` is given)."""
    deadline = (time.monotonic() + cfg.rounds * cfg.swap_poll
                if cfg.rounds else None)
    while True:
        if watcher.poll_once():
            staged = watcher.take_pending()
            if staged is not None:
                return staged[1], staged[0]
        params = c.initial_params()
        if params is not None:
            from .. import models
            logger.info("no published base yet; serving --init-from "
                        "weights until one lands")
            if c.model_cfg.scan_blocks:
                params = models.unstack_blocks(c.model_cfg, params)
            return models.params_from_numpy(params, device=device), None
        if deadline is not None and time.monotonic() > deadline:
            raise SystemExit(
                "no base model appeared within the bounded wait "
                "(--rounds x --swap-poll); is the averager running?")
        logger.info("waiting for a published base model "
                    "(poll every %.1fs)...", cfg.swap_poll)
        time.sleep(cfg.swap_poll)


def _build_drafter(cfg: RunConfig, c, device: str):
    """The speculative drafter (``--speculative``): a DraftEngine around
    the base named by ``--draft-repo`` ("preset@work_dir": a second
    transport watches that deployment's revisions and feeds the
    drafter's hot-swap lane); empty, a self-draft from the serving
    transport (a draft the target's own size saves nothing: smoke
    only). Every failure degrades to plain decode."""
    if not cfg.serve_speculative:
        return None
    from .. import models
    from ..engine import speculative as spec
    try:
        if cfg.serve_draft_repo:
            preset, _, work_dir = cfg.serve_draft_repo.partition("@")
            dmodel, _ = models.make_model(preset)   # either family
            from ..transport import LocalFSTransport
            tr = LocalFSTransport(os.path.join(work_dir, "artifacts"))
        else:
            dmodel, tr = c.model, c.transport
        reason = spec.compat_reason(dmodel, c.model_cfg)
        if reason:
            logger.warning("drafter incompatible (%s); serving plain",
                           reason)
            return None
        dwatcher = BaseRevisionWatcher(
            tr, lambda: host_param_template(dmodel),
            poll_s=max(cfg.swap_poll, 0.1), device=device)
        draft = spec.DraftEngine(
            dmodel, device=device, max_slots=cfg.serve_slots,
            page_size=cfg.serve_page_size, watcher=dwatcher)
        # a draft base already published speculates from the first step;
        # otherwise the watcher installs it when it lands (plain decode
        # until then)
        if dwatcher.poll_once():
            staged = dwatcher.take_pending()
            if staged is not None:
                draft.install_params(staged[1], revision=staged[0])
        dwatcher.start()
        logger.info("speculative decoding on: draft=%s k=%d ready=%s",
                    cfg.serve_draft_repo or "<self>", cfg.serve_draft_k,
                    draft.ready)
        return draft
    except Exception:
        logger.exception("drafter construction failed; serving plain")
        return None


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = RunConfig.from_args("server", argv)
    c = build(cfg)
    flight.install_crash_hooks()   # see neurons/miner.py
    device = resolve_role_device()
    base_fetcher = build_base_fetcher(cfg, c)
    watcher = BaseRevisionWatcher(
        c.transport, lambda: host_param_template(c.model),
        poll_s=max(cfg.swap_poll, 0.1), fetcher=base_fetcher,
        device=device)
    engine = loop = frontend = plane = None
    try:
        params, revision = _await_base(cfg, c, watcher, device)
        # SLO burn-rate alerting over the request-trace stream: every
        # finished or refused request feeds the monitor, evaluated on the
        # registry's flush cadence below
        burn = health.BurnRateMonitor() if cfg.serve_trace else None
        health.attach_burn(burn)
        # disaggregated workers move KV pages over the serving transport
        # (the store base revisions ride); a unified worker touches none
        phase = cfg.serve_phase
        engine = GenerationEngine(
            c.model, params, device=device, revision=revision,
            max_slots=cfg.serve_slots, page_size=cfg.serve_page_size,
            pool_pages=cfg.serve_kv_pages, max_seq_len=cfg.serve_max_seq,
            max_new_tokens=cfg.serve_max_new,
            eos_id=getattr(c.tokenizer, "eos_id", None),
            swap_policy=cfg.swap_policy, watcher=watcher,
            max_queue=cfg.serve_max_queue,
            prefix_cache=cfg.serve_prefix_cache,
            # a prefill worker never decodes, so it gets no drafter
            draft=(None if phase == "prefill"
                   else _build_drafter(cfg, c, device)),
            draft_k=cfg.serve_draft_k,
            trace=cfg.serve_trace,
            trace_exemplars=cfg.serve_trace_exemplars,
            trace_window_s=cfg.serve_trace_window or 30.0, burn=burn,
            phase=phase,
            kv_exporter=(kv_transfer.KVExporter(c.transport)
                         if phase == "prefill" else None),
            kv_adopter=(kv_transfer.KVAdopter(c.transport)
                        if phase == "decode" else None))
        watcher.start()
        # the heartbeat: the served revision, steps and the serving
        # counters (host values)
        vitals = health.Vitals(
            steps=lambda: engine.steps,
            counters=lambda: heartbeat_counters(engine, burn),
            base_revision=lambda: engine.revision)
        plane = build_health_plane(
            cfg, c, vitals=vitals,
            collect=(base_fetcher.heartbeat_fields
                     if base_fetcher is not None else None))
        if cfg.serve_port:
            frontend = ServeHTTPFrontend(engine, cfg.serve_port,
                                         tokenizer=c.tokenizer)
            frontend.start()
        loop = ServeLoop(engine).start()
        idle_since = None
        last_eval = time.monotonic()
        while True:
            time.sleep(0.25)
            if time.monotonic() - last_eval >= 15.0:
                # the registry (serve.* timings) and the burn rules on
                # one steady cadence
                if c.metrics is not None:
                    obs.flush(step=engine.steps)
                if burn is not None:
                    burn.evaluate()
                last_eval = time.monotonic()
            if cfg.max_steps is None:
                continue   # unbounded: serve until interrupted
            if engine.steps >= cfg.max_steps:
                logger.info("reached --max-steps %d steps", cfg.max_steps)
                break
            # a bounded run ends without traffic too: a drained queue
            # that stays idle ends it
            if engine.idle:
                idle_since = idle_since or time.monotonic()
                if time.monotonic() - idle_since > 2 * max(cfg.swap_poll,
                                                           1.0):
                    logger.info("bounded run idle; exiting at %d steps",
                                engine.steps)
                    break
            else:
                idle_since = None
    except KeyboardInterrupt:
        pass
    finally:
        if frontend is not None:
            frontend.close()
        if loop is not None:
            loop.close()
        if plane is not None:
            plane.close()
        if engine is not None:
            engine.close()
        else:
            watcher.close()
        health.attach_burn(None)
        if c.metrics is not None and engine is not None:
            obs.flush(step=engine.steps)
        flight.shutdown()   # see neurons/miner.py
        obs.reset()
        devprof.reset()
        if c.metrics is not None:
            c.metrics.close()
    if engine is not None:
        logger.info("server done: steps=%d tokens=%d revision=%s",
                    engine.steps, engine.tokens_emitted, engine.revision)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
