"""Validator engine — the port of the JAX package's ``engine/validate.py``
on one host: score every miner's delta by the held-out loss (or
perplexity) it removes from the current base, and emit the scores to the
chain.

Scoring is ``evaluate(base + d)``; the base is never mutated, so a crash
mid-round cannot corrupt it. The rule (the reference's
``validation_logic.py:136-166``):

  score = max(0, base_loss - new_loss)   [loss mode]
  score = max(0, base_ppl - new_ppl)     [perplexity mode]
  missing, stale (under "skip") or screened-out delta -> 0

Submissions stage through the port's ``engine/ingest.py`` (concurrent
fetch, revision cache, wire-v2 manifests densified after the screen).
With ``cohort_size > 1`` they are scored a cohort at a time through
``engine/batched_eval.py`` (the base rides in slot 0 of its own cohort
when it is evaluated), staged one cohort ahead on a background thread
when ``pipeline_depth > 0``; ``cohort_size <= 1`` is the sequential
``score_miner`` path through ``engine.evaluate`` (the fused CE on a
``--fused-loss`` engine). Weights reach the chain only when this hotkey
holds a validator permit.

With ``base_fetcher`` (``engine/basedist.BaseFetcher``) base pulls fetch
only the layers the published manifest changed, falling back to the
monolithic pull.

On a mesh of several processes (the engine's ``mesh``; ``torchrun`` or
the ``--multihost-*`` flags) every rank runs the round in lockstep, as
the JAX pod validator does: the coordinator pulls the base (through the
fetcher, when one is wired) and broadcasts it, syncs the metagraph and
broadcasts it, and stages every submission for every rank
(``stage(multi=True)``: no staging pipeline, whose thread would issue
the broadcasts); each rank evaluates its block of the cohort
(``engine/batched_eval.py``), and the gated chain lets the coordinator
alone set weights. The sequential path evaluates through the mesh
engine. With ``lora_cfg``, LoRA adapter submissions are densified at
staging and scored as any other.

The fleet health plane hooks in as the JAX package's does: ``fleet``
(``engine/health.FleetMonitor``) polls the fleet's heartbeats before
staging and sees every staging outcome (the ingest observer);
``remediation`` (``engine/remediate.RemediationEngine``) excludes its
quarantined miners from staging, shrinks the cohort (``elastic_cohort``,
gauge ``val.effective_cohort``) and decays their scores; at the round's
end the scores and credit reach the ledger, the SLOs are evaluated,
remediation observes the breaches and the ledger is flushed through
``metrics``, which also gets the round's record (``scored``,
``round_scores``, ...). On a world only the coordinator holds the fleet
and the remediation engine; the cohort size is its, broadcast, and its
quarantine verdicts reach every rank with the staged submissions.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable

import torch

from ..utils import obs
from .basedist import fetch_base
from .scheduler import Clock, RealClock

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

@dataclasses.dataclass
class MinerScore:
    hotkey: str
    score: float
    loss: float | None = None
    perplexity: float | None = None
    reason: str = "ok"


class Validator:
    """One host's validator (validate_and_score, validation_logic.py:
    99-189). ``eval_batches`` is a zero-argument factory of the held-out
    batch stream."""

    def __init__(self, engine, transport, chain, *,
                 eval_batches: Callable[[], Iterable[dict]],
                 metric: str = "loss",
                 max_delta_abs: float | None = 1e3,
                 clock: Clock | None = None,
                 accept_quant: bool = True,
                 accept_wire_v2: bool = True,
                 stale_deltas: str = "accept",
                 cohort_size: int = 8,
                 pipeline_depth: int = 1,
                 ingest_workers: int = 4,
                 ingest_cache_mb: int = 2048,
                 metrics=None, lora_cfg=None, fleet=None, remediation=None,
                 base_fetcher=None):
        if metric not in ("loss", "perplexity"):
            raise ValueError(f"metric must be 'loss' or 'perplexity', "
                             f"got {metric!r}")
        # "accept" (the reference's behavior) scores a delta made against
        # a superseded base against the current one: noisy but
        # informative, and the chain's EMA smooths it. "skip" scores it 0
        # with reason stale_base (the averager's default: merging one
        # would re-add the last merge's update).
        if stale_deltas not in ("skip", "accept"):
            raise ValueError(f"stale_deltas must be 'skip' or 'accept', "
                             f"got {stale_deltas!r}")
        if cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {cohort_size}")
        self.engine = engine
        self.transport = transport
        self.base_fetcher = base_fetcher
        self.metrics = metrics
        # the fleet health plane (engine/health.FleetMonitor) and the
        # remediation engine acting on its breaches; on a world, the
        # coordinator's alone
        self.fleet = fleet
        self.remediation = remediation
        self.chain = chain
        self.eval_batches = eval_batches
        self.metric = metric
        self.max_delta_abs = max_delta_abs
        self.clock = clock or RealClock()
        self.accept_quant = accept_quant
        self.accept_wire_v2 = accept_wire_v2
        self.stale_deltas = stale_deltas
        # cohort_size <= 1 is the sequential score_miner path;
        # pipeline_depth > 0 stages cohort n+1 while cohort n evaluates
        self.cohort_size = cohort_size
        self.pipeline_depth = pipeline_depth
        self.ingest_workers = ingest_workers
        self.ingest_cache_mb = ingest_cache_mb
        self._cohort_eval = None
        self._ingestor = None
        self._host_template_cache = None
        self._quant_template_cache = None
        # LoRA submissions (models.lora.LoRAConfig): the adapter template
        # is built from the host template once, when first asked for
        self.lora_cfg = lora_cfg
        self._lora_template = None
        self.base_params: Params | None = None
        self._base_revision = None
        self.base_loss: float | None = None
        self.base_ppl: float | None = None
        # per-miner leave-one-out credit, one estimate per (base
        # revision, hotkey): re-validating an unchanged base replaces it
        from .lineage import CreditLedger
        self.credit = CreditLedger()
        self._warned_no_permit = False
        # hotkey -> correlation id of the artifact staged this round
        self._round_cids: dict[str, str] = {}
        self._round = 0

    # -- validator permit ---------------------------------------------------
    def has_vpermit(self, meta=None) -> bool:
        """True when this hotkey's uid holds validator stake: the
        reference gates weight-setting to permitted validators
        (btt_connector.py:358-385)."""
        get_vuids = getattr(self.chain, "get_validator_uids", None)
        if get_vuids is None:
            return True   # a chain with no permit concept
        meta = meta if meta is not None else self.chain.sync()
        try:
            uid = meta.uids[list(meta.hotkeys).index(self.chain.my_hotkey)]
        except ValueError:
            return False  # not registered on the subnet
        return uid in get_vuids()

    # -- templates ----------------------------------------------------------
    def _host_template(self):
        """The wire-layout template of every transport read (shapes are
        fixed by the model config)."""
        if self._host_template_cache is None:
            from .train import _wire_template
            self._host_template_cache = _wire_template(self.engine.model)
        return self._host_template_cache

    def _quant_template(self):
        """The int8 wire template, handed over uncalled: an all-float
        fleet never builds it."""
        if self._quant_template_cache is None:
            from .. import delta as delta_lib
            self._quant_template_cache = delta_lib.quantized_template(
                self._host_template())
        return self._quant_template_cache

    def _adapter_template(self):
        """The wire template of adapter payloads (None without
        ``lora_cfg``), handed to the ingestor uncalled."""
        if self.lora_cfg is None:
            return None
        if self._lora_template is None:
            from .lora_train import adapter_template
            self._lora_template = adapter_template(self._host_template(),
                                                   self.lora_cfg)
        return self._lora_template

    def _place(self, tree) -> Params:
        """A nested tree or a state dict in the engine's layout as the
        base on the engine's device (no gradients)."""
        from ..models.gpt2 import params_from_numpy
        if any(isinstance(v, dict) for v in tree.values()):
            return params_from_numpy(tree, device=self.engine.device)
        return {k: v.detach().to(self.engine.device, copy=True)
                for k, v in tree.items()}

    # -- base model ---------------------------------------------------------
    # -- a world of several processes ----------------------------------------
    def _multi(self) -> bool:
        from .train import mesh_spans
        return mesh_spans(self.engine)

    def _broadcast_base(self, current_revision):
        """The coordinator's base pull, the same ``(tree, revision)`` or
        None on every rank."""
        from .train import broadcast_base_fetch
        return broadcast_base_fetch(self.transport, self._host_template(),
                                    current_revision,
                                    fetch=self._fetch_base_single)

    def _synced_metagraph(self):
        """The round-start metagraph: the coordinator's, broadcast, on a
        pod."""
        if not self._multi():
            return self.chain.sync()
        from .train import broadcast_metagraph
        return broadcast_metagraph(self.chain)

    def bootstrap(self, seed: int = 0, params=None) -> None:
        """Pull the published base; when none is published yet, start
        from ``params`` (a tree, or a zero-argument callable returning
        one) or a random init drawn with numpy from ``seed`` (the same
        on every rank). Then evaluate it."""
        from ..models import init_params_numpy
        if self._multi():
            fetched = self._broadcast_base(None)
        else:
            fetched = (self._fetch_base_single()
                       if self.transport.base_revision() is not None
                       else None)
        from .train import wire_in
        if fetched is not None:
            base, self._base_revision = fetched
            base = wire_in(self.engine, base)
        else:
            base = params() if callable(params) else params
            if base is None:
                base = init_params_numpy(self.engine.model.cfg, seed)
        self.base_params = self._place(base)
        self._eval_base()

    def _fetch_base_single(self, revision=None):
        return fetch_base(self.transport, self.base_fetcher,
                          self._host_template(), revision)

    def _evaluator(self):
        if self._cohort_eval is None:
            from .batched_eval import BatchedCohortEvaluator
            self._cohort_eval = BatchedCohortEvaluator(self.engine)
        return self._cohort_eval

    def _eval_base(self) -> None:
        # with cohort scoring on, the base is slot 0 of a cohort of its
        # own: the same eval path as the miners' candidates
        if self.cohort_size > 1:
            (self.base_loss, self.base_ppl), = self._evaluator(
                ).evaluate_cohort(self.base_params, [], self.eval_batches(),
                                  include_base=True)
        else:
            self.base_loss, self.base_ppl = self.engine.evaluate(
                self.engine.local(self.base_params), self.eval_batches())
        logger.info("validator: base loss=%.4f ppl=%.2f",
                    self.base_loss, self.base_ppl)

    def _maybe_refresh_base(self) -> None:
        if self._multi():
            # per-rank reads could hand the ranks different bases
            fetched = self._broadcast_base(self._base_revision)
        else:
            rev = self.transport.base_revision()
            if rev is None or rev == self._base_revision:
                return
            fetched = self._fetch_base_single(rev)
        if fetched is None:   # a torn or hostile read: keep the base
            return
        from .train import wire_in
        self.base_params = self._place(wire_in(self.engine, fetched[0]))
        self._base_revision = fetched[1]
        self._eval_base()

    # -- staging ------------------------------------------------------------
    def _ingest(self):
        """The shared ingest front-end (``engine/ingest.py``); wire-v2
        submissions are densified after their screen."""
        if self._ingestor is None:
            from .ingest import DeltaIngestor
            self._ingestor = DeltaIngestor(
                self.transport, self._host_template,
                lora_cfg=self.lora_cfg,
                lora_template=self._adapter_template,
                quant_template=self._quant_template,
                accept_quant=self.accept_quant,
                accept_wire_v2=self.accept_wire_v2,
                max_delta_abs=self.max_delta_abs,
                stale_deltas=self.stale_deltas,
                workers=self.ingest_workers,
                cache_bytes=self.ingest_cache_mb * (1 << 20),
                span_prefix="val",
                observer=(self.fleet.record_staging
                          if self.fleet is not None else None))
        return self._ingestor

    def close(self) -> None:
        """Drop the ingest pool's and the fleet's worker threads
        (idempotent)."""
        if self._ingestor is not None:
            self._ingestor.close()
        if self.fleet is not None:
            self.fleet.close()

    def _stage_many(self, hotkeys):
        """Fetch and screen a cohort of submissions through the ingest
        pool: ``[(hotkey, delta | None, reason), ...]`` in input order.
        The artifact's ``delta_id`` (from its rider) tags the eval span."""
        from .train import wire_in
        staged = self._ingest().stage(
            list(hotkeys), base_revision=self._base_revision,
            multi=self._multi(),
            exclude=(self.remediation.is_excluded
                     if self.remediation is not None else None))
        out = []
        for s in staged:
            if s.cid is not None:
                self._round_cids[s.hotkey] = s.cid
            # screened in the wire layout; scored in the engine's
            out.append((s.hotkey, wire_in(self.engine, s.delta), s.reason))
        return out

    def _stage_miner(self, hotkey: str):
        (res,) = self._stage_many([hotkey])
        return res

    # -- scoring ------------------------------------------------------------
    def _score_from(self, hotkey: str, loss: float, ppl: float) -> MinerScore:
        if self.metric == "perplexity":
            score = max(0.0, (self.base_ppl or 0.0) - ppl)
        else:
            score = max(0.0, (self.base_loss or 0.0) - loss)
        return MinerScore(hotkey, score, loss=loss, perplexity=ppl)

    def score_miner(self, hotkey: str) -> MinerScore:
        from .batched_eval import candidate_params
        hotkey, d, reason = self._stage_miner(hotkey)
        if d is None:
            return MinerScore(hotkey, 0.0, reason=reason)
        candidate = candidate_params(self.base_params, d)
        with obs.span("val.eval", cid=self._round_cids.get(hotkey),
                      miner=hotkey):
            loss, ppl = self.engine.evaluate(self.engine.local(candidate),
                                             self.eval_batches())
        return self._score_from(hotkey, loss, ppl)

    def _score_cohorts(self, hotkeys: list[str]) -> list[MinerScore]:
        """Stage cohorts of ``cohort_size`` submissions (one cohort ahead
        when pipelined) and score each cohort's valid deltas together."""
        from .batched_eval import stage_cohorts
        evaluator = self._evaluator()
        results: list[MinerScore] = []
        cohort = self._effective_cohort(hotkeys, evaluator)
        # a pod stages inline: its broadcasts must not run on a thread
        staged = stage_cohorts(hotkeys, cohort, self._stage_miner,
                               pipeline=(self.pipeline_depth > 0
                                         and not self._multi()),
                               depth=max(self.pipeline_depth, 1),
                               stage_many=self._stage_many)
        try:
            it = iter(staged)
            while True:
                t0 = time.perf_counter()
                try:
                    cohort = next(it)
                except StopIteration:
                    break
                # time blocked on the stager (near 0: staging overlaps)
                obs.observe("val.stage_wait_ms",
                            (time.perf_counter() - t0) * 1e3)
                valid = [(h, d) for h, d, _ in cohort if d is not None]
                results.extend(MinerScore(h, 0.0, reason=r)
                               for h, d, r in cohort if d is None)
                if not valid:
                    continue
                cids = [c for c in (self._round_cids.get(h)
                                    for h, _ in valid) if c]
                with obs.span("val.cohort_eval", k=len(valid), cids=cids):
                    scored = evaluator.evaluate_cohort(
                        self.base_params, [d for _, d in valid],
                        self.eval_batches())
                results.extend(self._score_from(h, loss, ppl)
                               for (h, _), (loss, ppl) in zip(valid, scored))
        finally:
            close = getattr(staged, "close", None)
            if close is not None:   # stop the stager on a failed round
                close()
        return results

    def _effective_cohort(self, hotkeys: list[str], evaluator) -> int:
        """The round's cohort size: the configured one, or with
        remediation attached the elastic cohort over the miners it has
        not quarantined (``val.effective_cohort``). On a world the
        coordinator's size reaches every rank, so the ranks' cohorts and
        their collectives pair up."""
        cohort = self.cohort_size
        if self.remediation is not None:
            healthy = len(self.remediation.filter_hotkeys(hotkeys))
            cohort = self.remediation.cohort_size(
                self.cohort_size, healthy,
                compiled=evaluator.compiled_buckets())
        if self._multi():
            from .train import broadcast_json
            cohort = int(broadcast_json({"cohort": cohort})["cohort"])
        if self.remediation is not None:
            obs.gauge("val.effective_cohort", float(cohort))
        return cohort

    def _fleet_round_end(self, scored: dict[str, float]
                         ) -> dict[str, float]:
        """Remediation's score decay, then the ledger's scores and credit,
        the SLOs, remediation's observation of the breaches and the
        ledger's flush. Health-plane failures never fail a round."""
        if self.remediation is not None:
            # quarantined miners' scores decay instead of the chain EMA
            # holding their pre-breach weight
            scored = self.remediation.decay_scores(scored)
        if self.fleet is not None:
            try:
                self.fleet.record_scores(scored)
                self.fleet.record_credit(self.credit.totals())
                breaches = self.fleet.evaluate_slos()
                if self.remediation is not None:
                    self.remediation.observe_round(breaches)
                self.fleet.flush(self.metrics, step=self._round)
            except Exception:
                logger.exception("validator: fleet round-end failed")
        return scored

    def _log_round(self, results: list[MinerScore],
                   round_credits: dict) -> None:
        """The round's record through the sink (a fixed key set, the
        per-miner detail in one ``round_scores`` record) and a registry
        flush."""
        if not self.metrics:
            return
        from ..utils.metrics import device_memory_watermarks, device_metrics
        for k, v in device_memory_watermarks().items():
            obs.gauge(f"device.{k}", v)
        with_loss = [s for s in results if s.loss is not None]
        positive = [s for s in results if s.score > 0]
        self.metrics.log({
            **device_metrics(),
            "scored": len(results),
            "rejected": len(results) - len(with_loss),
            "score_positive": len(positive),
            "score_mean": (sum(s.score for s in results)
                           / max(len(results), 1)),
            "score_max": max((s.score for s in results), default=0.0),
            "loss_best": min((s.loss for s in with_loss),
                             default=float("nan")),
            "base_loss": self.base_loss,
            "round_scores": {
                s.hotkey: {"score": s.score, "loss": s.loss,
                           "reason": s.reason,
                           "cid": self._round_cids.get(s.hotkey),
                           "credit": round_credits.get(s.hotkey)}
                for s in results},
        }, step=self._round)
        obs.flush(self.metrics, step=self._round)

    def validate_and_score(self) -> list[MinerScore]:
        """One validation round (validate_and_score,
        validation_logic.py:99-189)."""
        self._round_cids.clear()
        meta = self._synced_metagraph()
        self._maybe_refresh_base()
        others = [h for h in meta.hotkeys if h != self.chain.my_hotkey]
        if self.fleet is not None:
            # the heartbeat observation round before staging, so that
            # the staging observer folds this round's outcomes into the
            # advanced round (transport reads only: the coordinator's)
            try:
                self.fleet.poll(others)
            except Exception:
                logger.exception("validator: fleet heartbeat poll failed")
        if self.cohort_size > 1:
            results = self._score_cohorts(others)
        else:
            results = [self.score_miner(h) for h in others]
        scored = {s.hotkey: s.score for s in results}
        # leave-one-out credit for this base revision; attribution must
        # never fail a scoring round
        round_credits: dict[str, float] = {}
        try:
            round_credits = self.credit.update(
                self._base_revision, self.base_loss, results) or {}
        except Exception:
            logger.exception("validator: credit attribution failed")
        scored = self._fleet_round_end(scored)
        self._log_round(results, round_credits)
        self._round += 1
        if self.chain.should_set_weights():
            if self.has_vpermit(meta):
                self.chain.set_weights(scored)   # EMA + normalize inside
            elif not self._warned_no_permit:
                self._warned_no_permit = True
                logger.warning(
                    "validator %s holds no validator permit (stake below "
                    "the vpermit limit) — scoring continues but weights "
                    "are NOT emitted", self.chain.my_hotkey)
        return results

    def run_periodic(self, *, interval: float = 1800.0,
                     rounds: int | None = None) -> int:
        """Run rounds forever (or ``rounds`` times); returns how many
        completed without an exception, so that a caller can exit
        non-zero when every round failed."""
        done = succeeded = 0
        while rounds is None or done < rounds:
            try:
                self.validate_and_score()
                succeeded += 1
            except Exception:
                logger.exception("validation round failed; continuing")
            done += 1
            if rounds is None or done < rounds:
                self.clock.sleep(interval)
        return succeeded
