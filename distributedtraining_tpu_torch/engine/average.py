"""Averager engine: merge miner deltas into the next base model — the port
of the JAX package's ``engine/average.py`` for the flat, single-host
averager with the weighted strategy (``--strategy weighted``).

:class:`WeightedAverage` weighs each accepted miner's delta by its
normalized validator consensus score. It takes the round's submissions as
a HOST list: dense deltas merge ``chunk_size`` at a time
(``delta.chunked_weighted_merge``), and a list holding wire-v2 PACKED
submissions folds through ``delta.aggregate_deltas``, one contribution at
a time into one f32 accumulator, each indexed leaf through the CUDA
dequantize-scatter-add kernel on the card — never an M x params stack and
never a per-miner densify.

:class:`AveragerLoop` is the round: bootstrap (pull the published base,
or publish a genesis base), gather and screen every miner's submission
through ``engine/ingest.py`` (packed submissions stay packed:
``densify=False``), merge, evaluate the merged base on held-out batches,
publish it when the ``improved`` guard allows (or ``always``), and skip a
recompute when the exact submission set was already merged and declined.

Not ported yet, and refused with NotImplementedError naming the slice
(ROADMAP "Slices of the port"): ``ParameterizedMerge``, ``GeneticMerge``
and ``OuterOptMerge``, and the loop's ``hierarchy``, ``lease``,
``lineage`` and ``base_dist`` planes (slice 5), ``fleet``,
``remediation`` and LoRA submissions (slice 7); a device mesh is refused
by the engine (``TrainEngine(mesh=...)``, slice 7).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .. import delta as delta_lib
from ..utils import obs
from .scheduler import Clock, RealClock

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

_SLICES = "ROADMAP 'Slices of the port'"


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

class WeightedAverage:
    """Fixed-weight merge; weights default to validator consensus scores
    (normalized over the real cohort; uniform when ``uniform`` or when no
    scores exist). The consensus -> weights normalization is memoized on
    ``(cohort, scores)`` (``merge.weights_reused`` counts the reuses)."""

    # tells AveragerLoop to hand over the raw host list of submissions
    host_list_ingest = True

    def __init__(self, *, uniform: bool = False, chunk_size: int = 8):
        self.uniform = uniform
        self.chunk_size = chunk_size
        self._weights_cache: tuple | None = None

    def _weights(self, miner_ids: list[str],
                 consensus: dict[str, float] | None) -> np.ndarray:
        if self.uniform or not consensus:
            key = (tuple(miner_ids), None)
        else:
            key = (tuple(miner_ids),
                   tuple(float(consensus.get(h, 0.0)) for h in miner_ids))
        if self._weights_cache is not None and self._weights_cache[0] == key:
            obs.count("merge.weights_reused")
            return self._weights_cache[1]
        w = delta_lib.normalized_merge_weights(
            miner_ids, None if self.uniform else consensus)
        self._weights_cache = (key, w)
        return w

    @torch.no_grad()
    def merge(self, engine, base: Params, stacked: Sequence, miner_ids:
              list[str], *, val_batches=None,
              consensus: dict[str, float] | None = None
              ) -> tuple[Params, np.ndarray]:
        """``(base + sum_i w_i * delta_i, w)`` over a host list of
        submissions (dense wire trees, state dicts or packed trees)."""
        w = self._weights(miner_ids, consensus)
        if any(delta_lib.is_packed_v2(d) for d in stacked):
            # the f32 aggregate folds into the base in the base's dtype
            agg = delta_lib.aggregate_deltas(base, stacked, w)
            merged = {k: b + agg[k].to(b.dtype) for k, b in base.items()}
        else:
            merged = delta_lib.chunked_weighted_merge(
                base, stacked, w, chunk=self.chunk_size)
        return merged, w


def _not_ported(name: str, what: str, slice_no: int):
    class _Refused:
        __doc__ = (f"{what}: not ported yet (ROADMAP 'Slices of the port', "
                   f"slice {slice_no}); constructing one raises.")

        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name}: {what} is not ported to the PyTorch averager yet "
                f"({_SLICES}, slice {slice_no})")

    _Refused.__name__ = _Refused.__qualname__ = name
    return _Refused


ParameterizedMerge = _not_ported(
    "ParameterizedMerge", "the meta-learned per-miner merge (--strategy "
    "parameterized)", 5)
GeneticMerge = _not_ported(
    "GeneticMerge", "the genetic merge (--strategy genetic)", 5)
OuterOptMerge = _not_ported(
    "OuterOptMerge", "the outer Nesterov step (--outer-momentum)", 5)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AveragerReport:
    rounds: int = 0
    last_accepted: int = 0
    last_rejected: int = 0
    last_loss: float = float("nan")
    skipped_publishes: int = 0


_LOOP_NOT_PORTED = {
    "fleet": ("the fleet health plane", 7),
    "remediation": ("remediation", 7),
    "lease": ("the publication lease (failover)", 5),
    "hierarchy": ("the tree averager (--hier)", 5),
    "lineage": ("lineage records", 5),
    "base_dist": ("the sharded base distribution (--base-wire-v2)", 5),
    "lora_cfg": ("LoRA adapter submissions", 7),
}


class AveragerLoop:
    """run_periodic_averaging parity (averaging_logic.py:544-583): pull the
    base, gather and screen every miner delta, merge via the strategy,
    publish the new base. Flat and single-host; the planes of
    ``_LOOP_NOT_PORTED`` raise when given."""

    def __init__(self, engine, transport, chain, strategy, *,
                 val_batches: Callable[[], Iterable[dict]],
                 address_store=None,
                 clock: Clock | None = None,
                 max_delta_abs: float | None = 1e3,
                 metrics=None,
                 accept_quant: bool = True,
                 accept_wire_v2: bool = True,
                 stale_deltas: str = "skip",
                 publish_policy: str = "improved",
                 ingest_workers: int = 4,
                 ingest_cache_mb: int = 2048,
                 **unported):
        for name, value in unported.items():
            if name not in _LOOP_NOT_PORTED:
                raise TypeError(f"AveragerLoop got an unexpected keyword "
                                f"argument {name!r}")
            if value is not None:
                what, slice_no = _LOOP_NOT_PORTED[name]
                raise NotImplementedError(
                    f"AveragerLoop({name}=...): {what} is slice {slice_no} "
                    f"({_SLICES})")
        if not getattr(strategy, "host_list_ingest", False):
            raise NotImplementedError(
                f"strategy {type(strategy).__name__}: the port's averager "
                f"merges host lists (WeightedAverage); the stacked "
                f"strategies are slice 5 ({_SLICES})")
        if stale_deltas not in ("skip", "accept"):
            raise ValueError(f"stale_deltas must be 'skip' or 'accept', "
                             f"got {stale_deltas!r}")
        if publish_policy not in ("improved", "always"):
            raise ValueError(f"publish_policy must be 'improved' or "
                             f"'always', got {publish_policy!r}")
        self.engine = engine
        self.transport = transport
        self.chain = chain
        self.strategy = strategy
        self.val_batches = val_batches
        self.address_store = address_store
        self.clock = clock or RealClock()
        self.max_delta_abs = max_delta_abs
        self.metrics = metrics
        self.accept_quant = accept_quant
        self.accept_wire_v2 = accept_wire_v2
        # "skip": a delta whose rider names another base is not merged
        # (it would re-add the last merge's update); riderless deltas are
        # always accepted
        self.stale_deltas = stale_deltas
        # "improved": publish only when the merged base's held-out loss
        # does not exceed the current base's; "always" is the reference
        self.publish_policy = publish_policy
        self.ingest_workers = ingest_workers
        self.ingest_cache_mb = ingest_cache_mb
        self._ingestor = None
        self._round_revisions: dict[str, str | None] = {}
        self._round_cids: dict[str, str] = {}
        self.report = AveragerReport()
        self.base_params: Params | None = None
        self._base_revision = None
        self._base_loss = None     # cached eval of base_params (the guard)
        self._declined_fp = None   # submission set of the last declined merge
        self._host_template_cache = None
        self._quant_template_cache = None

    def _host_template(self):
        """The wire-layout template of every transport read."""
        if self._host_template_cache is None:
            from .train import _wire_template
            self._host_template_cache = _wire_template(self.engine.model)
        return self._host_template_cache

    def _quant_template(self):
        if self._quant_template_cache is None:
            self._quant_template_cache = delta_lib.quantized_template(
                self._host_template())
        return self._quant_template_cache

    def _place(self, tree) -> Params:
        from ..models.gpt2 import params_from_numpy
        return params_from_numpy(tree, device=self.engine.device)

    def bootstrap(self, seed: int = 0, params=None) -> None:
        """Pull the published base if one exists; else publish a genesis
        base: ``params`` (a nested tree or state dict, or a zero-argument
        callable returning one, invoked only here) or a random init drawn
        with numpy from ``seed``."""
        from ..models.gpt2 import init_params_numpy, params_to_numpy
        fetched = (self.transport.fetch_base(self._host_template())
                   if self.transport.base_revision() is not None else None)
        if fetched is not None:
            self.base_params = self._place(fetched[0])
            self._base_revision = fetched[1]
        else:
            given = params() if callable(params) else params
            if given is None:
                given = init_params_numpy(self.engine.model.cfg, seed)
            if any(isinstance(v, dict) for v in given.values()):
                self.base_params = self._place(given)
            else:
                self.base_params = {k: v.detach().to(self.engine.device,
                                                     copy=True)
                                    for k, v in given.items()}
            # the averager owns the shared base and publishes the first
            self._base_revision = self.transport.publish_base(
                params_to_numpy(self.base_params))
        self._base_loss = None   # new base: the guard re-evaluates lazily

    def _ingest(self):
        """The shared ingest front-end; packed submissions stay packed
        (the strategy folds host lists by scatter-add)."""
        if self._ingestor is None:
            from .ingest import DeltaIngestor
            self._ingestor = DeltaIngestor(
                self.transport, self._host_template,
                quant_template=self._quant_template,
                accept_quant=self.accept_quant,
                accept_wire_v2=self.accept_wire_v2,
                max_delta_abs=self.max_delta_abs,
                stale_deltas=self.stale_deltas,
                workers=self.ingest_workers,
                cache_bytes=self.ingest_cache_mb * (1 << 20),
                span_prefix="avg", densify=False)
        return self._ingestor

    def close(self) -> None:
        """Drop the ingest pool's worker threads (idempotent)."""
        if self._ingestor is not None:
            self._ingestor.close()

    def gather_deltas(self) -> tuple[list[str], list]:
        """``(accepted hotkeys, their staged submissions)``: dense wire
        trees and packed trees, as host data."""
        self._round_cids.clear()
        self._round_revisions.clear()
        meta = self.chain.sync()
        hotkeys = [h for h in meta.hotkeys
                   if h != getattr(self.chain, "my_hotkey", None)]
        staged = self._ingest().stage(hotkeys,
                                      base_revision=self._base_revision)
        ids, deltas = [], []
        rejected = 0
        for s in staged:
            self._round_revisions[s.hotkey] = s.revision
            if s.cid is not None:
                self._round_cids[s.hotkey] = s.cid
            if s.delta is None:
                if s.reason == "stale_base":
                    logger.info("averager: skipping %s (delta vs a "
                                "superseded base)", s.hotkey)
                    rejected += 1
                elif s.reason == "quarantined":
                    logger.info("averager: skipping %s (quarantined)",
                                s.hotkey)
                    rejected += 1
                elif s.reason != "no_delta":
                    logger.warning("averager: rejecting %s (%s)",
                                   s.hotkey, s.reason)
                    rejected += 1
                continue
            ids.append(s.hotkey)
            deltas.append(s.delta)
        self._round_cids = {h: c for h, c in self._round_cids.items()
                            if h in set(ids)}
        self.report.last_accepted = len(ids)
        self.report.last_rejected = rejected
        return ids, deltas

    def _delta_fingerprint(self, ids: list[str]):
        """The (hotkey, delta_revision) set of this round's submissions,
        from this round's ingest probes."""
        out = []
        for h in ids:
            rev = self._round_revisions.get(h)
            if rev is None:
                try:
                    rev = self.transport.delta_revision(h)
                except OSError:
                    return None
            out.append((h, rev))
        return frozenset(out)

    def _log(self, record: dict) -> None:
        if self.metrics:
            self.metrics.log(record, step=self.report.rounds)
            obs.flush(self.metrics, step=self.report.rounds)

    def run_round(self) -> bool:
        """One averaging cycle; True when deltas were gathered and merged
        (whether or not the publish guard let the result replace the
        base), False when there was nothing to merge."""
        from ..models.gpt2 import params_to_numpy
        if self.base_params is None:
            self.bootstrap()
        ids, deltas = self.gather_deltas()
        if not ids:
            logger.info("averager: no valid deltas this round")
            return False
        if (self._declined_fp is not None
                and self._delta_fingerprint(ids) == self._declined_fp):
            # the exact submission set already merged and declined
            logger.info("averager: submissions unchanged since the "
                        "declined merge; skipping recompute")
            self.report.rounds += 1
            return True
        consensus = getattr(self.chain, "consensus_scores", lambda: {})()
        cids = [c for c in (self._round_cids.get(h) for h in ids) if c]
        with obs.span("avg.merge", miners=len(ids), cids=cids):
            merged, weights = self.strategy.merge(
                self.engine, self.base_params, deltas, ids,
                val_batches=self.val_batches, consensus=consensus)
        with obs.span("avg.eval"):
            loss, ppl = self.engine.evaluate(merged, self.val_batches())
        if self.publish_policy == "improved":
            if self._base_loss is None:
                self._base_loss, _ = self.engine.evaluate(
                    self.base_params, self.val_batches())
            # the NOT-improved spelling: a NaN merged loss fails it
            if not (loss <= self._base_loss + 1e-6):
                logger.info(
                    "averager: merged loss %.4f would worsen the base "
                    "(%.4f); keeping the current base", loss,
                    self._base_loss)
                self.report.last_loss = self._base_loss
                self.report.skipped_publishes += 1
                self._log({"merged_loss": loss, "merged_ppl": ppl,
                           "base_loss": self._base_loss,
                           "accepted": len(ids), "published": 0,
                           "merge_delta_ids": dict(self._round_cids)})
                self.report.rounds += 1
                self._declined_fp = self._delta_fingerprint(ids)
                self.transport.gc()
                return True
        self.report.last_loss = loss
        with obs.span("avg.publish", cids=cids):
            self._base_revision = self.transport.publish_base(
                params_to_numpy(merged))
        self.base_params = merged
        self._base_loss = loss
        self._declined_fp = None
        self.transport.gc()
        self._log({"merged_loss": loss, "merged_ppl": ppl,
                   "accepted": len(ids), "published": 1,
                   "base_revision": self._base_revision,
                   "merge_delta_ids": dict(self._round_cids)})
        self.report.rounds += 1
        return True

    def run_periodic(self, *, interval: float = 1200.0,
                     rounds: int | None = None) -> int:
        """Run rounds forever (or ``rounds`` times); returns how many
        rounds merged (no exception and at least one accepted delta)."""
        done = merged = 0
        while rounds is None or done < rounds:
            try:
                if self.run_round():
                    merged += 1
            except Exception:
                logger.exception("averaging round failed; continuing")
            done += 1
            if rounds is None or done < rounds:
                self.clock.sleep(interval)
        return merged
