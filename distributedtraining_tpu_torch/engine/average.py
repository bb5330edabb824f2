"""Averager engine: merge miner deltas into the next base model — the port
of the JAX package's ``engine/average.py`` for the flat, single-host
averager (and the root of a tree, ``hierarchy``) with the weighted and
the parameterized strategies and the outer Nesterov step around either.

:class:`WeightedAverage` (``--strategy weighted``) weighs each accepted
miner's delta by its normalized validator consensus score. It takes the
round's submissions as a HOST list: dense deltas merge ``chunk_size`` at
a time (``delta.chunked_weighted_merge``), and a list holding wire-v2
PACKED submissions folds through ``delta.aggregate_deltas``, one
contribution at a time into one f32 accumulator, each indexed leaf
through the CUDA dequantize-scatter-add kernel on the card — never an
M x params stack and never a per-miner densify.

:class:`ParameterizedMerge` (``--strategy parameterized``, the default)
learns the mixing weights by gradient descent on the held-out loss of
the mixture: the model's forward and backward through the flash kernels.
It takes dense deltas, so the loop's ingest densifies wire-v2
submissions for it.

:class:`OuterOptMerge` (``--outer-momentum``) wraps either: a Nesterov
step over the round's merged delta with a velocity kept across rounds
(one more device tree the size of the model), committed only after a
publish lands and saved to ``state_path`` (msgpack, the JAX package's
bytes), so a declined round, a lease stand-down or a restart never
advances or loses it.

:class:`AveragerLoop` is the round: bootstrap (pull the published base,
or publish a genesis base), gather and screen every miner's submission
through ``engine/ingest.py``, merge, evaluate the merged base on held-out
batches, publish it when the ``improved`` guard allows (or ``always``),
and skip a recompute when the exact submission set was already merged
and declined. With ``base_dist`` (``engine/basedist.BasePublisher``)
every monolithic publish is followed by the changed base shards and the
revision's manifest; with ``lineage`` (``engine/lineage.LineagePlane``)
every publish, the genesis one included, freezes a content-addressed
lineage record. With ``lease`` (``engine/remediate.LeaseManager``) the
publication lease is renewed just before each publish (a lost lease
stands the round down) and stamped with the revision after it. With
``hierarchy`` (sub-averager node ids) the loop is the root of a tree
(``engine/hier_average.py``): it stages the ``__agg__.<node>``
aggregates and mixes them by the weight sums their riders declare.

Not ported yet, and refused with NotImplementedError naming the slice
(ROADMAP "Slices of the port"): ``GeneticMerge`` (slice 6: its draws
need threefry in torch), ``fleet``, ``remediation`` and LoRA
submissions (slice 7); a device mesh is refused by the engine
(``TrainEngine(mesh=...)``, slice 7).
"""

from __future__ import annotations

import dataclasses
import logging
import os
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

    def lineage_weights(self, weights):
        """The merge is linear in these exact normalized weights, so its
        lineage record replays."""
        return weights

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


class _SGD:
    """``optax.sgd(lr)``: ``w + (-lr * g)``, with the interface of
    ``train.AdamW`` (``init``, ``update_`` in place)."""

    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def init(self, params):
        return None

    @torch.no_grad()
    def update_(self, grads, state, params) -> None:
        for k, p in params.items():
            p.add_(grads[k] * -self.lr)


class OuterOptMerge:
    """Outer Nesterov step around any merge strategy (DiLoCo-style local
    SGD), the JAX package's ``OuterOptMerge``::

        delta_t  = inner_merge(base, deltas) - base
        v_t      = momentum * v_{t-1} + delta_t
        new_base = base + outer_lr * (momentum * v_t + delta_t)  [nesterov]
                 = base + outer_lr * v_t                         [plain]

    The velocity is a state dict on the base's device. ``merge`` leaves
    the new velocity pending; the loop's ``commit()`` after a landed
    publish makes it current and writes it to ``state_path`` (msgpack),
    so a round that does not publish never advances it. The first merge
    restores it from ``state_path`` when the file exists (zeros
    otherwise)."""

    @property
    def host_list_ingest(self) -> bool:
        """The inner strategy's ingest preference (the outer step never
        touches the submissions)."""
        return getattr(self.inner, "host_list_ingest", False)

    def lineage_weights(self, weights):
        """None: momentum carries earlier rounds, so the published base is
        not a linear mix of this round's deltas (attribution only)."""
        return None

    def __init__(self, inner, *, outer_lr: float = 0.7,
                 momentum: float = 0.9, nesterov: bool = True,
                 state_path: str | None = None):
        self.inner = inner
        self.outer_lr = outer_lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.state_path = state_path
        self.velocity: Params | None = None
        self._pending_velocity: Params | None = None

    @torch.no_grad()
    def _outer_step(self, base: Params, merged: Params, velocity: Params
                    ) -> tuple[Params, Params]:
        new, v_out = {}, {}
        for k, b in base.items():
            d = merged[k] - b
            v = self.momentum * velocity[k] + d
            upd = self.momentum * v + d if self.nesterov else v
            new[k] = b + self.outer_lr * upd
            v_out[k] = v
        return new, v_out

    def merge(self, engine, base: Params, stacked: Sequence, miner_ids:
              list[str], *, val_batches=None,
              consensus: dict[str, float] | None = None):
        merged, w = self.inner.merge(engine, base, stacked, miner_ids,
                                     val_batches=val_batches,
                                     consensus=consensus)
        if self.velocity is None:
            self.velocity = self._restore_velocity(base)
        new_base, self._pending_velocity = self._outer_step(
            base, merged, self.velocity)
        return new_base, w

    def _restore_velocity(self, base: Params) -> Params:
        if self.state_path is not None and os.path.exists(self.state_path):
            try:
                from .. import serialization as ser
                # shapes only: meta tensors allocate nothing
                template = delta_lib.nest_tree({
                    k: torch.empty(v.shape, device="meta")
                    for k, v in base.items()})
                host = delta_lib.flatten_tree(
                    ser.load_file(self.state_path, template))
                v = {k: torch.from_numpy(np.array(host[k])).to(b.device)
                     for k, b in base.items()}
                logger.info("outer-opt velocity restored from %s",
                            self.state_path)
                return v
            except Exception:
                logger.exception("outer-opt velocity restore failed; "
                                 "starting from zero momentum")
        return {k: torch.zeros_like(b) for k, b in base.items()}

    def commit(self) -> None:
        """Called by the loop after the merged base is published."""
        if self._pending_velocity is None:
            return
        self.velocity = self._pending_velocity
        self._pending_velocity = None
        if self.state_path is not None:
            try:
                from .. import serialization as ser
                from .publish import host_materialize
                ser.save_file(host_materialize(self.velocity),
                              self.state_path)
            except Exception:
                logger.exception("outer-opt velocity save failed")


class ParameterizedMerge:
    """Meta-learned mixing weights, the production merge
    (neurons/averager.py:102 -> averaging_logic.py:335-583).

    ``loss(w)`` is the held-out loss of ``base + sum_i softmax(w)_i *
    delta_i`` (``softmax_weights=False``: of ``sum_i w_i * delta_i``
    with raw weights, uniform 1/M at the start, as the reference keeps
    them); ``w`` (logits, zeros at the start: uniform) takes
    ``meta_epochs`` passes over ``val_batches()`` of ``meta_optimizer``
    at ``meta_lr`` (the reference's 7 and 0.01). ``per_tensor=True``
    learns one logit vector per parameter tensor (the reference's
    ``(num_models, num_params)`` matrix), False one per miner.

    Each meta-step is the model's forward and backward on the mixture
    (the flash-attention forward and backward kernels on the card), with
    the gradient taken with respect to ``w`` alone: base and deltas carry
    none, and no graph outlives its step. ``"adam"`` is ``optax.adam``
    (b1 0.9, b2 0.999, eps 1e-8, eps_root 0: ``train.AdamW`` with decay
    0), ``"sgd"`` is ``optax.sgd``. The deltas arrive dense (the loop's
    ingest densifies for this strategy) and are placed once a merge."""

    def __init__(self, model, *, meta_epochs: int = 7, meta_lr: float = 0.01,
                 per_tensor: bool = True, softmax_weights: bool = True,
                 meta_optimizer: str = "adam"):
        if meta_optimizer not in ("adam", "sgd"):
            raise ValueError(f"meta_optimizer must be 'adam' or 'sgd', "
                             f"got {meta_optimizer!r}")
        self.model = model
        self.meta_epochs = meta_epochs
        self.meta_lr = meta_lr
        self.per_tensor = per_tensor
        self.softmax_weights = softmax_weights
        self.meta_optimizer = meta_optimizer
        self.last_epoch_losses: list[float] = []

    def lineage_weights(self, weights):
        """The scalar-per-miner mix is linear in ``softmax(w)`` (in ``w``
        itself without the softmax), so a lineage record of it replays;
        per-tensor weights are not one scalar per miner, and give None."""
        if self.per_tensor:
            return None
        w = torch.as_tensor(weights).detach()
        return torch.softmax(w, dim=0) if self.softmax_weights else w

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        return torch.softmax(v, dim=0) if self.softmax_weights else v

    def _mixture(self, w, base: Params, placed: list) -> Params:
        if self.per_tensor:
            return delta_lib.per_tensor_weighted_merge(
                base, placed, {k: self._norm(v) for k, v in w.items()})
        return delta_lib.weighted_merge(base, placed, self._norm(w))

    def _tx(self):
        if self.meta_optimizer == "adam":
            from .train import AdamW
            return AdamW(self.meta_lr, weight_decay=0.0)
        return _SGD(self.meta_lr)

    def merge(self, engine, base: Params, stacked: Sequence, miner_ids:
              list[str], *, val_batches: Callable[[], Iterable[dict]],
              consensus=None):
        """``(merged, w)``: the mixture at the learned logits ``w`` (a
        dict keyed like ``base`` when per-tensor, else an ``(M,)``
        tensor)."""
        from .train import _default_lm_loss
        m = len(miner_ids)
        if m == 0 or len(stacked) != m:
            raise ValueError(f"{len(stacked)} deltas for {m} miners")
        placed = [delta_lib.place_delta(d, base) for d in stacked]
        dev = next(iter(base.values())).device
        names = list(base) if self.per_tensor else ["w"]
        # softmax(0) is uniform; raw weights start at 1/M
        init = 0.0 if self.softmax_weights else 1.0 / m
        leaves = {k: torch.full((m,), init, dtype=torch.float32, device=dev)
                  for k in names}
        tx = self._tx()
        opt_state = tx.init(leaves)
        self.last_epoch_losses = []
        for epoch in range(self.meta_epochs):
            last = None
            for batch in val_batches():
                batch = engine.place_batch(batch)
                for v in leaves.values():
                    v.requires_grad_(True)
                w = leaves if self.per_tensor else leaves["w"]
                loss, _ = _default_lm_loss(
                    self.model, self._mixture(w, base, placed), batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                tx.update_(dict(zip(names, grads)), opt_state, leaves)
                last = loss.detach()
            # one host read an epoch, for the log line
            value = float("nan") if last is None else float(last)
            self.last_epoch_losses.append(value)
            logger.info("meta-learning epoch %d/%d loss=%.4f",
                        epoch + 1, self.meta_epochs, value)
        with torch.no_grad():
            w = ({k: v.detach() for k, v in leaves.items()}
                 if self.per_tensor else leaves["w"].detach())
            merged = self._mixture(w, base, placed)
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


GeneticMerge = _not_ported(
    "GeneticMerge", "the genetic merge (--strategy genetic; its population "
    "draws use jax.random, so parity needs threefry2x32 in torch, the "
    "sampling work of slice 6)", 6)


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
    "lora_cfg": ("LoRA adapter submissions", 7),
}


class AveragerLoop:
    """run_periodic_averaging parity (averaging_logic.py:544-583): pull the
    base, gather and screen every miner delta, merge via the strategy,
    publish the new base (and, with ``base_dist``, its shards and
    manifest; with ``lineage``, its record; with ``lease``, only while
    the lease is held). Single-host; with ``hierarchy`` the root of a
    tree (the cohort is the ``__agg__`` ids of those nodes, mixed by
    their riders' weight sums); the planes of ``_LOOP_NOT_PORTED`` raise
    when given."""

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
                 lineage=None,
                 base_dist=None,
                 lease=None,
                 hierarchy: Sequence[str] | None = None,
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
        if stale_deltas not in ("skip", "accept"):
            raise ValueError(f"stale_deltas must be 'skip' or 'accept', "
                             f"got {stale_deltas!r}")
        if publish_policy not in ("improved", "always"):
            raise ValueError(f"publish_policy must be 'improved' or "
                             f"'always', got {publish_policy!r}")
        self.engine = engine
        self.transport = transport
        self.lineage = lineage
        self.base_dist = base_dist
        # publication lease (engine/remediate.LeaseManager): renewed right
        # before every publish, stamped after it; None: single averager
        self.lease = lease
        # the sub-averager node ids of a tree's root; None: flat
        self.hierarchy = list(hierarchy) if hierarchy else None
        # agg artifact id -> declared weight sum (its rider), per round
        self._round_agg_weights: dict[str, float] = {}
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
        # hotkey -> StagedDelta of the submissions accepted this round:
        # what the lineage record freezes (the merge's inputs)
        self._round_staged: dict = {}
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
            wire_tree = params_to_numpy(self.base_params)
            self._base_revision = self.transport.publish_base(wire_tree)
            self._publish_base_dist(wire_tree)
            if self.lineage is not None and self._base_revision:
                # the DAG's root: no parent, no contributions
                self.lineage.on_publish(
                    kind="base", revision=self._base_revision,
                    parent=None, round_no=self.report.rounds,
                    contributions=[], strategy="genesis",
                    replayable=False, weights_kind="none")
        self._base_loss = None   # new base: the guard re-evaluates lazily

    def _ingest(self):
        """The shared ingest front-end. Packed submissions stay packed
        when the strategy folds host lists by scatter-add
        (``WeightedAverage``); the parameterized merge gets them dense."""
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
                span_prefix="avg",
                densify=not getattr(self.strategy, "host_list_ingest",
                                    False))
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
        self._round_staged.clear()
        self._round_agg_weights.clear()
        if self.hierarchy is not None:
            # the root of a tree: the configured nodes' aggregates (a
            # reserved namespace no chain hotkey collides with)
            from ..transport.base import agg_id
            hotkeys = [agg_id(n) for n in self.hierarchy]
        else:
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
            if s.agg_weight is not None:
                self._round_agg_weights[s.hotkey] = s.agg_weight
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
            self._round_staged[s.hotkey] = s
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

    def _publish_base_dist(self, wire_tree) -> None:
        """The shard plane's publication of the revision that just landed
        monolithically; isolated: a failure leaves fetchers on the
        monolithic base, never fails the round."""
        if self.base_dist is None or self._base_revision is None:
            return
        try:
            self.base_dist.publish_revision(wire_tree, self._base_revision)
        except Exception:
            logger.exception("averager: sharded base publish failed; "
                             "fetchers stay on the monolithic base")

    def _record_lineage(self, ids: list[str], weights, consensus,
                        parent: str | None, loss: float) -> None:
        """The just-published revision's provenance record; isolated."""
        try:
            from . import lineage as lineage_lib
            w, wkind = lineage_lib.resolve_weights(self.strategy, weights,
                                                   len(ids))
            contribs = lineage_lib.contributions_from_staging(
                ids, w, self._round_staged, consensus=consensus,
                cids=self._round_cids)
            self.lineage.on_publish(
                kind="base", revision=self._base_revision, parent=parent,
                round_no=self.report.rounds, contributions=contribs,
                strategy=type(self.strategy).__name__,
                replayable=w is not None, weights_kind=wkind,
                loss=loss, parent_loss=self._base_loss)
        except Exception:
            logger.exception("averager: lineage record failed")

    def _lease_held(self) -> bool:
        try:
            return bool(self.lease.renew())
        except Exception:
            logger.exception("averager: lease renewal failed")
            return False

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
        if self.hierarchy is not None:
            # per-subtree mixing by each aggregate's declared weight sum
            # (a missing rider reads 1.0, as a riderless delta is accepted)
            consensus = {h: self._round_agg_weights.get(h, 1.0)
                         for h in ids}
        else:
            consensus = getattr(self.chain, "consensus_scores",
                                lambda: {})()
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
        if self.lease is not None and not self._lease_held():
            # a higher epoch exists (a standby took over while this
            # averager stalled): publishing would put two writers on the
            # shared base. Merged, not published; nothing commits.
            logger.warning("averager: publication lease not held; "
                           "standing down (merged but not published)")
            obs.count("avg.lease_standdowns")
            self.report.last_loss = loss
            self.report.skipped_publishes += 1
            self._log({"merged_loss": loss, "merged_ppl": ppl,
                       "accepted": len(ids), "published": 0,
                       "lease_lost": 1,
                       "merge_delta_ids": dict(self._round_cids)})
            self.report.rounds += 1
            return True
        self.report.last_loss = loss
        parent_revision = self._base_revision
        with obs.span("avg.publish", cids=cids):
            wire_tree = params_to_numpy(merged)
            self._base_revision = self.transport.publish_base(wire_tree)
            self._publish_base_dist(wire_tree)
        del wire_tree
        if self.lease is not None:
            # the token now names the revision published under its epoch
            self.lease.stamp(self._base_revision)
            obs.gauge("avg.lease_epoch", float(self.lease.epoch))
        if self.lineage is not None:
            # self._base_loss still holds the parent base's eval here
            self._record_lineage(ids, weights, consensus, parent_revision,
                                 loss)
        # round-spanning strategy state (OuterOptMerge's velocity) commits
        # only once the new base is out
        commit = getattr(self.strategy, "commit", None)
        if commit is not None:
            commit()
        self.base_params = merged
        self._base_loss = loss
        self._declined_fp = None
        self.transport.gc()
        self._log({"merged_loss": loss, "merged_ppl": ppl,
                   "accepted": len(ids), "published": 1,
                   "base_revision": self._base_revision,
                   "lease_epoch": self.lease.epoch if self.lease else None,
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
