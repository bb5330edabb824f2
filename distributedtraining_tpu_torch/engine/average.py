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

:class:`GeneticMerge` (``--strategy genetic``) evolves a population of
mixing-weight vectors on the threefry draws of ``utils/prng.py`` and
scores each generation through the batched cohort evaluator (the flash
forward on the card); it takes dense deltas too.

On a mesh (the engine's ``mesh``: one process a device, under
``torchrun`` or the ``--multihost-*`` flags) the round follows the JAX
pod rules: the coordinator pulls the base and broadcasts it (a genesis
base is the same numpy draw on every rank, published by the
coordinator), syncs the metagraph and the consensus and broadcasts
them, and stages every submission for every rank (``stage(multi=True)``,
which densifies wire-v2 submissions: a mesh round launches no
dequant-scatter). The accepted deltas are stacked along a miner axis
padded to the merge bucket and sharded over the merge axis
(``parallel.collectives.stack_deltas_sharded``: each rank holds its
block, never the M x params stack). ``WeightedAverage`` merges by
``sharded_cohort_merge`` (local partial sums, one all-reduce);
``ParameterizedMerge``'s mixture is the same partial sum and all-reduce
under autograd, every rank running the whole val batch, so the backward
gives each rank the exact gradient of its own slots and one all-reduce
of the logits' gradient over the merge axis makes it the global one
(the logits and the optimizer state stay replicated);
``GeneticMerge`` evaluates its tiers one candidate at a time. The base
stays whole on every rank, evaluations go through the mesh engine, the
coordinator alone publishes (monolithic only: no shard plane on a pod)
and broadcasts the revision, and the skip of a declined submission set
is off. ``OuterOptMerge`` and the tree's root wrap this unchanged. A
publication lease on a pod lives on the coordinator: ``renew`` and
``stamp`` run there (``train.coordinator_call``) and every rank gets the
verdict, so a stand-down skips the publish on all of them.

With ``lora_cfg`` LoRA adapter submissions are densified at staging and
merged as any other. With ``fleet`` (``engine/health.FleetMonitor``)
every gather polls the fleet's heartbeats and the ledger sees every
staging outcome; ``remediation`` excludes its quarantined miners from
staging; every ``run_round`` exit (merged, declined, stood down or
empty) evaluates the SLOs, lets remediation act and flushes the ledger
through ``metrics`` (``_fleet_round_end``). On a pod both live on the
coordinator alone.
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
        submissions (dense wire trees, state dicts or packed trees), or
        on a mesh over this rank's block of the sharded stack."""
        w = self._weights(miner_ids, consensus)
        if getattr(engine, "mesh", None) is not None:
            # local partial sums over this rank's block, one all-reduce
            from ..parallel.collectives import sharded_cohort_merge
            merged = sharded_cohort_merge(base, stacked, w)
        elif any(delta_lib.is_packed_v2(d) for d in stacked):
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
        from ..parallel import multihost
        # one writer: every rank holds the same velocity
        if self.state_path is not None and multihost.is_coordinator():
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

    def _mixture(self, w, base: Params, placed) -> Params:
        from ..parallel.collectives import ShardedStack, local_merge
        if isinstance(placed, ShardedStack):
            # normalized over the real miners, zero-padded to the stack
            def padded(v):
                n = self._norm(v)
                return torch.cat([n, n.new_zeros(placed.m_pad - len(n))])
            return local_merge(base, placed,
                               {k: padded(v) for k, v in w.items()}
                               if self.per_tensor else padded(w))
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
        from ..parallel import collectives as coll
        from .train import _default_lm_loss
        m = len(miner_ids)
        sharded = isinstance(stacked, coll.ShardedStack)
        if m == 0 or (stacked.m_pad < m if sharded else len(stacked) != m):
            raise ValueError(f"deltas do not match {m} miners")
        placed = (stacked if sharded else
                  [delta_lib.place_delta(d, base) for d in stacked])
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
                if sharded:
                    # each rank's gradient covers its own slots: the sum
                    # over the merge axis is the global one, the same on
                    # every rank
                    flat = coll.all_reduce_(torch.cat(grads), placed.mesh,
                                            placed.axis)
                    grads = flat.split([len(g) for g in grads])
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


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over a vector, in its order of operations:
    ``exp(x - max) / sum(exp(x - max))``."""
    e = torch.exp(x - x.max())
    return e / e.sum()


class GeneticMerge:
    """Evolutionary weight search (GeneticAverager, averaging_logic.py:
    830-970): a population of mixing-weight vectors, Gaussian mutation,
    elite selection by held-out loss; the JAX package's ``GeneticMerge``.

    Selection runs as successive halving: candidates are ranked on the
    first ``screen_batches`` val batches and only the elites pay a
    full-set eval (``screen_batches=None``: every rank on the full set).
    Losses are memoized on the weight vector's bytes and the tier, so an
    elite that recurs is never evaluated twice. With ``batched`` a tier's
    uncached candidates go through the cohort evaluator
    (engine/batched_eval.py) as candidate deltas ``sum_i w_i d_i``, each
    val batch placed once for them all; a lone candidate takes
    ``engine.evaluate``. The final pick is over the screened survivors and
    the last generation's elites.

    The draws are ``jax.random``'s on the threefry of utils/prng.py, made
    on the CPU: the keys, the parent picks and the uniforms are the JAX
    package's bits, a normal within a few ulps of its (XLA's ``log1p``),
    then ``softmax`` in ``jax.nn.softmax``'s order. The vectors are placed
    on the base's device only to merge. ``last_memo`` keeps the round's
    ``{(vector bytes, full tier): loss}``: each entry is one candidate's
    evaluation over its tier's batches."""

    def __init__(self, *, population: int = 10, generations: int = 10,
                 sigma: float = 0.1, elite: int = 2, seed: int = 0,
                 screen_batches: int | None = 2, batched: bool = True):
        if screen_batches is not None and screen_batches < 1:
            # 0 would slice an empty iterator: NaN losses, an arbitrary
            # pick and no error
            raise ValueError("screen_batches must be >= 1 or None "
                             f"(full-set fitness), got {screen_batches}")
        self.population = population
        self.generations = generations
        self.sigma = sigma
        self.elite = elite
        self.seed = seed
        self.screen_batches = screen_batches
        self.batched = batched
        self.last_memo: dict[tuple[bytes, bool], float] = {}

    def lineage_weights(self, weights):
        """The winning vector is the linear mix the merge applies
        (``base + sum_i w_i d_i``), so the record replays."""
        return weights

    def first_population(self, rng: torch.Tensor, m: int):
        """``(rng, population)``: the uniform vector, then ``population -
        1`` draws ``softmax(normal(k, m))``, one split key each."""
        from ..utils import prng
        pop = [torch.full((m,), 1.0 / m, dtype=torch.float32,
                          device=rng.device)]
        for _ in range(self.population - 1):
            rng, k = prng.split(rng)
            pop.append(_softmax(prng.normal(k, m)))
        return rng, pop

    def breed(self, rng: torch.Tensor, elites: list, m: int):
        """``(rng, next population)``: the elites, then children
        ``softmax(parent + sigma * normal(k2, m))`` with the parent picked
        by ``randint(k1, 0, elite)``."""
        from ..utils import prng
        children = list(elites)
        while len(children) < self.population:
            rng, k1, k2 = prng.split(rng, 3)
            parent = elites[int(prng.randint(k1, 1, 0, self.elite)[0])]
            child = parent + self.sigma * prng.normal(k2, m)
            children.append(_softmax(child))
        return rng, children

    def merge(self, engine, base: Params, stacked: Sequence, miner_ids:
              list[str], *, val_batches: Callable[[], Iterable[dict]],
              consensus=None):
        """``(merged, w)``: the mixture at the winning weight vector ``w``
        (an ``(M,)`` f32 CPU tensor)."""
        import itertools

        from ..utils import prng
        from .batched_eval import BatchedCohortEvaluator
        from ..parallel.collectives import ShardedStack, local_merge
        m = len(miner_ids)
        sharded = isinstance(stacked, ShardedStack)
        if m == 0 or (stacked.m_pad < m if sharded else len(stacked) != m):
            raise ValueError(f"deltas do not match {m} miners")
        placed = (stacked if sharded else
                  [delta_lib.place_delta(d, base) for d in stacked])
        dev = next(iter(base.values())).device
        # on a mesh the tiers stay sequential, as in JAX: each candidate
        # is one merge (partial sums, one all-reduce) and one evaluation
        evaluator = (BatchedCohortEvaluator(engine)
                     if self.batched and not sharded else None)
        cache: dict[tuple[bytes, bool], float] = {}
        self.last_memo = cache

        def merge_fn(w):
            if sharded:
                return local_merge(base, placed, torch.cat(
                    [w, w.new_zeros(placed.m_pad - m)]))
            return delta_lib.weighted_merge(base, placed, w.to(dev))

        def batches_for(full: bool):
            batches = val_batches()
            if not full and self.screen_batches is not None:
                batches = itertools.islice(batches, self.screen_batches)
            return batches

        def _eval(w, *, full: bool) -> float:
            key = (w.numpy().tobytes(), full)
            if key not in cache:
                with torch.no_grad():
                    cache[key], _ = engine.evaluate(
                        engine.local(merge_fn(w)), batches_for(full))
            return cache[key]

        def _eval_many(ws, *, full: bool) -> None:
            """Fill the memo for every uncached vector of ``ws``: one
            cohort through the batched evaluator, or one at a time."""
            uniq, seen = [], set()
            for w in ws:
                k = w.numpy().tobytes()
                if (k, full) not in cache and k not in seen:
                    seen.add(k)
                    uniq.append(w)
            if not uniq:
                return
            if evaluator is None or len(uniq) == 1:
                for w in uniq:
                    _eval(w, full=full)
                return
            with torch.no_grad():
                cands = delta_lib.combine_candidate_deltas(
                    base, placed, torch.stack(uniq))
                scored = evaluator.evaluate_stacked(base, cands, len(uniq),
                                                    batches_for(full))
            for w, (loss, _) in zip(uniq, scored):
                cache[(w.numpy().tobytes(), full)] = loss

        full_screen = self.screen_batches is None

        def screen(w) -> float:   # the cheap ranking tier
            return _eval(w, full=full_screen)

        def fitness(w) -> float:  # the full-set tier
            return _eval(w, full=True)

        rng, pop = self.first_population(prng.prng_key(self.seed), m)
        elites: list = []   # generations 0: the best of the first draw
        for gen in range(self.generations):
            _eval_many(pop, full=full_screen)
            scored = sorted(pop, key=screen)
            _eval_many(scored[: self.elite * 2], full=True)
            elites = sorted(scored[: self.elite * 2],
                            key=fitness)[: self.elite]
            rng, pop = self.breed(rng, elites, m)
            logger.info("genetic gen %d best loss=%.4f", gen + 1,
                        fitness(elites[0]))
        # the screened survivors plus the last elites, whose full-set
        # losses are cached: a noisy last screen cannot drop the best
        _eval_many(pop, full=full_screen)
        finalists = sorted(pop, key=screen)[: max(self.elite, 2)] + elites
        _eval_many(finalists, full=True)
        best = min(finalists, key=fitness)
        with torch.no_grad():
            return merge_fn(best), best


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


class AveragerLoop:
    """run_periodic_averaging parity (averaging_logic.py:544-583): pull the
    base, gather and screen every miner delta, merge via the strategy,
    publish the new base (and, with ``base_dist``, its shards and
    manifest; with ``lineage``, its record; with ``lease``, only while
    the lease is held). On one host or over a mesh of processes (the
    module docstring); with ``hierarchy`` the root of a tree (the cohort
    is the ``__agg__`` ids of those nodes, mixed by their riders' weight
    sums); with ``fleet`` and ``remediation`` under the health plane."""

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
                 lora_cfg=None,
                 fleet=None,
                 remediation=None):
        if stale_deltas not in ("skip", "accept"):
            raise ValueError(f"stale_deltas must be 'skip' or 'accept', "
                             f"got {stale_deltas!r}")
        if publish_policy not in ("improved", "always"):
            raise ValueError(f"publish_policy must be 'improved' or "
                             f"'always', got {publish_policy!r}")
        self.engine = engine
        self.transport = transport
        # LoRA submissions (models.lora.LoRAConfig), densified at staging
        self.lora_cfg = lora_cfg
        self.lineage = lineage
        self.base_dist = base_dist
        # publication lease (engine/remediate.LeaseManager): renewed right
        # before every publish, stamped after it; None: single averager
        self.lease = lease
        # the fleet health plane and remediation (the coordinator's)
        self.fleet = fleet
        self.remediation = remediation
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

    # -- a world of several processes ----------------------------------------
    def _multi(self) -> bool:
        from .train import mesh_spans
        return mesh_spans(self.engine)

    def _publish(self, params: Params):
        """Publish ``params`` as the base; on a pod the coordinator alone
        materializes and publishes it, and every rank gets its revision
        (or raises, when the coordinator's publish failed). Returns
        ``(revision, wire tree or None)``."""
        from ..models.gpt2 import params_to_numpy
        from .train import wire_out

        def wire():   # artifacts travel unrolled (train.wire_out)
            return params_to_numpy(wire_out(self.engine, params))

        if not self._multi():
            wire_tree = wire()
            return self.transport.publish_base(wire_tree), wire_tree
        from .train import coordinator_call
        # a failed publish fails the round on every rank, in step
        return coordinator_call(
            lambda: self.transport.publish_base(wire()),
            "base publish"), None

    def bootstrap(self, seed: int = 0, params=None) -> None:
        """Pull the published base if one exists; else publish a genesis
        base: ``params`` (a nested tree or state dict, or a zero-argument
        callable returning one, invoked only here) or a random init drawn
        with numpy from ``seed`` (the same on every rank)."""
        from ..models import init_params_numpy
        if self._multi():
            # the coordinator reads, every rank gets the same base
            from .train import broadcast_base_fetch
            fetched = broadcast_base_fetch(self.transport,
                                           self._host_template(), None)
        else:
            fetched = (self.transport.fetch_base(self._host_template())
                       if self.transport.base_revision() is not None
                       else None)
        from .train import wire_in
        if fetched is not None:
            self.base_params = self._place(wire_in(self.engine, fetched[0]))
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
            self._base_revision, wire_tree = self._publish(self.base_params)
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
        (``WeightedAverage``) off a mesh and off the scan layout (a
        packed tree is wire layout, and a restack would mangle its
        entries); the parameterized merge, a mesh's sharded stack and a
        scan engine get them dense."""
        if self._ingestor is None:
            from .ingest import DeltaIngestor
            from .train import _scan_wire_adapters
            self._ingestor = DeltaIngestor(
                self.transport, self._host_template,
                lora_cfg=self.lora_cfg,
                quant_template=self._quant_template,
                accept_quant=self.accept_quant,
                accept_wire_v2=self.accept_wire_v2,
                max_delta_abs=self.max_delta_abs,
                stale_deltas=self.stale_deltas,
                workers=self.ingest_workers,
                cache_bytes=self.ingest_cache_mb * (1 << 20),
                span_prefix="avg",
                observer=(self.fleet.record_staging
                          if self.fleet is not None else None),
                densify=not (getattr(self.strategy, "host_list_ingest",
                                     False)
                             and getattr(self.engine, "mesh", None) is None
                             and not _scan_wire_adapters(
                                 self.engine.model)))
        return self._ingestor

    def close(self) -> None:
        """Drop the ingest pool's and the fleet's worker threads
        (idempotent)."""
        if self._ingestor is not None:
            self._ingestor.close()
        if self.fleet is not None:
            self.fleet.close()

    def gather_deltas(self) -> tuple[list[str], list]:
        """``(accepted hotkeys, their staged submissions)``: dense trees
        in the engine's layout (:func:`train.wire_in`) and packed trees
        (wire layout by definition), as host data (the same on every
        rank of a pod)."""
        from .train import wire_in
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
            if self._multi():
                from .train import broadcast_metagraph
                meta = broadcast_metagraph(self.chain)
            else:
                meta = self.chain.sync()
            hotkeys = [h for h in meta.hotkeys
                       if h != getattr(self.chain, "my_hotkey", None)]
        if self.fleet is not None:
            # one observation round before staging: the staging observer
            # then folds outcomes into the advanced round
            try:
                self.fleet.poll(hotkeys)
            except Exception:
                logger.exception("averager: fleet heartbeat poll failed")
        staged = self._ingest().stage(
            hotkeys, base_revision=self._base_revision,
            multi=self._multi(),
            exclude=(self.remediation.is_excluded
                     if self.remediation is not None else None))
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
            deltas.append(s.delta if delta_lib.is_packed_v2(s.delta)
                          else wire_in(self.engine, s.delta))
        self._round_cids = {h: c for h, c in self._round_cids.items()
                            if h in set(ids)}
        self.report.last_accepted = len(ids)
        self.report.last_rejected = rejected
        return ids, deltas

    def _delta_fingerprint(self, ids: list[str]):
        """The (hotkey, delta_revision) set of this round's submissions,
        from this round's ingest probes (single host: a pod re-merges)."""
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
        monolithic base, never fails the round. Not on a pod, whose
        coordinator publishes monolithic only (as JAX's)."""
        if self.base_dist is None or self._base_revision is None \
                or self._multi():
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
        """The lease's renewal verdict: the coordinator's on a pod,
        where only it reads and writes the token. Any failure reads as
        not held (fail-safe)."""
        try:
            if not self._multi():
                return bool(self.lease.renew())
            from .train import coordinator_call
            return bool(coordinator_call(self.lease.renew, "lease renew"))
        except Exception:
            logger.exception("averager: lease renewal failed")
            return False

    def _stamp_lease(self) -> int:
        """Stamp the token with the revision just published; returns the
        held epoch (the coordinator's, on every rank of a pod)."""
        def stamp():
            self.lease.stamp(self._base_revision)
            return self.lease.epoch
        if not self._multi():
            return stamp()
        from .train import coordinator_call
        return int(coordinator_call(stamp, "lease stamp"))

    def _log(self, record: dict) -> None:
        if self.metrics:
            self.metrics.log(record, step=self.report.rounds)
            obs.flush(self.metrics, step=self.report.rounds)

    def _fleet_round_end(self) -> None:
        """The SLOs, remediation's actions and the ledger's flush at the
        round cadence: on every ``run_round`` exit, so staleness advances
        and breaches fire when nothing merges. Health-plane failures
        never fail a round."""
        if self.fleet is None:
            return
        try:
            breaches = self.fleet.evaluate_slos()
            if self.remediation is not None:
                # before the flush: the ledger records the new state
                self.remediation.observe_round(breaches)
            self.fleet.flush(self.metrics, step=self.report.rounds)
        except Exception:
            logger.exception("averager: fleet round-end failed")

    def run_round(self) -> bool:
        """One averaging cycle; True when deltas were gathered and merged
        (whether or not the publish guard let the result replace the
        base), False when there was nothing to merge."""
        if self.base_params is None:
            self.bootstrap()
        ids, deltas = self.gather_deltas()
        if not ids:
            logger.info("averager: no valid deltas this round")
            self._fleet_round_end()
            return False
        if (self._declined_fp is not None and not self._multi()
                and self._delta_fingerprint(ids) == self._declined_fp):
            # the exact submission set already merged and declined
            logger.info("averager: submissions unchanged since the "
                        "declined merge; skipping recompute")
            self._fleet_round_end()
            self.report.rounds += 1
            return True
        mesh = getattr(self.engine, "mesh", None)
        stacked = deltas
        if mesh is not None:
            # the miner axis padded to the merge bucket and sharded over
            # the merge axis: this rank holds its block only
            from ..parallel.collectives import (merge_axis, merge_bucket,
                                                stack_deltas_sharded)
            axis = merge_axis(mesh)
            stacked = stack_deltas_sharded(
                deltas, mesh, axis=axis,
                target=merge_bucket(len(deltas), mesh, axis),
                device=self.engine.device)
        if self.hierarchy is not None:
            # per-subtree mixing by each aggregate's declared weight sum
            # (a missing rider reads 1.0, as a riderless delta is accepted)
            consensus = {h: self._round_agg_weights.get(h, 1.0)
                         for h in ids}
        elif self._multi():
            from .train import coordinator_call
            consensus = coordinator_call(
                getattr(self.chain, "consensus_scores", lambda: {}),
                "consensus read") or {}
        else:
            consensus = getattr(self.chain, "consensus_scores",
                                lambda: {})()
        cids = [c for c in (self._round_cids.get(h) for h in ids) if c]
        with obs.span("avg.merge", miners=len(ids), cids=cids):
            merged, weights = self.strategy.merge(
                self.engine, self.base_params, stacked, ids,
                val_batches=self.val_batches, consensus=consensus)
        del stacked
        with obs.span("avg.eval"):
            loss, ppl = self.engine.evaluate(self.engine.local(merged),
                                             self.val_batches())
        if self.publish_policy == "improved":
            if self._base_loss is None:
                self._base_loss, _ = self.engine.evaluate(
                    self.engine.local(self.base_params), self.val_batches())
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
                self._fleet_round_end()
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
            from ..parallel import multihost
            if multihost.is_coordinator():   # one count for the world
                obs.count("avg.lease_standdowns")
            self.report.last_loss = loss
            self.report.skipped_publishes += 1
            self._log({"merged_loss": loss, "merged_ppl": ppl,
                       "accepted": len(ids), "published": 0,
                       "lease_lost": 1,
                       "merge_delta_ids": dict(self._round_cids)})
            self._fleet_round_end()
            self.report.rounds += 1
            return True
        self.report.last_loss = loss
        parent_revision = self._base_revision
        with obs.span("avg.publish", cids=cids):
            self._base_revision, wire_tree = self._publish(merged)
            self._publish_base_dist(wire_tree)
        del wire_tree
        lease_epoch = None
        if self.lease is not None:
            # the token now names the revision published under its epoch
            lease_epoch = self._stamp_lease()
            obs.gauge("avg.lease_epoch", float(lease_epoch))
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
                   "lease_epoch": lease_epoch,
                   "merge_delta_ids": dict(self._round_cids)})
        self._fleet_round_end()
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
