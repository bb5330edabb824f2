"""Batched cohort evaluation: score K candidate parameter trees per eval
pass — the port of the JAX package's ``engine/batched_eval.py``.

The validator scores a cohort of up to K screened deltas together: each
candidate ``base + d_k`` (``d_k`` in the base's dtype) is built once per
cohort, and each eval batch is read and placed once per cohort and run
through every candidate, where the sequential path places it once per
miner. The JAX package runs the K candidates as one ``jax.vmap``-ed
program over a stacked ``[K, ...]`` tree; PyTorch compiles nothing, so
the port loops over the candidates. Per-candidate loss x token totals
stay on the device until one host read per cohort.

The loss is the engine's PLAIN task loss (``engine.train._default_lm_loss``)
even on a fused-loss engine, as in the JAX package: the same math as the
fused CE to rounding.

Cohorts keep the JAX bucket ladder (1/2/4/8/16, then multiples of 16):
``bucket_for`` and ``compiled_buckets`` answer as there. Padded slots are
zero deltas whose results the JAX package throws away; the port does not
evaluate them. The base can ride in slot 0 (``include_base=True``).

On a mesh (the engine's ``mesh``, one process a device) the candidate
axis is sharded over the merge axis (``parallel.collectives.merge_axis``)
as JAX's ``shard_map`` spelling shards it: ``bucket_for`` rounds up to a
multiple of the axis's size n, the rank at coordinate c builds and
evaluates only the real candidates of slots ``[c k/n, (c+1) k/n)``, each
eval batch is placed WHOLE on every rank (JAX's replicated batch), and
the per-candidate ``(loss x tokens, tokens)`` totals are all-gathered
along the axis: the only collective, then one host read a cohort. The
base is the whole tree on every rank (JAX ``P()``): the validator and
the averager keep it whole. ``candidate_batches`` counts the (candidate,
batch) forwards this rank ran.

``stage_cohorts`` is the fetch/eval pipeline: a bounded background stager
(``data/prefetch.map_prefetch``) runs transport fetch, decode and screen
of cohort n+1 while the device evaluates cohort n (never on a pod, where
staging holds the broadcasts).

The JAX package's ``prefer_compiled`` (pad a shrunken cohort up to a
bucket already dispatched, to reuse a compiled program) is not ported:
eager PyTorch compiles nothing and the port never evaluates padded
slots, so on one card a larger bucket changes no work, and on a mesh it
would only move the real candidates onto fewer ranks.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from .. import delta as delta_lib
from ..utils import devprof, obs

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

# the JAX package's bucket ladder for cohort padding
BUCKETS = (1, 2, 4, 8, 16)


@torch.no_grad()
def candidate_params(base: Params, delta) -> Params:
    """``base + delta`` with the delta (a dense wire tree or state dict)
    in the base's dtype — ``b + x.astype(b.dtype)`` of the JAX
    evaluator, so a bf16 wire delta cannot drag a candidate to bf16. One
    leaf at a time: no second full copy of the delta."""
    flat = delta_lib.flatten_tree(delta)
    delta_lib._same_keys(base, flat)
    return {k: b + delta_lib._dense_leaf(flat[k], b).to(b.dtype)
            for k, b in base.items()}


class BatchedCohortEvaluator:
    """Scores cohorts of candidates for one engine."""

    def __init__(self, engine):
        self.engine = engine
        # bucket sizes this evaluator has dispatched (the JAX package's
        # compiled programs; val.cohort_bucket_compiles counts new ones)
        self._buckets_seen: set[int] = set()
        # (candidate, eval batch) forwards run on this rank
        self.candidate_batches = 0

    def _mesh_axis(self):
        """``(mesh, merge axis)`` on a mesh, else ``(None, None)``."""
        mesh = getattr(self.engine, "mesh", None)
        if mesh is None:
            return None, None
        from ..parallel.collectives import merge_axis
        return mesh, merge_axis(mesh)

    # -- bucket policy ------------------------------------------------------
    def bucket_for(self, k: int) -> int:
        """Padded cohort size for ``k`` real candidates: the smallest
        bucket >= k (multiples of the top bucket beyond it), rounded up
        to a multiple of the mesh's merge axis."""
        if k < 1:
            raise ValueError(f"cohort must hold >= 1 candidate, got {k}")
        for b in BUCKETS:
            if k <= b:
                target = b
                break
        else:
            big = BUCKETS[-1]
            target = ((k + big - 1) // big) * big
        mesh, axis = self._mesh_axis()
        if mesh is not None:
            n = mesh.size(axis)
            target = ((target + n - 1) // n) * n
        return target

    def compiled_buckets(self) -> frozenset:
        """Bucket sizes already dispatched."""
        return frozenset(self._buckets_seen)

    def _loss_fn(self) -> Callable:
        """The plain task loss, also on a fused-loss engine (see the
        module docstring)."""
        from .train import _default_lm_loss
        return _default_lm_loss

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate_stacked(self, base: Params, stacked: Sequence, k_real: int,
                         batches: Iterable[dict]
                         ) -> list[tuple[float, float]]:
        """Per-candidate ``(mean loss, perplexity)`` for the first
        ``k_real`` slots of a candidate list: each slot a dense delta, or
        None for the zero delta (the base itself). Slots past ``k_real``
        are padding and are not evaluated. On a mesh every rank calls
        this with the same list and batches, and evaluates its block."""
        if k_real > len(stacked):
            raise ValueError(f"k_real {k_real} > {len(stacked)} candidates")
        if k_real == 0:
            return []
        k_pad = self.bucket_for(len(stacked))
        if k_pad not in self._buckets_seen:
            self._buckets_seen.add(k_pad)
            obs.count("val.cohort_bucket_compiles")
        mesh, axis = self._mesh_axis()
        if mesh is None:
            slots = range(k_pad)
        else:
            k_local = k_pad // mesh.size(axis)
            c = mesh.coords[axis]
            slots = range(c * k_local, (c + 1) * k_local)
        mine = [i for i in slots if i < k_real]
        # built once per cohort, not per batch
        cands = [base if stacked[i] is None else
                 candidate_params(base, stacked[i]) for i in mine]
        totals: list = [None] * len(cands)
        counts: list = [None] * len(cands)
        n_batches = 0
        for batch in batches:
            n_batches += 1
            if not cands:
                continue
            placed = self.engine.place_batch(batch)   # once per cohort
            _eval_cohort_batch(self, cands, placed, totals, counts, k_pad)
        self.candidate_batches += len(cands) * n_batches
        if n_batches == 0:   # the same on every rank: the same batches
            return [(float("nan"), float("nan"))] * k_real
        if mesh is None:
            read = torch.stack([torch.stack(totals), torch.stack(counts)])
        else:
            # this rank's block, zeros in its padding slots; the
            # all-gather is the program's only collective
            dev = self.engine.device
            local = torch.zeros((2, len(slots)), dtype=torch.float32,
                                device=dev)
            for j, i in enumerate(mine):
                local[0, i - slots.start] = totals[j]
                local[1, i - slots.start] = counts[j]
            from ..parallel import collectives as coll
            read = coll.all_gather(local, mesh, axis, 1)[:, :k_real]
        # one host read per cohort
        read = read.to("cpu", torch.float64).numpy()
        out = []
        for total, count in zip(read[0], read[1]):
            if count == 0:
                out.append((float("nan"), float("nan")))
            else:
                mean = total / count
                out.append((float(mean), float(np.exp(mean))))
        return out

    def _eval_batch(self, cands: list, placed: dict, totals: list,
                    counts: list, k_pad: int) -> None:
        """One placed batch through every candidate of this rank's
        block, its token-weighted totals added in place (the device
        observatory's ``eval.cohort``, bucket ``k_pad``)."""
        model, loss = self.engine.model, self._loss_fn()
        for i, params in enumerate(cands):
            l, t = loss(model, params, placed)
            lt = l * t   # token-weighted, like TrainEngine.eval_step
            totals[i] = lt if totals[i] is None else totals[i] + lt
            counts[i] = t if counts[i] is None else counts[i] + t

    def evaluate_cohort(self, base: Params, deltas: Sequence,
                        batches: Iterable[dict], *,
                        include_base: bool = False
                        ) -> list[tuple[float, float]]:
        """Score a cohort of dense deltas against ``base``, each eval
        batch placed once. With ``include_base`` the first entry is the
        base's own ``(loss, ppl)`` (a zero delta in slot 0)."""
        if not deltas and not include_base:
            return []
        stacked = ([None] if include_base else []) + list(deltas)
        return self.evaluate_stacked(base, stacked, len(stacked), batches)


_eval_cohort_batch = devprof.wrap(
    "eval.cohort", BatchedCohortEvaluator._eval_batch,
    bucket=lambda a, kw: a[-1])


# ---------------------------------------------------------------------------
# Fetch/eval pipelining
# ---------------------------------------------------------------------------

def stage_cohorts(items: Sequence, cohort_size: int, stage_one: Callable,
                  *, pipeline: bool = True, depth: int = 1,
                  stage_many: Callable | None = None) -> Iterator[list]:
    """Group ``items`` into cohorts of ``cohort_size`` and map
    ``stage_one`` over each — on a bounded background thread ``depth``
    cohorts ahead when ``pipeline``, so staging cohort n+1 (transport
    fetch, decode, screen) overlaps the caller's device eval of cohort n.

    ``stage_many`` (optional) stages a whole cohort in one call (the
    validator routes a cohort through the concurrent ingest pool).
    ``pipeline=False`` stages inline, on demand, in caller order. The
    pipelined iterator has ``close()``: stop the worker early on a failed
    round (a leaked stager would hold the staged deltas)."""
    if cohort_size < 1:
        raise ValueError(f"cohort_size must be >= 1, got {cohort_size}")
    groups = [list(items[i:i + cohort_size])
              for i in range(0, len(items), cohort_size)]

    def stage_group(group):
        # the stager's busy half of the pipeline's occupancy (the
        # consumer's wait half is val.stage_wait_ms in engine/validate.py)
        t0 = time.perf_counter()
        if stage_many is not None:
            out = stage_many(group)
        else:
            out = [stage_one(x) for x in group]
        obs.count("val.stage_busy_ms", (time.perf_counter() - t0) * 1e3)
        return out

    if not pipeline:
        return iter(stage_group(group) for group in groups)
    from ..data.prefetch import map_prefetch
    return map_prefetch(stage_group, groups, depth=depth)
