"""Batched cohort evaluation: score K candidate parameter trees per eval
pass — the port of the JAX package's ``engine/batched_eval.py`` in its
single-device spelling.

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

``stage_cohorts`` is the fetch/eval pipeline: a bounded background stager
(``data/prefetch.map_prefetch``) runs transport fetch, decode and screen
of cohort n+1 while the device evaluates cohort n.

Not ported: the mesh spelling (the candidate axis sharded over a device
mesh) raises, naming its slice; remediation's preference for buckets
already dispatched (``prefer_compiled``) comes with the remediation
plane (ROADMAP "Slices of the port", slice 7).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from .. import delta as delta_lib
from ..utils import obs

logger = logging.getLogger(__name__)

Params = dict[str, torch.Tensor]

_SLICES = "ROADMAP 'Slices of the port'"

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
        if getattr(engine, "mesh", None) is not None:
            raise NotImplementedError(
                f"BatchedCohortEvaluator on a mesh (the candidate axis "
                f"sharded across devices) is slice 7 ({_SLICES})")
        self.engine = engine
        # bucket sizes this evaluator has dispatched (the JAX package's
        # compiled programs; val.cohort_bucket_compiles counts new ones)
        self._buckets_seen: set[int] = set()

    # -- bucket policy ------------------------------------------------------
    def bucket_for(self, k: int) -> int:
        """Padded cohort size for ``k`` real candidates: the smallest
        bucket >= k (multiples of the top bucket beyond it)."""
        if k < 1:
            raise ValueError(f"cohort must hold >= 1 candidate, got {k}")
        for b in BUCKETS:
            if k <= b:
                return b
        big = BUCKETS[-1]
        return ((k + big - 1) // big) * big

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
        are padding and are not evaluated."""
        if k_real > len(stacked):
            raise ValueError(f"k_real {k_real} > {len(stacked)} candidates")
        if k_real == 0:
            return []
        k_pad = self.bucket_for(len(stacked))
        if k_pad not in self._buckets_seen:
            self._buckets_seen.add(k_pad)
            obs.count("val.cohort_bucket_compiles")
        # built once per cohort, not per batch
        cands = [base if d is None else candidate_params(base, d)
                 for d in stacked[:k_real]]
        model, loss = self.engine.model, self._loss_fn()
        totals: list = [None] * k_real
        counts: list = [None] * k_real
        for batch in batches:
            placed = self.engine.place_batch(batch)   # once per cohort
            for i, params in enumerate(cands):
                l, t = loss(model, params, placed)
                lt = l * t   # token-weighted, like TrainEngine.eval_step
                totals[i] = lt if totals[i] is None else totals[i] + lt
                counts[i] = t if counts[i] is None else counts[i] + t
        if counts[0] is None:
            return [(float("nan"), float("nan"))] * k_real
        # one host read per cohort
        read = torch.stack([torch.stack(totals), torch.stack(counts)]
                           ).to("cpu", torch.float64).numpy()
        out = []
        for total, count in zip(read[0], read[1]):
            if count == 0:
                out.append((float("nan"), float("nan")))
            else:
                mean = total / count
                out.append((float(mean), float(np.exp(mean))))
        return out

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
