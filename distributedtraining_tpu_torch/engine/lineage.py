"""Per-miner contribution credit — the validator's part of the JAX
package's ``engine/lineage.py``: :func:`loo_credits` and
:class:`CreditLedger`, copied (pure Python, no tensors).

Lineage records, the drift detector and the replay audit belong to the
averager's lineage plane and are not ported yet (``--no-lineage``; ROADMAP
"Slices of the port", slice 5).
"""

from __future__ import annotations

import math
from typing import Sequence


def loo_credits(base_loss: float, scored: Sequence) -> dict[str, float]:
    """Per-miner leave-one-out improvement estimates from one validation
    round's evals. Each scored candidate is ``base + delta_i``, so
    ``base_loss - loss_i`` is delta_i's marginal improvement in
    isolation; under the linear mixing of the merge, removing miner i
    forfeits ``w_i * marginal_i``, with ``w_i`` the clamped-normalized
    score weights of the consensus merge
    (``delta.normalized_merge_weights``' rule). ``scored`` entries need
    ``hotkey``/``loss``/``score`` attributes (``validate.MinerScore``)."""
    if base_loss is None or not math.isfinite(float(base_loss)):
        return {}
    rows = [(s.hotkey, float(s.loss), max(float(s.score), 0.0))
            for s in scored
            if s.loss is not None and math.isfinite(float(s.loss))]
    if not rows:
        return {}
    total = sum(w for _, _, w in rows)
    m = len(rows)
    return {h: ((w / total) if total > 0 else 1.0 / m)
            * (float(base_loss) - loss)
            for h, loss, w in rows}


class CreditLedger:
    """Accumulates per-revision LOO credit into a per-miner total: one
    estimate per (revision, hotkey). Re-validating the same base revision
    replaces that revision's contribution instead of adding to it, so a
    long-lived base polled every round inflates no one's credit. History
    is bounded (``max_revisions``); an evicted revision's contributions
    stay in the totals (the ledger is cumulative; the per-revision detail
    is what ages out)."""

    def __init__(self, *, max_revisions: int = 64):
        self.max_revisions = max(1, int(max_revisions))
        self._by_rev: dict[str, dict[str, float]] = {}
        self._order: list[str] = []
        self._settled: dict[str, float] = {}   # evicted revisions' mass

    def update(self, revision: str | None, base_loss: float | None,
               scored: Sequence) -> dict[str, float]:
        """Fold one validation round; returns the per-miner credits
        attributed to ``revision`` this round."""
        credits = loo_credits(base_loss, scored)
        if not credits:
            return {}
        rev = revision or "?"
        if rev not in self._by_rev:
            self._order.append(rev)
            while len(self._order) > self.max_revisions:
                old = self._order.pop(0)
                for h, c in self._by_rev.pop(old, {}).items():
                    self._settled[h] = self._settled.get(h, 0.0) + c
        self._by_rev[rev] = dict(credits)
        return credits

    def totals(self) -> dict[str, float]:
        out = dict(self._settled)
        for per_rev in self._by_rev.values():
            for h, c in per_rev.items():
                out[h] = out.get(h, 0.0) + c
        return out

    def revisions(self) -> list[str]:
        return list(self._order)
