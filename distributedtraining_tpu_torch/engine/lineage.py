"""Model lineage and contribution attribution — the port of the JAX
package's ``engine/lineage.py``.

- **Lineage records**: on every publish the averager freezes a
  content-addressed JSON record (the parent base revision, the exact
  ``(hotkey, cid, delta revision, merge weight, wire bytes, verdict,
  score)`` set that entered the merge, and the resulting revision) and
  publishes it under the reserved per-revision ``__lineage__.<revision>``
  id. Records chain on ``parent`` (:func:`walk_chain`) down to the
  genesis record. Records, their digests and ids are the JAX package's:
  either package reads and replays the other's.
- **Replay audit**: :func:`replay_record` re-derives a revision from its
  record through the port's ingest (``engine/ingest.DeltaIngestor``,
  packed submissions kept packed) and ``delta.aggregate_deltas`` (a packed
  contribution folds through the dequantize-scatter kernel on the card)
  and holds it against the published artifact. A tampered record, a
  drifted contribution or a republished base fails loudly
  (:class:`LineageError`).
- **Credit and drift**: :class:`CreditLedger` folds the validator's
  evals into leave-one-out credit per miner; :class:`QualityDriftDetector`
  runs EWMA + CUSUM over each published revision's held-out loss and, on
  a breach, arms the averager's ``AnomalyMonitor`` and freezes the flight
  ring (:class:`LineagePlane`).

A signed role's records go out enveloped (``transport/signed.py``); a
plain reader strips the envelope unverified, as in the JAX package. The
port's metrics sink is slice 7, so a record goes out through the
transport alone. A sub-averager's "agg" records (``engine/hier_average
.py``) replay against the aggregate artifact they name. Registry metrics: ``lineage.records``,
``lineage.publish_failures``, ``lineage.fetch_errors``,
``lineage.tampered``, ``lineage.replays``, ``lineage.replay_failures``,
``lineage.drift_breaches`` counters, ``lineage.loss_ewma`` and
``lineage.cusum`` gauges.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..transport import base as tbase
from ..utils import flight, obs

logger = logging.getLogger(__name__)

Params = Any

LINEAGE_VERSION = 1

# producer-side record cap (transport/base.LINEAGE_MAX_BYTES reads with it)
LINEAGE_MAX_BYTES = tbase.LINEAGE_MAX_BYTES

_MAX_STR = 200
_MAX_CONTRIBS = 4096

# a "base" record's revision is a published base (replay = parent +
# sum w_i d_i); an "agg" record's revision is a partial-aggregate delta
# (replay = sum w_i d_i)
RECORD_KINDS = ("base", "agg")


class LineageError(Exception):
    """A lineage invariant failed loudly (a tampered or torn record, a
    drifted contribution, a parity mismatch)."""


def record_digest(record: dict) -> str:
    """Content address of a record: sha256 over the canonical JSON of
    everything but the id and the wall-clock stamp."""
    body = {k: v for k, v in record.items() if k not in ("record_id", "t")}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=float).encode()
    ).hexdigest()[:16]


def build_record(*, kind: str, node: str, revision: str,
                 parent: str | None, round_no: int,
                 contributions: Sequence[dict],
                 strategy: str = "weighted",
                 replayable: bool = True,
                 weights_kind: str = "merge",
                 loss: float | None = None,
                 parent_loss: float | None = None,
                 artifact: str | None = None,
                 now: float | None = None) -> dict:
    """Freeze one merge's provenance. ``contributions`` carry ``hotkey``
    and ``rev`` (the staged artifact revision the replay re-fetches) plus
    the audit fields (``cid``, ``weight``, ``wire_bytes``, ``verdict``,
    ``score``). ``replayable`` says whether ``weight`` is the exact linear
    mixing weight the merge used."""
    if kind not in RECORD_KINDS:
        raise ValueError(f"kind must be one of {RECORD_KINDS}, got {kind!r}")
    contribs = []
    for c in list(contributions)[:_MAX_CONTRIBS]:
        entry = {"hotkey": str(c["hotkey"])[:_MAX_STR]}
        for key in ("cid", "rev"):
            v = c.get(key)
            if isinstance(v, str) and v:
                entry[key] = v[:_MAX_STR]
        w = c.get("weight")
        entry["weight"] = (round(float(w), 10)
                           if isinstance(w, (int, float))
                           and math.isfinite(float(w)) else None)
        wb = c.get("wire_bytes")
        if isinstance(wb, (int, float)):
            entry["wire_bytes"] = int(wb)
        for key in ("verdict", "tier"):
            v = c.get(key)
            if isinstance(v, str) and v:
                entry[key] = v[:_MAX_STR]
        s = c.get("score")
        if isinstance(s, (int, float)) and math.isfinite(float(s)):
            entry["score"] = round(float(s), 8)
        contribs.append(entry)
    record: dict[str, Any] = {
        "lineage": LINEAGE_VERSION,
        "kind": kind,
        "node": str(node)[:_MAX_STR],
        "revision": str(revision)[:_MAX_STR],
        "parent": (str(parent)[:_MAX_STR] if parent else None),
        "round": int(round_no),
        "strategy": str(strategy)[:_MAX_STR],
        "replayable": bool(replayable),
        "weights_kind": str(weights_kind)[:_MAX_STR],
        "contributions": contribs,
    }
    if artifact:
        # the artifact id an "agg" record's revision was probed from
        record["artifact"] = str(artifact)[:_MAX_STR]
    if loss is not None and math.isfinite(float(loss)):
        record["loss"] = float(loss)
    if parent_loss is not None and math.isfinite(float(parent_loss)):
        record["parent_loss"] = float(parent_loss)
    record["record_id"] = record_digest(record)
    record["t"] = float(now if now is not None else time.time())
    return record


def parse_record(data) -> dict | None:
    """Defensive read of a PEER-CONTROLLED record (bytes or a decoded
    dict): size-capped, versioned, kind and revision validated, every
    contribution re-screened. A normalized dict or None; never raises
    (the content address is :func:`fetch_record`'s check)."""
    if isinstance(data, (bytes, bytearray)):
        if len(data) > LINEAGE_MAX_BYTES:
            return None
        try:
            data = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return None
    if not isinstance(data, dict):
        return None
    v = data.get("lineage")
    if not isinstance(v, (int, float)) or int(v) < 1:
        return None
    if data.get("kind") not in RECORD_KINDS:
        return None
    rev = data.get("revision")
    if not (isinstance(rev, str) and 0 < len(rev) <= _MAX_STR):
        return None
    parent = data.get("parent")
    if parent is not None and not (isinstance(parent, str)
                                   and 0 < len(parent) <= _MAX_STR):
        return None
    out: dict[str, Any] = {
        "lineage": int(v), "kind": data["kind"],
        "node": str(data.get("node", ""))[:_MAX_STR],
        "revision": rev, "parent": parent,
        "round": int(data["round"]) if isinstance(data.get("round"),
                                                  (int, float)) else 0,
        "strategy": str(data.get("strategy", ""))[:_MAX_STR],
        "replayable": bool(data.get("replayable")),
        "weights_kind": str(data.get("weights_kind", ""))[:_MAX_STR],
    }
    art = data.get("artifact")
    if isinstance(art, str) and 0 < len(art) <= _MAX_STR:
        out["artifact"] = art
    contribs = []
    raw = data.get("contributions")
    if not isinstance(raw, list):
        return None
    for c in raw[:_MAX_CONTRIBS]:
        if not (isinstance(c, dict) and isinstance(c.get("hotkey"), str)
                and c["hotkey"]):
            return None   # malformed contributions: the record is torn
        entry: dict[str, Any] = {"hotkey": c["hotkey"][:_MAX_STR]}
        for key in ("cid", "rev", "verdict", "tier"):
            cv = c.get(key)
            if isinstance(cv, str) and cv:
                entry[key] = cv[:_MAX_STR]
        w = c.get("weight")
        entry["weight"] = (float(w) if isinstance(w, (int, float))
                           and math.isfinite(float(w)) else None)
        wb = c.get("wire_bytes")
        if isinstance(wb, (int, float)) and math.isfinite(float(wb)):
            # an int, so the canonical JSON (and the content address)
            # round-trips through parse unchanged
            entry["wire_bytes"] = int(wb)
        sc = c.get("score")
        if isinstance(sc, (int, float)) and math.isfinite(float(sc)):
            entry["score"] = float(sc)
        contribs.append(entry)
    out["contributions"] = contribs
    for key in ("loss", "parent_loss", "t"):
        cv = data.get(key)
        if isinstance(cv, (int, float)) and math.isfinite(float(cv)):
            out[key] = float(cv)
    if data.get("truncated") is True:
        out["truncated"] = True
    rid = data.get("record_id")
    if isinstance(rid, str) and 0 < len(rid) <= 64:
        out["record_id"] = rid
    return out


def publish_record(transport, record: dict) -> bool:
    """Ship one record through the transport (the reserved per-revision
    ``__lineage__`` id). Never raises. An oversized record drops its
    contribution TAIL to fit and is re-stamped."""
    if transport is None:
        return False
    data = json.dumps(record, default=float).encode()
    while len(data) > LINEAGE_MAX_BYTES and record["contributions"]:
        drop = max(1, len(record["contributions"]) // 4)
        record = dict(record,
                      contributions=record["contributions"][:-drop],
                      truncated=True)
        record["record_id"] = record_digest(record)
        data = json.dumps(record, default=float).encode()
    try:
        tbase.publish_lineage(transport, record["revision"], data)
        obs.count("lineage.records")
        logger.info("lineage: published record %s for revision %s "
                    "(%d contributions)", record["record_id"],
                    record["revision"], len(record["contributions"]))
        return True
    except Exception:
        obs.count("lineage.publish_failures")
        logger.warning("lineage: record publish failed for revision %s",
                       record.get("revision"), exc_info=True)
        return False


def fetch_record(transport, revision: str) -> dict | None:
    """One revision's record, validated; None when absent. A torn record,
    one that fails its content address or one filed under another
    revision raises :class:`LineageError`: a tampered record must fail
    loudly, never read as absent."""
    try:
        data = tbase.fetch_lineage_bytes(transport, revision)
    except Exception:
        obs.count("lineage.fetch_errors")
        logger.warning("lineage: record fetch failed for %s", revision,
                       exc_info=True)
        return None
    if data is None:
        return None
    from .. import signing
    try:
        data = signing.strip_envelope(data)
    except ValueError:   # a truncated envelope: torn, as below
        data = b""
    rec = parse_record(data)
    if rec is None:
        obs.count("lineage.tampered")
        raise LineageError(f"lineage record for {revision!r} is present "
                           "but torn or unparseable")
    if rec.get("record_id") != record_digest(rec):
        obs.count("lineage.tampered")
        raise LineageError(
            f"lineage record for {revision!r} fails its content address "
            f"({rec.get('record_id')} != {record_digest(rec)}) — tampered "
            "or corrupt")
    if rec["revision"] != revision:
        obs.count("lineage.tampered")
        raise LineageError(
            f"lineage record under {revision!r} names revision "
            f"{rec['revision']!r} — misfiled or tampered")
    return rec


_MAX_CHAIN = 256


def walk_chain(transport, revision: str) -> list[dict]:
    """Follow ``parent`` links from ``revision`` toward the genesis
    record, newest first, stopping at the first absent record (or after
    256). A tampered link raises."""
    out: list[dict] = []
    seen: set[str] = set()
    rev: str | None = revision
    while rev is not None and len(out) < _MAX_CHAIN and rev not in seen:
        seen.add(rev)
        rec = fetch_record(transport, rev)
        if rec is None:
            break
        out.append(rec)
        rev = rec.get("parent")
    return out


# ---------------------------------------------------------------------------
# Merge-weight resolution (what makes a record replayable)
# ---------------------------------------------------------------------------

def resolve_weights(strategy, weights, m: int
                    ) -> tuple[list[float] | None, str]:
    """``(per-miner linear mixing weights, weights_kind)`` of a strategy's
    ``merge()`` return, through its ``lineage_weights``; a strategy that
    does not mix linearly (per-tensor logits) resolves to ``(None,
    "opaque")`` and its record is attribution-only."""
    fn = getattr(strategy, "lineage_weights", None)
    if fn is None:
        return None, "opaque"
    try:
        w = fn(weights)
    except Exception:
        logger.exception("lineage: strategy weight resolution failed")
        return None, "opaque"
    if w is None:
        return None, "opaque"
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    arr = np.asarray(w, np.float64).reshape(-1)
    if arr.shape[0] != m or not np.all(np.isfinite(arr)):
        return None, "opaque"
    return [float(x) for x in arr], "merge"


def contributions_from_staging(ids: Sequence[str], weights, staged: dict,
                               consensus: dict | None = None,
                               cids: dict | None = None) -> list[dict]:
    """The record's contribution list from a round's accepted ids, the
    resolved (or None) weights and the ingest's per-hotkey staged
    submissions: the merge's inputs, by construction."""
    out = []
    for i, h in enumerate(ids):
        s = staged.get(h)
        entry: dict[str, Any] = {
            "hotkey": h,
            "weight": (weights[i] if weights is not None
                       and i < len(weights) else None),
            "verdict": getattr(s, "reason", None) or "ok",
        }
        rev = getattr(s, "revision", None)
        if rev:
            entry["rev"] = rev
        cid = (cids or {}).get(h) or getattr(s, "cid", None)
        if cid:
            entry["cid"] = cid
        wb = getattr(s, "wire_bytes", None)
        if wb is not None:
            entry["wire_bytes"] = int(wb)
        if consensus and h in consensus:
            entry["score"] = float(consensus[h])
        if getattr(s, "agg_weight", None) is not None:
            entry["tier"] = "agg"
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Quality-drift detection (EWMA + CUSUM over per-revision held-out loss)
# ---------------------------------------------------------------------------

class QualityDriftDetector:
    """One-sided CUSUM over the deviation of each published revision's
    held-out loss from its own EWMA: ``cusum += max(0, loss - ewma -
    slack)``, a breach when it exceeds ``threshold`` (then it re-arms at
    0). The EWMA absorbs the slow convergence trend, the slack the eval
    noise; a non-finite loss breaches at once."""

    def __init__(self, *, alpha: float = 0.25, slack: float = 0.02,
                 threshold: float = 0.25, warmup: int = 2):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.alpha = alpha
        self.slack = slack
        self.threshold = threshold
        self.warmup = max(0, int(warmup))
        self.ewma: float | None = None
        self.cusum = 0.0
        self.observed = 0
        self.breaches = 0

    def update(self, loss: float) -> dict | None:
        """Fold one published revision's held-out loss; a breach dict
        (its reason and the numbers that decided it) or None."""
        loss = float(loss)
        self.observed += 1
        if not math.isfinite(loss):
            self.breaches += 1
            return {"reason": "nonfinite_loss", "loss": loss,
                    "observed": self.observed}
        if self.ewma is None:
            self.ewma = loss
            return None
        dev = loss - self.ewma - self.slack
        self.cusum = max(0.0, self.cusum + dev)
        # the EWMA moves AFTER the deviation is measured: a step
        # regression cannot pull its own reference up at once
        self.ewma += self.alpha * (loss - self.ewma)
        obs.gauge("lineage.loss_ewma", self.ewma)
        obs.gauge("lineage.cusum", self.cusum)
        if self.observed <= self.warmup:
            return None
        if self.cusum > self.threshold:
            self.breaches += 1
            fired = {"reason": "quality_drift", "loss": loss,
                     "ewma": round(self.ewma, 6),
                     "cusum": round(self.cusum, 6),
                     "threshold": self.threshold,
                     "observed": self.observed}
            self.cusum = 0.0   # re-arm: a persisting drift fires again
            return fired
        return None


# ---------------------------------------------------------------------------
# Credit attribution (leave-one-out improvement per revision)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The plane (what the averager loop holds)
# ---------------------------------------------------------------------------

class LineagePlane:
    """Record publication, drift detection and forensics arming for one
    merge-publishing role. Every entry point is isolated: a lineage
    failure degrades provenance, never the round."""

    def __init__(self, transport, *, node: str = "averager", anomaly=None):
        self.transport = transport
        self.node = node
        self.drift = QualityDriftDetector()
        self.anomaly = anomaly
        self.records = 0
        self.drift_breaches = 0
        self.last_record: dict | None = None

    def on_publish(self, *, kind: str, revision: str, parent: str | None,
                   round_no: int, contributions: Sequence[dict],
                   strategy: str = "weighted", replayable: bool = True,
                   weights_kind: str = "merge",
                   loss: float | None = None,
                   parent_loss: float | None = None,
                   artifact: str | None = None) -> dict | None:
        """Freeze and publish the record of one landed merge, feed the
        drift detector, arm the forensics on a breach. The record, or None
        on a total failure; never raises."""
        try:
            record = build_record(
                kind=kind, node=self.node, revision=revision,
                parent=parent, round_no=round_no,
                contributions=contributions, strategy=strategy,
                replayable=replayable, weights_kind=weights_kind,
                loss=loss, parent_loss=parent_loss, artifact=artifact)
            publish_record(self.transport, record)
            self.records += 1
            self.last_record = record
            flight.record("lineage.record", revision=revision,
                          parent=parent, record_id=record["record_id"],
                          miners=float(len(record["contributions"])),
                          round=float(round_no))
            if loss is not None and kind == "base":
                self._observe_quality(revision, loss)
            return record
        except Exception:
            logger.exception("lineage: on_publish failed for revision %s",
                             revision)
            return None

    def _observe_quality(self, revision: str, loss: float) -> None:
        breach = self.drift.update(loss)
        if breach is None:
            return
        self.drift_breaches += 1
        obs.count("lineage.drift_breaches")
        flight.record("lineage.drift", revision=revision, **breach)
        logger.warning("lineage: merged-model quality drift on %s: %s",
                       revision, breach)
        if self.anomaly is not None:
            try:
                self.anomaly.trigger_external("lineage_drift",
                                              revision=revision, **breach)
            except Exception:
                logger.exception("lineage: anomaly arm failed")
        # a forensic moment: freeze the ring while the revisions and
        # weights that led into the drift are still in it
        flight.freeze_and_publish("lineage_drift")


# ---------------------------------------------------------------------------
# Replay audit
# ---------------------------------------------------------------------------

# a replayed base must equal the published one within this
REPLAY_TOL = 1e-6


@dataclasses.dataclass
class ReplayResult:
    """One replay audit's verdict."""
    revision: str
    ok: bool
    reason: str                      # "parity" when ok
    max_abs_diff: float = float("nan")
    contributions: int = 0


def _state(tree, device) -> dict[str, torch.Tensor]:
    """A nested wire tree or a state dict as tensors on ``device``, keyed
    by state-dict key."""
    from .. import delta as delta_lib
    out = {}
    for k, v in delta_lib.flatten_tree(tree).items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        out[k] = t.detach().to(device)
    return out


def _max_abs_diff(a: dict, b: dict) -> float:
    if set(a) != set(b):
        raise LineageError(f"replay structure mismatch: "
                           f"{sorted(set(a) ^ set(b))[:4]}")
    worst = 0.0
    for k, x in a.items():
        y = b[k]
        if tuple(x.shape) != tuple(y.shape):
            raise LineageError(f"replay shape mismatch at {k}: "
                               f"{tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, float((x.double() - y.to(x.device).double())
                                     .abs().max()))
    return worst


def replay_record(transport, record: dict, template, *,
                  parent: Params | None = None,
                  device="cuda") -> ReplayResult:
    """Re-derive ``record``'s revision from its contributions through the
    port's ingest and merge, and hold it against the published artifact.

    - integrity: the record must match its content address;
    - contributions: each ``(hotkey, rev)`` is staged again through
      :class:`~.ingest.DeltaIngestor` (the same decode and screens, packed
      submissions kept packed) and must still be the exact artifact the
      record names;
    - merge: ``delta.aggregate_deltas`` folds them at the recorded
      weights into one f32 accumulator on ``device`` (``"cuda"`` unless
      the caller asks for the CPU; a packed contribution launches the
      dequantize-scatter kernel there); a "base" record adds the fold to
      ``parent``, an "agg" record (a sub-averager's partial aggregate)
      IS the fold;
    - parity: max |replayed - published| <= :data:`REPLAY_TOL`, against
      the transport's current artifact, which must still carry the
      recorded revision: the base, or the aggregate under the record's
      ``artifact`` id (decoded through the ingest, as the root decodes
      it).

    ``template`` is the wire-layout template of the ingest; ``parent``
    (a base record's) is a nested tree or a state dict. Raises
    :class:`LineageError` on any audit failure."""
    from .. import delta as delta_lib
    from ..models.gpt2 import resolve_device
    from .ingest import DeltaIngestor

    dev = resolve_device(device)
    obs.count("lineage.replays")
    try:
        rec = parse_record(record)
        if rec is None:
            raise LineageError("record is torn or unparseable")
        if rec.get("record_id") != record_digest(rec):
            obs.count("lineage.tampered")
            raise LineageError(
                f"record {rec.get('record_id')} fails its content "
                f"address ({record_digest(rec)}) — tampered or corrupt")
        if not rec["replayable"] or rec["weights_kind"] != "merge":
            raise LineageError(
                f"record for {rec['revision']} is not replayable "
                f"(strategy {rec['strategy']!r}, weights "
                f"{rec['weights_kind']!r}) — attribution only")
        contribs = rec["contributions"]
        if not contribs:
            raise LineageError("record has no contributions to replay "
                               "(genesis records are roots, not merges)")
        problems: list[str] = []
        for c in contribs:
            if not c.get("rev"):
                problems.append(f"{c['hotkey']}: no recorded revision")
            if c.get("weight") is None:
                problems.append(f"{c['hotkey']}: no recorded weight")
        if problems:
            raise LineageError("record is incomplete: "
                               + "; ".join(problems))

        ing = DeltaIngestor(transport, template, workers=1,
                            max_delta_abs=None, stale_deltas="accept",
                            span_prefix="replay", densify=False)
        try:
            staged = {s.hotkey: s
                      for s in ing.stage([c["hotkey"] for c in contribs])}
        finally:
            ing.close()
        deltas, weights = [], []
        for c in contribs:
            s = staged.get(c["hotkey"])
            if s is None or s.delta is None:
                problems.append(
                    f"{c['hotkey']}: contribution not stageable "
                    f"({getattr(s, 'reason', 'missing')})")
                continue
            if s.revision != c["rev"]:
                problems.append(
                    f"{c['hotkey']}: artifact drifted "
                    f"({s.revision} != recorded {c['rev']})")
                continue
            deltas.append(s.delta)
            weights.append(float(c["weight"]))
        if problems:
            raise LineageError("contribution audit failed: "
                               + "; ".join(problems))

        if rec["kind"] == "base":
            if parent is None:
                raise LineageError(
                    "replaying a base record needs the parent base params "
                    f"(revision {rec['parent']})")
            base = _state(parent, dev)
            agg = delta_lib.aggregate_deltas(base, deltas,
                                             np.asarray(weights, np.float32))
            derived = {k: b + agg[k].to(b.dtype) for k, b in base.items()}
            current = transport.base_revision()
            if current != rec["revision"]:
                raise LineageError(
                    f"published base is {current}, record names "
                    f"{rec['revision']} — republished or superseded")
            got = transport.fetch_base(template)
            if got is None:
                raise LineageError("published base unreadable")
            target = got[0]
        else:
            derived = delta_lib.aggregate_deltas(
                _state(template, dev), deltas,
                np.asarray(weights, np.float32))
            artifact_id = rec.get("artifact") or rec["node"]
            current = transport.delta_revision(artifact_id)
            if current != rec["revision"]:
                raise LineageError(
                    f"aggregate {artifact_id} is {current}, record names "
                    f"{rec['revision']} — superseded")
            ing = DeltaIngestor(transport, template, workers=1,
                                max_delta_abs=None, stale_deltas="accept",
                                span_prefix="replay")
            try:
                got = ing.stage([artifact_id])[0]
            finally:
                ing.close()
            if got.delta is None:
                raise LineageError(f"aggregate {artifact_id} unreadable "
                                   f"({got.reason})")
            target = got.delta
        diff = _max_abs_diff(derived, _state(target, dev))
        if not (diff <= REPLAY_TOL):
            raise LineageError(
                f"replay parity FAILED for {rec['revision']}: "
                f"max |replayed - published| = {diff:.3e} > "
                f"{REPLAY_TOL:g} — "
                "the published artifact is not the recorded merge")
        return ReplayResult(revision=rec["revision"], ok=True,
                            reason="parity", max_abs_diff=diff,
                            contributions=len(contribs))
    except LineageError:
        obs.count("lineage.replay_failures")
        raise
