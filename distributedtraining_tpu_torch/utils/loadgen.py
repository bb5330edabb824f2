"""Load generation — the port of the JAX package's ``utils/loadgen.py``.

Two halves:

- **The submission flood.** :class:`LoadGenerator` mass-publishes
  plausible (or deliberately hostile) weight deltas from many
  identities, so a validator or averager under test exercises its whole
  download -> screen -> score path at scale. The poison modes map one to
  one onto the admission screens: "nan" (non-finite), "shape" (shapes
  match), "huge" (the max-abs cap), "garbage" (msgpack structure) and
  "forged" (a well-formed delta signed by the WRONG key: the
  authenticity screen of transport/signed.py). Trees are the port's
  nested dicts; the draws visit their leaves in sorted-key order, as
  ``jax.tree_util`` does, so a seeded ``rng`` gives the JAX package's
  arrays.
- **The open-loop serving load.** :class:`OpenLoopSpec`,
  :func:`sample_arrivals` and the runners :func:`run_open_loop`,
  :func:`run_open_loop_routed` (N engines behind the router policy) and
  :func:`run_open_loop_disagg` (prefill engines handing off to decode
  engines). They count time in VIRTUAL milliseconds, one ``step_ms`` an
  engine step, so the same spec over engines that make the same
  scheduling decisions gives equal load points in either package.
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping
from typing import Any

import numpy as np

from . import reqtrace
from .identity import Identity

logger = logging.getLogger(__name__)

POISON_MODES = ("nan", "shape", "huge", "garbage", "forged")


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keys visited in sorted
    order (``jax.tree_util``'s order for dicts)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _first_leaf_path(tree) -> list:
    path = []
    while isinstance(tree, Mapping):
        k = sorted(tree)[0]
        path.append(k)
        tree = tree[k]
    return path


def benign_delta(template: Any, rng: np.random.Generator,
                 scale: float = 1e-3):
    """A plausible random delta shaped like ``template`` (f32 leaves)."""
    return _tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale)
        .astype(np.float32), template)


def poisoned_delta(template: Any, mode: str, rng: np.random.Generator,
                   scale: float = 1e-3):
    """A hostile delta for ``mode`` in {"nan", "shape", "huge"}, each
    caught by exactly one admission screen, in the first leaf (sorted
    order). The byte-level modes ("garbage", "forged") need a transport
    and live on :class:`LoadGenerator`."""
    d = benign_delta(template, rng, scale)
    *parents, key = _first_leaf_path(d)
    node = d
    for p in parents:
        node = node[p]
    leaf = node[key]
    if mode == "nan":
        leaf = leaf.copy()
        leaf.flat[0] = np.nan
    elif mode == "shape":
        leaf = np.zeros(np.asarray(leaf).shape + (2,), np.float32)
    elif mode == "huge":
        leaf = leaf + np.float32(1e9)
    else:
        raise ValueError(f"unknown tree-level poison mode {mode!r}")
    node[key] = leaf
    return d


@dataclasses.dataclass
class LoadReport:
    published: int = 0
    poisoned: int = 0
    by_mode: dict = dataclasses.field(default_factory=dict)


class LoadGenerator:
    """Publishes synthetic deltas for ``n_miners`` identities."""

    def __init__(self, transport, template_params: Any, *,
                 n_miners: int = 10, scale: float = 1e-3,
                 poison_fraction: float = 0.0, seed: int = 0,
                 sign: bool = False):
        self.transport = transport
        self.template = template_params
        self.identities = [Identity.generate() for _ in range(n_miners)]
        self.scale = scale
        self.poison_fraction = poison_fraction
        self.rng = np.random.default_rng(seed)
        self.report = LoadReport()
        # sign=True: each identity signs its own artifacts, so numeric
        # poisons pass the authenticity screen and must be caught by the
        # value screens. "forged" means something only on a signed fleet
        # (an unsigned reader strips envelopes unverified)
        self.sign = sign
        self.poison_modes = POISON_MODES if sign else tuple(
            m for m in POISON_MODES if m != "forged")

    def _benign_delta(self):
        return benign_delta(self.template, self.rng, self.scale)

    def _poisoned_delta(self, mode: str):
        return poisoned_delta(self.template, mode, self.rng, self.scale)

    def publish_round(self) -> LoadReport:
        """One wave: every identity publishes once; a ``poison_fraction``
        of them publish a hostile artifact instead."""
        n_poison = int(round(self.poison_fraction * len(self.identities)))
        for i, ident in enumerate(self.identities):
            if i < n_poison:
                mode = self.poison_modes[i % len(self.poison_modes)]
                self.report.poisoned += 1
                self.report.by_mode[mode] = self.report.by_mode.get(mode, 0) + 1
                if mode == "garbage":
                    self._publish_garbage(ident)
                    continue
                if mode == "forged":
                    self._publish_forged(ident)
                    continue
                delta = self._poisoned_delta(mode)
            else:
                delta = self._benign_delta()
            self._publish(ident, delta)
            self.report.published += 1
        return self.report

    def _publish(self, ident: Identity, tree) -> None:
        publish_raw = getattr(self.transport, "publish_raw", None)
        if self.sign and publish_raw is not None:
            from .. import serialization as ser
            from .. import signing
            env = signing.wrap(ser.to_msgpack(tree), ident,
                               signing.delta_context(ident.hotkey))
            publish_raw(ident.hotkey, env)
        else:
            self.transport.publish_delta(ident.hotkey, tree)

    def _publish_garbage(self, ident: Identity) -> None:
        """Raw malformed bytes, past the serializer (a hostile miner is
        not obliged to run this code)."""
        raw = bytes(self.rng.integers(0, 256, 256, dtype=np.uint8))
        publish_raw = getattr(self.transport, "publish_raw", None)
        if publish_raw is not None:
            publish_raw(ident.hotkey, raw)
        else:  # no raw path: a wrong-structure tree instead
            self.transport.publish_delta(ident.hotkey,
                                         {"junk": np.zeros(7, np.float32)})
        self.report.published += 1

    def _publish_forged(self, ident: Identity) -> None:
        """A plausible delta signed by an attacker's key, published under
        the victim's hotkey: only the authenticity screen catches it."""
        from .. import serialization as ser
        from .. import signing
        attacker = Identity.generate()
        payload = ser.to_msgpack(self._benign_delta())
        env = signing.wrap(payload, attacker,
                           signing.delta_context(ident.hotkey))
        publish_raw = getattr(self.transport, "publish_raw", None)
        if publish_raw is not None:
            publish_raw(ident.hotkey, env)
        else:  # no raw path: an unsigned publish is the closest forgery
            self.transport.publish_delta(ident.hotkey, self._benign_delta())
        self.report.published += 1

    def hotkeys(self) -> list[str]:
        return [i.hotkey for i in self.identities]

    def register_pubkeys(self, address_store) -> None:
        """Register every identity's public key (what honest miners do at
        boot; it makes signatures mandatory for these hotkeys)."""
        for ident in self.identities:
            address_store.store_pubkey(ident.hotkey, ident.public_bytes)


# ---------------------------------------------------------------------------
# Open-loop serving load
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpenLoopSpec:
    """One load point against the serving plane.

    OPEN loop: arrivals follow a seeded Poisson process that does NOT
    wait for completions — a closed-loop generator (submit, wait,
    repeat) self-throttles when the server saturates and therefore
    HIDES queueing collapse; the open-loop curve is the one where p99
    blows up when offered load crosses capacity (the Gemma-on-TPU
    serving comparison in PAPERS.md makes exactly this point). Prompt
    lengths are heavy-tailed (bounded Pareto), because uniform prompts
    understate paged-KV pressure.

    Latency is accounted in VIRTUAL milliseconds: every
    ``GenerationEngine.step`` advances the harness clock by ``step_ms``
    regardless of host speed, so the curve measures the SCHEDULER —
    admission, continuous batching, page allocation, preemption,
    queueing — deterministically (same seed, same spec => byte-equal
    load points), not the CI host's CPU. The real decode path still
    runs under it (real prefill and decode forwards, real paged KV), which
    is what makes the scheduler's decisions real.
    """
    rate_rps: float
    duration_s: float = 8.0
    seed: int = 0
    min_prompt_tokens: int = 4
    max_prompt_tokens: int = 40
    tail_alpha: float = 1.6         # Pareto shape; smaller = heavier tail
    max_new_tokens: int = 16
    vocab: int = 128
    step_ms: float = 4.0            # virtual service time per engine step
    max_steps: int = 50_000         # collapse bound: stop, count unfinished

    def __post_init__(self):
        if self.rate_rps <= 0 or self.duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be > 0")
        if not 1 <= self.min_prompt_tokens <= self.max_prompt_tokens:
            raise ValueError("need 1 <= min_prompt <= max_prompt")
        if self.tail_alpha <= 0 or self.step_ms <= 0:
            raise ValueError("tail_alpha and step_ms must be > 0")


def sample_arrivals(spec: OpenLoopSpec) -> list[tuple[float, list[int]]]:
    """The seeded arrival schedule: (arrival_time_s, prompt_tokens)
    pairs over ``duration_s``. Exponential inter-arrivals at
    ``rate_rps``; lengths are bounded Pareto over
    [min_prompt_tokens, max_prompt_tokens]."""
    rng = np.random.default_rng(spec.seed)
    out: list[tuple[float, list[int]]] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / spec.rate_rps))
        if t >= spec.duration_s:
            return out
        raw = spec.min_prompt_tokens * float(
            (1.0 - rng.random()) ** (-1.0 / spec.tail_alpha))
        n = int(min(max(raw, spec.min_prompt_tokens),
                    spec.max_prompt_tokens))
        prompt = rng.integers(1, spec.vocab, n).tolist()
        out.append((t, [int(x) for x in prompt]))


def run_open_loop(engine, spec: OpenLoopSpec, *,
                  prefill_busy_steps: int = 0) -> dict:
    """Drive one load point through a live GenerationEngine; returns the
    load-point record.

    The loop submits every arrival whose (virtual) time has come —
    whether or not the engine has capacity — then takes one scheduler
    step and advances the virtual clock by ``step_ms``; when the engine
    goes idle before the next arrival, the clock jumps to it. TTFT is
    arrival -> first generated token, TPOT the gap between a request's
    consecutive tokens, both in virtual ms; ``unfinished`` counts
    requests still incomplete when the ``max_steps`` collapse bound
    stops the run — a nonzero value IS the queueing-collapse signal,
    alongside the exploding p99.

    ``prefill_busy_steps`` is the virtual-clock prefill cost model: each
    completed prefill charges that many extra BUSY ticks (clock advances,
    the engine does not step), so a long-prompt admission visibly stalls
    every in-flight decode on the same worker — the head-of-line effect
    disaggregated serving exists to remove. The default 0 preserves the
    legacy uniform-tick curve byte-for-byte."""
    from .obs import percentile

    if prefill_busy_steps < 0:
        raise ValueError("prefill_busy_steps must be >= 0")
    arrivals = sample_arrivals(spec)
    now = 0.0
    i = 0
    steps = 0
    debt = 0                        # busy ticks owed for finished prefills
    last_prefills = int(getattr(engine, "prefills_done", 0))
    tracked: list[dict] = []        # {req, arrival_s, seen, last_emit}
    ttft_ms: list[float] = []
    tpot_ms: list[float] = []

    def _submit_due() -> None:
        nonlocal i
        while i < len(arrivals) and arrivals[i][0] <= now:
            t_arr, prompt = arrivals[i]
            seq = i
            i += 1
            # deterministic content-addressable identity (arrival index
            # as the sequence salt): the same spec mints the same ids,
            # so a frozen tail exemplar can be named in a test
            req = engine.submit(
                prompt, spec.max_new_tokens,
                request_id=reqtrace.mint_request_id(
                    prompt, max_new_tokens=spec.max_new_tokens, seq=seq))
            tracked.append({"req": req, "arrival_s": t_arr,
                            "seen": 0, "last_emit": None})

    def _account() -> None:
        for rec in tracked:
            n = len(rec["req"].tokens)
            if n <= rec["seen"]:
                continue
            # a speculative step commits up to K+1 tokens in one tick;
            # spread their emission times evenly across the step so tpot
            # reflects the per-token pace, not a burst artifact. burst=1
            # (plain decode) reduces to the old single-emit bookkeeping.
            burst = n - rec["seen"]
            pace = spec.step_ms / 1e3 / burst
            for j in range(burst):
                t_emit = now - (burst - 1 - j) * pace
                if rec["last_emit"] is None:
                    ttft_ms.append((t_emit - rec["arrival_s"]) * 1e3)
                else:
                    tpot_ms.append((t_emit - rec["last_emit"]) * 1e3)
                rec["last_emit"] = t_emit
            rec["seen"] = n

    while (i < len(arrivals) or not engine.idle or debt > 0) \
            and steps < spec.max_steps:
        if engine.idle and debt == 0 and i < len(arrivals):
            now = max(now, arrivals[i][0])   # park until the next arrival
            _submit_due()
            continue
        _submit_due()
        if debt > 0:
            debt -= 1                       # engine busy with prefill math
        else:
            engine.step()
            done = int(getattr(engine, "prefills_done", 0))
            debt += (done - last_prefills) * prefill_busy_steps
            last_prefills = done
        steps += 1
        now += spec.step_ms / 1e3
        _account()

    completed = sum(1 for r in tracked if r["req"].done_evt.is_set())
    unfinished = len(tracked) - completed
    # a live run seals its trace reservoir on the way out so the tail
    # exemplars of even a sub-window run are frozen into the flight
    # recorder (scripts/request_report.py reads them from there)
    book = getattr(engine, "trace", None)
    pm_ref = book.seal_window() if book is not None else None

    def _pcts(vals: list[float]) -> dict:
        s = sorted(vals)
        return {"p50": round(percentile(s, 50.0), 3),
                "p95": round(percentile(s, 95.0), 3),
                "p99": round(percentile(s, 99.0), 3)}

    return {
        "rate_rps": spec.rate_rps,
        "duration_s": spec.duration_s,
        "offered": len(arrivals),
        "completed": completed,
        "unfinished": unfinished,
        "steps": steps,
        "virtual_s": round(now, 4),
        "trace_exemplars": (book.exemplars_frozen
                            if book is not None else 0),
        "trace_pm_ref": pm_ref,
        "tokens": int(sum(r["seen"] for r in tracked)),
        "ttft_ms": _pcts(ttft_ms) if ttft_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
        "tpot_ms": _pcts(tpot_ms) if tpot_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
    }


def run_open_loop_routed(engines, spec: OpenLoopSpec, *,
                         max_backend_queue: int = 6,
                         prefill_busy_steps: int = 0) -> dict:
    """One load point through N engines behind the router policy —
    the same virtual-clock discipline as :func:`run_open_loop` (every
    tick steps ALL engines; one tick is ``step_ms``), with the real
    :class:`~..engine.router.RouterPolicy` making the per-arrival
    spread/shed decision from each engine's live queue/active state.

    Shed arrivals are counted (``shed``) and EXCLUDED from the latency
    percentiles: the admission controller's contract is that admitted
    requests stay off the collapse curve, and a 429'd open-loop caller
    never waited in any queue. The offered/shed split plus the
    admitted-only p99 is the curve to hold against one server's.

    ``prefill_busy_steps`` charges the :func:`run_open_loop` prefill
    cost model per engine (default 0 = legacy uniform ticks)."""
    from ..engine.router import BackendState, RouterPolicy
    from .obs import percentile

    if prefill_busy_steps < 0:
        raise ValueError("prefill_busy_steps must be >= 0")
    policy = RouterPolicy(max_queue_depth=max_backend_queue)
    arrivals = sample_arrivals(spec)
    now = 0.0
    i = 0
    steps = 0
    shed = 0
    debt = [0] * len(engines)
    last_prefills = [int(getattr(e, "prefills_done", 0)) for e in engines]
    tracked: list[dict] = []
    ttft_ms: list[float] = []
    tpot_ms: list[float] = []
    states = [BackendState(url=f"engine://{n}", healthy=True)
              for n in range(len(engines))]

    def _submit_due() -> None:
        nonlocal i, shed
        while i < len(arrivals) and arrivals[i][0] <= now:
            t_arr, prompt = arrivals[i]
            i += 1
            for n, e in enumerate(engines):
                states[n].queue_depth = e.queue_depth
                states[n].active = e.active_count
            b = policy.choose(states)
            if b is None:
                shed += 1
                continue
            eng = engines[int(b.url.rsplit("/", 1)[-1])]
            req = eng.submit(
                prompt, spec.max_new_tokens,
                request_id=reqtrace.mint_request_id(
                    prompt, max_new_tokens=spec.max_new_tokens,
                    seq=i - 1))
            tracked.append({"req": req, "arrival_s": t_arr,
                            "seen": 0, "last_emit": None})

    def _account() -> None:
        for rec in tracked:
            n = len(rec["req"].tokens)
            if n <= rec["seen"]:
                continue
            # a speculative step commits up to K+1 tokens in one tick;
            # spread their emission times evenly across the step so tpot
            # reflects the per-token pace, not a burst artifact. burst=1
            # (plain decode) reduces to the old single-emit bookkeeping.
            burst = n - rec["seen"]
            pace = spec.step_ms / 1e3 / burst
            for j in range(burst):
                t_emit = now - (burst - 1 - j) * pace
                if rec["last_emit"] is None:
                    ttft_ms.append((t_emit - rec["arrival_s"]) * 1e3)
                else:
                    tpot_ms.append((t_emit - rec["last_emit"]) * 1e3)
                rec["last_emit"] = t_emit
            rec["seen"] = n

    while (i < len(arrivals) or any(debt)
           or not all(e.idle for e in engines)) and steps < spec.max_steps:
        if all(e.idle for e in engines) and not any(debt) \
                and i < len(arrivals):
            now = max(now, arrivals[i][0])
            _submit_due()
            continue
        _submit_due()
        for n, e in enumerate(engines):
            if debt[n] > 0:
                debt[n] -= 1            # busy with prefill math this tick
            elif not e.idle:
                e.step()
                done = int(getattr(e, "prefills_done", 0))
                debt[n] += (done - last_prefills[n]) * prefill_busy_steps
                last_prefills[n] = done
        steps += 1
        now += spec.step_ms / 1e3
        _account()

    completed = sum(1 for r in tracked if r["req"].done_evt.is_set())
    unfinished = len(tracked) - completed

    def _pcts(vals: list[float]) -> dict:
        s = sorted(vals)
        return {"p50": round(percentile(s, 50.0), 3),
                "p95": round(percentile(s, 95.0), 3),
                "p99": round(percentile(s, 99.0), 3)}

    return {
        "rate_rps": spec.rate_rps,
        "duration_s": spec.duration_s,
        "router": True,
        "servers": len(engines),
        "offered": len(arrivals),
        "routed": len(tracked),
        "shed": shed,
        "completed": completed,
        "unfinished": unfinished,
        "steps": steps,
        "virtual_s": round(now, 4),
        "tokens": int(sum(r["seen"] for r in tracked)),
        "ttft_ms": _pcts(ttft_ms) if ttft_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
        "tpot_ms": _pcts(tpot_ms) if tpot_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
    }


def run_open_loop_disagg(prefill_engines, decode_engines,
                         spec: OpenLoopSpec, *,
                         prefill_busy_steps: int = 0,
                         max_backend_queue: int = 6) -> dict:
    """One load point through a DISAGGREGATED fleet: arrivals land on a
    prefill-phase engine (chosen by the real router policy), which runs
    the bucketed prefill, emits the first token, and exports the KV
    pages as a content-addressed manifest; finished prefill legs are
    handed off to the least-loaded decode-phase engine carrying the
    ``kv_ref`` + first token, where the pages are adopted and decode
    streams under the paged-attention kernel. Same virtual-clock
    discipline as :func:`run_open_loop_routed`; ``prefill_busy_steps``
    charges the prefill cost model on EVERY engine (decode engines pay
    it only when a degraded transfer forces a local re-prefill), so the
    disaggregated and unified curves are comparable within one card.

    TTFT is arrival -> the prefill leg's first token; the decode leg
    re-emits that token verbatim, so accounting starts the decode leg
    at ``seen=1`` — no token is counted twice. ``handoffs`` counts
    prefill legs that carried a kv_ref; a failed export falls back to a
    plain decode-side submit (local prefill), keeping the harness
    lossless under the same no-flag-day contract as the router."""
    from ..engine.router import BackendState, RouterPolicy
    from .obs import percentile

    if prefill_busy_steps < 0:
        raise ValueError("prefill_busy_steps must be >= 0")
    policy = RouterPolicy(max_queue_depth=max_backend_queue)
    arrivals = sample_arrivals(spec)
    engines = list(prefill_engines) + list(decode_engines)
    now = 0.0
    i = 0
    steps = 0
    shed = 0
    handoffs = 0
    debt = [0] * len(engines)
    last_prefills = [int(getattr(e, "prefills_done", 0)) for e in engines]
    pending: list[dict] = []        # prefill legs in flight
    tracked: list[dict] = []        # decode legs (latency accounting)
    ttft_ms: list[float] = []
    tpot_ms: list[float] = []
    pre_states = [BackendState(url=f"engine://{n}", healthy=True,
                               phase="prefill")
                  for n in range(len(prefill_engines))]
    # engine counters are lifetime-cumulative; the load point reports
    # THIS run's deltas so warm engines can serve several rate points
    adopted0 = sum(int(getattr(e, "kv_adopted", 0))
                   for e in decode_engines)
    reprefill0 = sum(int(getattr(e, "kv_reprefills", 0))
                     for e in decode_engines)

    def _submit_due() -> None:
        nonlocal i, shed
        while i < len(arrivals) and arrivals[i][0] <= now:
            t_arr, prompt = arrivals[i]
            seq = i
            i += 1
            for n, e in enumerate(prefill_engines):
                pre_states[n].queue_depth = e.queue_depth
                pre_states[n].active = e.active_count
            b = policy.choose(pre_states)
            if b is None:
                shed += 1
                continue
            pe = prefill_engines[int(b.url.rsplit("/", 1)[-1])]
            rid = reqtrace.mint_request_id(
                prompt, max_new_tokens=spec.max_new_tokens, seq=seq)
            req = pe.submit(prompt, spec.max_new_tokens, request_id=rid)
            pending.append({"req": req, "arrival_s": t_arr,
                            "rid": rid, "prompt": prompt})

    def _handoff() -> None:
        nonlocal handoffs
        for rec in list(pending):
            req = rec["req"]
            if not req.done_evt.is_set():
                continue
            pending.remove(rec)
            ttft_ms.append((now - rec["arrival_s"]) * 1e3)
            de = min(decode_engines,
                     key=lambda e: e.queue_depth + e.active_count)
            if req.kv_ref is not None and req.tokens:
                handoffs += 1
                r2 = de.submit(rec["prompt"], spec.max_new_tokens,
                               request_id=rec["rid"], kv_ref=req.kv_ref,
                               first_token=int(req.tokens[0]))
            else:  # export failed: lossless fallback, local prefill
                r2 = de.submit(rec["prompt"], spec.max_new_tokens,
                               request_id=rec["rid"])
            tracked.append({"req": r2, "arrival_s": rec["arrival_s"],
                            "seen": 1, "last_emit": now})

    def _account() -> None:
        for rec in tracked:
            n = len(rec["req"].tokens)
            if n <= rec["seen"]:
                continue
            burst = n - rec["seen"]
            pace = spec.step_ms / 1e3 / burst
            for j in range(burst):
                t_emit = now - (burst - 1 - j) * pace
                tpot_ms.append((t_emit - rec["last_emit"]) * 1e3)
                rec["last_emit"] = t_emit
            rec["seen"] = n

    while (i < len(arrivals) or pending or any(debt)
           or not all(e.idle for e in engines)) and steps < spec.max_steps:
        if all(e.idle for e in engines) and not pending \
                and not any(debt) and i < len(arrivals):
            now = max(now, arrivals[i][0])
            _submit_due()
            continue
        _submit_due()
        for n, e in enumerate(engines):
            if debt[n] > 0:
                debt[n] -= 1            # busy with prefill math this tick
            elif not e.idle:
                e.step()
                done = int(getattr(e, "prefills_done", 0))
                debt[n] += (done - last_prefills[n]) * prefill_busy_steps
                last_prefills[n] = done
        steps += 1
        now += spec.step_ms / 1e3
        _handoff()
        _account()

    completed = sum(1 for r in tracked if r["req"].done_evt.is_set())
    unfinished = len(pending) + len(tracked) - completed

    def _pcts(vals: list[float]) -> dict:
        s = sorted(vals)
        return {"p50": round(percentile(s, 50.0), 3),
                "p95": round(percentile(s, 95.0), 3),
                "p99": round(percentile(s, 99.0), 3)}

    return {
        "rate_rps": spec.rate_rps,
        "duration_s": spec.duration_s,
        "disaggregated": True,
        "prefill_servers": len(prefill_engines),
        "decode_servers": len(decode_engines),
        "offered": len(arrivals),
        "routed": len(tracked) + len(pending),
        "shed": shed,
        "handoffs": handoffs,
        "kv_adopted": int(sum(getattr(e, "kv_adopted", 0)
                              for e in decode_engines)) - adopted0,
        "kv_reprefills": int(sum(getattr(e, "kv_reprefills", 0)
                                 for e in decode_engines)) - reprefill0,
        "completed": completed,
        "unfinished": unfinished,
        "steps": steps,
        "virtual_s": round(now, 4),
        "tokens": int(sum(r["seen"] for r in tracked)),
        "ttft_ms": _pcts(ttft_ms) if ttft_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
        "tpot_ms": _pcts(tpot_ms) if tpot_ms else
        {"p50": float("nan"), "p95": float("nan"), "p99": float("nan")},
    }
