"""Device performance observatory: per-program cost attribution,
execution histograms and a roofline model — the port of the JAX
package's ``utils/devprof.py``, with its names and records.

Every hot path registers its device programs here:

- :func:`wrap` wraps a callable under a **closed program vocabulary**
  (:data:`PROGRAMS`, the JAX package's 24 names: an unknown name raises
  at the producer). Per (program, bucket) the observatory records the
  FLOPs and bytes of one call (the cost probe, below), the first call's
  wall time as ``compile_ms`` (kept out of the histogram, as JAX keeps
  its trace-and-compile dispatch out), and an execution-time histogram.
  ``bucket=`` is a static value or a callable ``(args, kwargs) ->
  value`` (``engine/train._devprof_batch_bucket``'s ``"{B}x{T}"``).
- :func:`call` runs one call as a program, for a site that knows its
  bucket only inside the call (the serving engine's steps).
- :func:`track` is the host-phase sibling (``host: true``, no probe).
- a **roofline model** (:func:`roofline_for`): dense BF16 FLOP/s and
  memory bytes/s of NVIDIA cards from their public spec sheets, keyed on
  ``torch.cuda.get_device_name()``; the CPU and any card not listed get
  ``known=False``, and then no achieved fraction is computed.

Where the card differs from XLA:

- **Execution time.** On the CPU every op is synchronous, so the
  histogram records the call's wall time, as JAX records real execution
  time off the TPU. On the card the host is never synchronised on the
  default path: the call runs between a CUDA event pair recorded on the
  current stream (the stream's time from the call's first enqueued work
  to its last, idle gaps of a host-bound call included), and the pair
  resolves into ``exec_ms`` when a later call or :func:`anatomy` finds
  it complete. At most ``MAX_PENDING`` pairs wait; when the list is full
  the oldest is waited on. :func:`snapshot` waits on the newest end
  event only, then resolves every pair. ``enable(block=True)`` keeps
  JAX's override: ``torch.cuda.synchronize()`` after each call and its
  wall time recorded.
- **Annotation.** Each call runs under
  ``torch.profiler.record_function("dt.<prog>[<bucket>]")``, the
  counterpart of JAX's ``TraceAnnotation``: ``/debug/profile`` and
  ``TraceCapture`` traces name the programs (``enable(annotate=False)``
  drops it).
- **The cost probe is the first call itself.** JAX lowers the program
  abstractly before its first dispatch; the port has no lowering, and
  its programs change their state in place (``AdamW.update_``, the KV
  pool), so a second copy of the call is never run: the first call runs
  under a counting ``TorchDispatchMode``. FLOPs come from
  ``torch.utils.flop_counter``'s formulas for aten ops (matrix products,
  attention, convolutions: elementwise ops count none);
  ``bytes_accessed`` is the sum of each aten op's tensor operand and
  output bytes (views and uninitialised allocations move none). The
  hand-written kernels run through ``ctypes`` and are invisible to a
  dispatch mode, so each kernel wrapper (``ops/flash_attention.py``,
  ``ops/fused_ce.py``, ``ops/paged_attention.py``,
  ``ops/dequant_scatter.py``) reports its own count through
  :func:`kernel_cost`, the count its ``PERF.md`` bound uses, only when
  it launches its kernel and only while a probe is active; the plain
  versions are aten ops the mode sees, so nothing counts twice. These
  counts are the port's own and not XLA's: XLA counts fused HLO ops,
  elementwise FLOPs included. The probe's wall time lands in
  ``compile_ms`` with the rest of the first call. The probe keeps its
  plain ``__torch_dispatch__``: ``TorchDispatchMode`` would wrap it
  against ``torch.compile`` tracing and so import ``torch._dynamo`` at
  a process's first probe (seconds on a slow disk), and the probe never
  runs under ``torch.compile``.

Programs JAX wraps that the port does not compute as one call, and so
never records: ``serve.decode_attn`` (JAX wraps the standalone paged
decode program only in its bench; the port's decode kernel runs inside
``serve.decode`` and ``serve.decode_sample``), and ``eval.stack`` and
``eval.pad`` (the port's cohort evaluator keeps its candidates as a
list and builds no stacked, padded tree). The port's screens run on the
host, so ``delta.finite``, ``delta.screen`` and ``delta.screen_packed``
are host phases here (``host: true``), one delta a record.

Everything is off until :func:`enable` runs (``neurons/common.build``
calls it after ``obs.configure`` when the role has a sink and
``--no-devprof`` is not given): a wrapped program costs one module-flag
branch when off. Exposure: ``obs.flush`` mirrors :func:`snapshot` into
the role's JSONL as ``{"devprof": ..., "role": ...}``,
``utils/obs_http.py`` renders :func:`prom_lines`, and :func:`anatomy`
gives the ``anat.*`` fields heartbeats carry.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

from . import obs

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Closed program vocabulary
# ---------------------------------------------------------------------------

# name -> description (the JAX package's names; the port's sites)
PROGRAMS: dict[str, str] = {
    "train.step": "miner fwd+bwd+optimizer train step "
                  "(engine/train.TrainEngine.train_step, "
                  "engine/lora_train.LoRAEngine.train_step)",
    "train.eval": "token-weighted eval step (engine/train.py)",
    "push.snapshot": "delta snapshot / wire-v2 pack of a push "
                     "(engine/train.MinerLoop._push_snapshot)",
    "eval.cohort": "K-candidate cohort eval over one batch "
                   "(engine/batched_eval.py)",
    "eval.stack": "cohort stack+pad assembly (JAX only: the port keeps "
                  "a candidate list)",
    "eval.pad": "stacked-cohort pad-up (JAX only: the port keeps a "
                "candidate list)",
    "merge.sharded": "sharded-stack cohort merge "
                     "(parallel/collectives.sharded_cohort_merge)",
    "delta.finite": "tree-finiteness screen (delta.has_nonfinite; a host "
                    "phase in the port)",
    "delta.merge": "weighted merge of placed deltas (delta.py)",
    "delta.screen": "dense delta screen (delta.screen_deltas; a host "
                    "phase in the port)",
    "delta.screen_packed": "packed-wire delta screen (delta.screen_deltas; "
                           "a host phase in the port)",
    "delta.accumulate": "dense or plain packed accumulation "
                        "(delta.accumulate_delta)",
    "delta.dequant_scatter": "packed accumulation through the "
                             "dequant-scatter kernel "
                             "(delta.accumulate_delta / "
                             "ops/dequant_scatter.py)",
    "delta.densify": "host densify of packed wire entries "
                     "(delta.densify_packed_v2)",
    "serve.prefill": "full-prompt prefill (engine/serve.py)",
    "serve.decode": "greedy decode step, per (slot, page) bucket "
                    "(engine/serve.py)",
    "serve.decode_attn": "standalone paged-attention decode program "
                         "(JAX bench only; the port's kernel runs inside "
                         "serve.decode)",
    "serve.decode_sample": "sampled twin of serve.decode, per (slot, "
                           "page) bucket (engine/serve.py)",
    "serve.prefill_ctx": "suffix prefill over shared prefix-cache pages, "
                         "per (T, page) bucket (engine/serve.py)",
    "serve.sample_tok": "seeded sampler of the first token after a "
                        "prefill (engine/serve.py)",
    "serve.page_copy": "whole-page KV copy, the copy-on-write primitive "
                       "(engine/serve.py)",
    "serve.kv_adopt": "adopted-KV page write on a decode worker "
                      "(engine/serve.py, engine/kv_transfer.py)",
    "serve.draft": "drafter propose step / context prefill "
                   "(engine/speculative.py)",
    "serve.verify": "speculative K+1-position verify pass "
                    "(engine/serve.py)",
}


# ---------------------------------------------------------------------------
# Rooflines
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Roofline:
    """One card's peaks: dense BF16 FLOP/s and memory bytes/s, from
    public spec sheets. ``known=False`` is the explicit fallback of the
    CPU and of cards not listed: fractions are then omitted."""
    device_kind: str
    peak_flops: float | None
    hbm_bytes_per_s: float | None
    known: bool = True

    @property
    def ridge_intensity(self) -> float | None:
        """FLOPs/byte at the compute/memory-bound ridge point."""
        if not self.peak_flops or not self.hbm_bytes_per_s:
            return None
        return self.peak_flops / self.hbm_bytes_per_s


# substrings of the lowercased ``torch.cuda.get_device_name()`` ->
# (dense BF16 FLOP/s, memory bytes/s), each card at the board power its
# spec sheet rates it at (a card capped lower runs slower: fractions
# against these peaks are then low). The most specific spelling first.
_ROOFLINE_LADDER: tuple[tuple[tuple[str, ...], float, float], ...] = (
    (("h100 pcie",), 756e12, 2.0e12),          # H100 PCIe, 350 W
    (("h100 nvl",), 835e12, 3.9e12),           # H100 NVL, 400 W
    (("h100",), 989.4e12, 3.35e12),            # H100 SXM5 80GB HBM3, 700 W
    (("h200",), 989.4e12, 4.8e12),             # H200 SXM 141GB, 700 W
    (("a100-sxm4-80gb", "a100 80gb"), 312e12, 2.039e12),  # A100 80GB, 400 W
    (("a100",), 312e12, 1.555e12),             # A100 40GB, 400 W
)

# exported for docs and tests: the spellings the ladder recognises
ROOFLINES: dict[str, Roofline] = {
    keys[0]: Roofline(keys[0], fl, bw) for keys, fl, bw in _ROOFLINE_LADDER
}


def roofline_for(device_kind: str) -> Roofline:
    """Roofline for a device name; the CPU and unlisted cards get the
    explicit ``known=False`` fallback."""
    text = (device_kind or "").lower()
    for keys, fl, bw in _ROOFLINE_LADDER:
        if any(k in text for k in keys):
            return Roofline(device_kind, fl, bw)
    return Roofline(device_kind or "unknown", None, None, known=False)


def _on_card() -> bool:
    """True once this process uses a CUDA card (a role forced onto the
    CPU never initialises CUDA)."""
    try:
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:
        return False


def current_roofline() -> Roofline:
    """Roofline of this process's card (``"cpu"`` before any CUDA use),
    cached until :func:`reset`."""
    st = _STATE
    if st.roofline is None or (not st.roofline.known and _on_card()):
        try:
            if _on_card():
                import torch
                st.roofline = roofline_for(torch.cuda.get_device_name(
                    torch.cuda.current_device()))
            else:
                st.roofline = roofline_for("cpu")
        except Exception:  # a failed query degrades, never raises
            st.roofline = Roofline("unknown", None, None, known=False)
    return st.roofline


# ---------------------------------------------------------------------------
# The cost probe
# ---------------------------------------------------------------------------

# allocations that initialise nothing: no bytes move
_NO_BYTES = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided"))


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _probe_mode_class():
    """The counting TorchDispatchMode class (built on first use: nothing
    of torch is imported with this module)."""
    with _PROBE_LOCK:
        return _PROBE_CLS or _build_probe_mode_class()


def _build_probe_mode_class():
    global _PROBE_CLS
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CostProbe(TorchDispatchMode):
        """Counts FLOPs (``flop_counter``'s formulas) and operand plus
        output bytes of every aten op run under it; kernels add theirs
        through :func:`kernel_cost`."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.paused = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self.paused:
                try:
                    self._count(func, args, kwargs, out)
                except Exception:   # a formula's failure costs a count
                    logger.debug("devprof: no count for %s", func,
                                 exc_info=True)
            return out

        def _count(self, func, args, kwargs, out) -> None:
            packet = func.overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            if getattr(func, "is_view", False) \
                    or packet.__name__ in _NO_BYTES:
                return
            self.bytes += float(_tensor_bytes((args, kwargs))
                                + _tensor_bytes(out))

    # TorchDispatchMode wraps a subclass's __torch_dispatch__ so that
    # torch.compile does not trace it, which imports torch._dynamo at the
    # first op (seconds on a slow disk); the probe never runs under
    # torch.compile, so it keeps the plain function
    raw = CostProbe.__dict__["__torch_dispatch__"]
    CostProbe.__torch_dispatch__ = getattr(raw, "__wrapped__", raw)
    _PROBE_CLS = CostProbe
    return CostProbe


_PROBE_CLS = None
_PROBE_LOCK = threading.Lock()   # one class: _active_probe's isinstance


def _active_probe():
    """The cost probe on this thread's dispatch-mode stack (the autograd
    engine carries the stack into its backward threads), or None."""
    if _PROBE_CLS is None:
        return None
    try:
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, _PROBE_CLS):
                return mode
    except Exception:
        return None
    return None


def probing() -> bool:
    """True while a first call's cost probe is counting."""
    return _active_probe() is not None


def kernel_cost(cost: Callable[[], tuple[float, float]]) -> None:
    """A hand-written kernel's FLOPs and bytes for the active probe:
    ``cost()`` runs (its own tensor ops uncounted) only while a probe
    is active; otherwise nothing happens."""
    probe = _active_probe()
    if probe is None:
        return
    probe.paused += 1
    try:
        flops, nbytes = cost()
    finally:
        probe.paused -= 1
    probe.flops += float(flops)
    probe.bytes += float(nbytes)


# ---------------------------------------------------------------------------
# Per-program records
# ---------------------------------------------------------------------------

class ProgramStats:
    """One (program, bucket) cell of the registry."""

    __slots__ = ("prog", "bucket", "host", "calls", "compile_ms",
                 "flops", "bytes_accessed", "cost_probed", "exec_ms")

    def __init__(self, prog: str, bucket: str, *, host: bool = False):
        self.prog = prog
        self.bucket = bucket
        self.host = host
        self.calls = 0
        self.compile_ms: float | None = None
        self.flops: float | None = None
        self.bytes_accessed: float | None = None
        self.cost_probed = False
        self.exec_ms = obs.Histogram("devprof.exec_ms", capacity=512)

    def arithmetic_intensity(self) -> float | None:
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def achieved(self, roofline: Roofline) -> tuple[float | None,
                                                    float | None]:
        """(achieved peak-FLOPs fraction, achieved memory-bandwidth
        fraction) at the exec p50 — None wherever the count or the
        roofline has no number (the CPU, an unlisted card, a host
        phase)."""
        if self.host or not self.exec_ms.count:
            return None, None
        p50_s = self.exec_ms.percentiles((50.0,))["p50"] / 1e3
        if not p50_s or p50_s <= 0:
            return None, None
        ff = bf = None
        if self.flops and roofline.peak_flops:
            ff = (self.flops / p50_s) / roofline.peak_flops
        if self.bytes_accessed and roofline.hbm_bytes_per_s:
            bf = (self.bytes_accessed / p50_s) / roofline.hbm_bytes_per_s
        return ff, bf

    def as_record(self, roofline: Roofline) -> dict:
        ff, bf = self.achieved(roofline)
        rec: dict[str, Any] = {
            "prog": self.prog, "bucket": self.bucket, "calls": self.calls,
            "host": self.host, "compile_ms": self.compile_ms,
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "exec_ms": self.exec_ms.snapshot(),
        }
        ai = self.arithmetic_intensity()
        if ai is not None:
            rec["arith_intensity"] = round(ai, 4)
        if ff is not None:
            rec["achieved_flops_frac"] = round(ff, 6)
        if bf is not None:
            rec["achieved_bw_frac"] = round(bf, 6)
        return rec


# event pairs waiting to resolve on the card
MAX_PENDING = 64


class _DevprofState:
    def __init__(self, *, max_programs: int = 64):
        self.lock = threading.Lock()
        self.records: dict[tuple[str, str], ProgramStats] = {}
        self.max_programs = max_programs
        self.dropped = 0
        self.roofline: Roofline | None = None
        self.block = False
        self.annotate = True
        self.probe_costs = True
        # (record, start event, end event) in enqueue order
        self.pending: collections.deque = collections.deque()


_STATE = _DevprofState()
_ON = False


def enable(*, block: bool | None = None, annotate: bool | None = None,
           max_programs: int = 64, probe_costs: bool = True) -> None:
    """Turn the observatory on. ``block=True`` synchronises the card
    after each call and records its wall time (default: event pairs, no
    synchronisation); ``annotate=False`` drops the profiler ranges;
    ``max_programs`` caps the (program, bucket) cardinality (new cells
    past it are dropped and counted); ``probe_costs=False`` skips the
    first call's count."""
    global _ON
    st = _STATE
    with st.lock:
        st.max_programs = max(1, int(max_programs))
        st.block = bool(block)
        st.annotate = True if annotate is None else bool(annotate)
        st.probe_costs = probe_costs
    _ON = True
    # every obs.flush() then logs a {"devprof": ...} record beside the
    # registry snapshot
    obs.attach_devprof(on_flush)


def disable() -> None:
    global _ON
    _ON = False
    obs.attach_devprof(None)


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Drop ALL observatory state (records, pending pairs, the roofline
    cache, the enabled flag): role mains call it beside ``obs.reset()``
    on exit."""
    global _STATE, _ON
    _STATE = _DevprofState()
    _ON = False
    obs.attach_devprof(None)


def dirty() -> bool:
    return _ON or bool(_STATE.records) or _STATE.dropped > 0


def _get_record(prog: str, bucket: str, *,
                host: bool = False) -> ProgramStats | None:
    st = _STATE
    key = (prog, bucket)
    with st.lock:
        rec = st.records.get(key)
        if rec is None:
            if len(st.records) >= st.max_programs:
                st.dropped += 1
                return None
            rec = st.records[key] = ProgramStats(prog, bucket, host=host)
        return rec


def _bucket_of(bucket, args, kwargs) -> str:
    if bucket is None:
        return "-"
    if callable(bucket):
        try:
            bucket = bucket(args, kwargs)
        except Exception:
            return "-"
    return str(bucket)


def _drain(*, wait: bool = False) -> None:
    """Resolve the pending event pairs that completed (with ``wait``,
    first wait on the newest end event, so that every pair resolves)."""
    st = _STATE
    with st.lock:
        if not st.pending:
            return
        newest = st.pending[-1][2]
    if wait:
        newest.synchronize()
    with st.lock:
        keep = collections.deque()
        for rec, start, end in st.pending:
            if end.query():
                rec.exec_ms.observe(start.elapsed_time(end))
            else:
                keep.append((rec, start, end))
        st.pending = keep


def _observed_call(prog: str, bucket, fn, args, kwargs):
    st = _STATE
    rec = _get_record(prog, _bucket_of(bucket, args, kwargs))
    first = rec is not None and rec.calls == 0
    card = _on_card()
    label = f"dt.{prog}[{rec.bucket if rec else '-'}]"
    probe = None
    if first and st.probe_costs and not rec.cost_probed:
        probe = _probe_mode_class()()
    start = end = None
    t0 = time.perf_counter()
    if card and rec is not None and not first and not st.block:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    if st.annotate:
        import torch
        with torch.profiler.record_function(label):
            if probe is not None:
                with probe:
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
    elif probe is not None:
        with probe:
            out = fn(*args, **kwargs)
    else:
        out = fn(*args, **kwargs)
    if end is not None:
        end.record()
    elif card and st.block:
        import torch
        torch.cuda.synchronize()
    dur_ms = (time.perf_counter() - t0) * 1e3
    if rec is None:
        return out
    with st.lock:
        rec.calls += 1
        if probe is not None:
            rec.cost_probed = True
            rec.flops = probe.flops
            rec.bytes_accessed = probe.bytes
        if first:
            # the first call's wall (the probe, the kernels' builds and
            # the dispatch) stays out of the exec histogram
            rec.compile_ms = round(dur_ms, 3)
        elif end is not None:
            st.pending.append((rec, start, end))
            oldest = (st.pending[0][2] if len(st.pending) > MAX_PENDING
                      else None)
        else:
            rec.exec_ms.observe(dur_ms)
    if end is not None:
        if oldest is not None:
            oldest.synchronize()
        _drain()
    return out


def wrap(name: str, fn: Callable, *, bucket=None) -> Callable:
    """Register ``fn`` as the program ``name`` (closed vocabulary:
    unknown names raise). ``bucket`` labels its shape family: a static
    value, or a callable ``(args, kwargs) -> value`` evaluated per call.
    Returns a wrapper that is a one-branch pass-through until
    :func:`enable`."""
    if name not in PROGRAMS:
        raise ValueError(
            f"unknown devprof program {name!r}; register it in "
            f"devprof.PROGRAMS (closed vocabulary: {sorted(PROGRAMS)})")

    def wrapped(*args, **kwargs):
        if not _ON:
            return fn(*args, **kwargs)
        return _observed_call(name, bucket, fn, args, kwargs)

    functools.update_wrapper(wrapped, fn)
    wrapped._devprof_name = name  # type: ignore[attr-defined]
    return wrapped


def call(name: str, fn: Callable, *args, bucket=None, **kwargs):
    """``fn(*args, **kwargs)`` once as the program ``name`` at ``bucket``:
    :func:`wrap` for a site that knows its bucket only inside the call
    (the serving engine's per-step buckets)."""
    if name not in PROGRAMS:
        raise ValueError(
            f"unknown devprof program {name!r}; register it in "
            f"devprof.PROGRAMS (closed vocabulary: {sorted(PROGRAMS)})")
    if not _ON:
        return fn(*args, **kwargs)
    return _observed_call(name, bucket, fn, args, kwargs)


@contextmanager
def track(name: str, *, bucket=None):
    """Host-phase sibling of :func:`wrap` (``host: true``): the block's
    wall time into the same per-(program, bucket) histograms, no
    probe."""
    if name not in PROGRAMS:
        raise ValueError(
            f"unknown devprof program {name!r}; register it in "
            f"devprof.PROGRAMS (closed vocabulary: {sorted(PROGRAMS)})")
    if not _ON:
        yield
        return
    rec = _get_record(name, _bucket_of(bucket, (), {}), host=True)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if rec is not None:
            with _STATE.lock:
                rec.calls += 1
                rec.exec_ms.observe((time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------------------
# Exposure
# ---------------------------------------------------------------------------

def records() -> list[ProgramStats]:
    with _STATE.lock:
        return list(_STATE.records.values())


def snapshot() -> dict:
    """JSON-able registry dump (the ``{"devprof": ...}`` record): every
    pending pair resolved first (one wait on the newest end event), then
    the per-program records, the roofline and the dropped count."""
    _drain(wait=True)
    rl = current_roofline()
    recs = records()
    return {
        "roofline": {"device_kind": rl.device_kind,
                     "peak_flops": rl.peak_flops,
                     "hbm_bytes_per_s": rl.hbm_bytes_per_s,
                     "known": rl.known},
        "programs": sorted((r.as_record(rl) for r in recs),
                           key=lambda r: (r["prog"], r["bucket"])),
        "dropped_programs": _STATE.dropped,
    }


def on_flush(sink, role: str | None = None) -> None:
    """obs.flush hook: the registry snapshot through the role's sink, one
    record a flush."""
    if not _ON or sink is None or not _STATE.records:
        return
    sink.log({"devprof": snapshot(), "role": role or "unknown"})


# step histogram -> (device programs attributed to it, data-wait
# histogram): the step-time anatomy join. Sums are averages over the
# step count so the parts are additive (host-blocked = step - device).
_ANATOMY = (
    ("miner.step_ms", ("train.step",), "miner.data_wait_ms"),
    ("serve.step_ms", ("serve.decode", "serve.prefill"), None),
)


def anatomy() -> dict[str, float]:
    """Step-time anatomy fields (``anat.*``): average step wall-clock,
    the device-program share this registry attributes, the host-blocked
    remainder, and data wait. Empty when the observatory is off or no
    step histogram has samples. Completed event pairs resolve first (no
    wait)."""
    if not _ON:
        return {}
    _drain()
    reg = obs.registry()
    for step_name, progs, wait_name in _ANATOMY:
        h = reg.peek(step_name)
        if h is None or not getattr(h, "count", 0):
            continue
        steps = h.count
        step_avg = h.total / steps
        device_total = sum(
            r.exec_ms.total + (r.compile_ms or 0.0)
            for r in records() if r.prog in progs and not r.host)
        device_avg = device_total / steps
        out = {
            "anat.step_ms": round(step_avg, 3),
            "anat.device_ms": round(device_avg, 3),
            "anat.host_ms": round(max(0.0, step_avg - device_avg), 3),
            "anat.device_frac": round(
                min(1.0, device_avg / step_avg) if step_avg > 0 else 0.0,
                4),
        }
        if wait_name is not None:
            w = reg.peek(wait_name)
            if w is not None and getattr(w, "count", 0):
                out["anat.data_wait_ms"] = round(w.total / w.count, 3)
        return out
    return {}


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
                 .replace("\n", r"\n")


def prom_lines() -> list[str]:
    """Prometheus exposition lines for ``utils/obs_http.py``:
    ``dt_prog_*{prog,bucket}`` series per registered program (calls,
    flops, bytes, exec-time quantiles, achieved fractions, arithmetic
    intensity) plus ``dt_compile_ms{prog,bucket}``. Empty when off."""
    if not _ON:
        return []
    _drain()
    rl = current_roofline()
    recs = records()
    if not recs:
        return []
    lines: list[str] = []
    series: dict[str, list[str]] = {}

    def emit(pn: str, labels: str, v) -> None:
        series.setdefault(pn, []).append(f"{pn}{{{labels}}} {float(v)!r}")

    for r in sorted(recs, key=lambda r: (r.prog, r.bucket)):
        lab = f'prog="{_esc(r.prog)}",bucket="{_esc(r.bucket)}"'
        emit("dt_prog_calls", lab, r.calls)
        if r.compile_ms is not None:
            emit("dt_compile_ms", lab, r.compile_ms)
        if r.flops is not None:
            emit("dt_prog_flops", lab, r.flops)
        if r.bytes_accessed is not None:
            emit("dt_prog_bytes_accessed", lab, r.bytes_accessed)
        if r.exec_ms.count:
            ps = r.exec_ms.percentiles((50.0, 95.0, 99.0))
            for q, qv in (("0.5", ps["p50"]), ("0.95", ps["p95"]),
                          ("0.99", ps["p99"])):
                emit("dt_prog_exec_ms", lab + f',q="{q}"', qv)
        ai = r.arithmetic_intensity()
        if ai is not None:
            emit("dt_prog_arith_intensity", lab, ai)
        ff, bf = r.achieved(rl)
        if ff is not None:
            emit("dt_prog_achieved_flops_frac", lab, ff)
        if bf is not None:
            emit("dt_prog_achieved_bw_frac", lab, bf)
    for pn in sorted(series):
        lines.append(f"# TYPE {pn} gauge")
        lines.extend(series[pn])
    if _STATE.dropped:
        lines.append("# TYPE dt_prog_dropped gauge")
        lines.append(f"dt_prog_dropped {float(_STATE.dropped)!r}")
    return lines


def achieved_fractions() -> dict[str, float]:
    """prog -> best achieved-FLOPs fraction across buckets: the compact
    per-program utilization summary."""
    _drain()
    rl = current_roofline()
    out: dict[str, float] = {}
    for r in records():
        ff, _ = r.achieved(rl)
        if ff is not None:
            out[r.prog] = max(out.get(r.prog, 0.0), round(ff, 6))
    return out
