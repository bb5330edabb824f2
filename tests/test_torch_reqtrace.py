"""Request traces (utils/reqtrace.py) and the SLO burn-rate monitor
(engine/health.py) of the port against the JAX package's, on the CPU.

One scripted clock drives both packages: request ids, stage records
(coalescing, overflow), exemplar picks, sealed windows and the flight
events they freeze are equal; the burn monitors fire the same alerts at
the same times. Then the engine: traces are on by default, as in JAX,
every request's timeline closes with ``emit``, a refused request is
traced, and the frozen exemplar events parse.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import health as jhealth
from distributedtraining_tpu.utils import flight as jflight
from distributedtraining_tpu.utils import reqtrace as jrt
from distributedtraining_tpu_torch.engine import health as thealth
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import InMemoryTransport
from distributedtraining_tpu_torch.utils import flight as tflight
from distributedtraining_tpu_torch.utils import reqtrace as trt


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Req:
    """The fields a TraceBook reads off a serve request."""

    def __init__(self, rid, t, request_id=None):
        self.rid, self.submitted_t, self.request_id = rid, t, request_id
        self.tokens = []


def test_request_ids_and_vocabulary_match_jax():
    assert trt.STAGES == jrt.STAGES
    assert trt.REQUEST_ID_HEADER == jrt.REQUEST_ID_HEADER
    for content in ([1, 2, 3], b"body", "text", []):
        for meta in ({}, {"temperature": 0.7, "seed": 3, "top_p": 1.0}):
            assert trt.mint_request_id(content, seq=5, **meta) == \
                jrt.mint_request_id(content, seq=5, **meta)
    with pytest.raises(ValueError):
        trt.check_stage("decodes")


def _script(mod, burn=None):
    """Drive one TraceBook through a scripted serving story."""
    clock = Clock()
    book = mod.TraceBook(clock=clock, exemplar_k=2, window_s=10.0, burn=burn)
    reqs = [Req(i, clock.t + i * 0.1, request_id=f"rq-{i}")
            for i in range(6)]
    for i, r in enumerate(reqs):
        book.start(r, depth=i)
    for step in range(40):
        clock.t += 0.05
        for r in reqs:
            if step == 0:
                book.stage(r.rid, "admit", queue_age_ms=3.0 + r.rid)
                book.stage(r.rid, "prefill", pfx_hit=r.rid % 2,
                           pfx_tokens=16, prompt_tokens=20,
                           dur_ms=1.5 * (r.rid + 1))
                book.note_latency(r.rid, ttft_ms=40.0 * (r.rid + 1))
            elif r.rid % 3 == 0 and step % 5 == 0:
                book.stage(r.rid, "spec", proposed=4, accepted=r.rid % 4,
                           tokens=1 + r.rid % 4)
            else:
                book.stage_span(r.rid, "decode", clock.t, clock.t, 1,
                                tokens=1)
                book.note_latency(r.rid, tpot_sum_ms=5.0 + r.rid,
                                  tpot_n=1)
            if step == 20 and r.rid == 4:
                book.stage(r.rid, "cow", pages=1)
                book.stage(r.rid, "preempt", seq_len=30)
    for r in reqs:
        r.tokens = list(range(10 + r.rid))
        clock.t += 2.5
        book.finish(r, "done")
    rej = book.reject("rq-shed", "shed", retry_after_s=1.0)
    clock.t += 1.0
    ref = book.seal_window()
    return book, [book.get(r.rid) for r in reqs], rej, ref


def test_trace_books_match_jax_on_one_clock():
    out = {}
    for name, mod, fl in (("port", trt, tflight), ("jax", jrt, jflight)):
        fl.configure("server", "hotkey_1", capacity=4096)
        try:
            book, live, rej, ref = _script(mod)
            events = [(e["kind"], {k: v for k, v in e.items()
                                   if k not in ("t", "kind", "seq")})
                      for e in fl.recorder().events()
                      if e["kind"].startswith("serve.trace")]
            out[name] = {"counters": book.counters(), "rej": rej,
                         "live": live, "events": events,
                         "sealed": book.windows_sealed,
                         "frozen": book.exemplars_frozen}
        finally:
            fl.reset()
    assert out["port"]["events"] == out["jax"]["events"]
    assert len(out["port"]["events"]) > 10
    for key in ("counters", "rej", "live", "sealed", "frozen"):
        assert out["port"][key] == out["jax"][key], key


def test_records_coalesce_and_overflow_as_jax():
    recs = []
    for mod in (trt, jrt):
        tr = mod.RequestTrace("rq-x", 1, 0.0)
        for i in range(100):
            tr.record("decode", float(i), tokens=1)
            tr.record("cow" if i % 2 else "spec", float(i), pages=1)
        tr.note_latency(ttft_ms=12.0, tpot_sum_ms=30.0, tpot_n=3)
        recs.append(tr.as_record())
    assert recs[0] == recs[1] and recs[0]["overflow"] > 0


def _burn_script(mod):
    clock = Clock(50_000.0)
    mon = mod.BurnRateMonitor(clock=clock, min_samples=4)
    fired = []
    rng = np.random.default_rng(0)
    for i in range(3000):
        clock.t += 1.5
        bad = i > 1500 and rng.random() < 0.5
        if i % 11 == 0:
            mon.observe(shed=True)
        else:
            mon.observe(ttft_ms=900.0 if bad else 20.0,
                        tpot_ms=80.0 if bad and i % 2 else 10.0)
        if i % 50 == 0:
            fired += [(round(clock.t, 3), a["slo_burn"], a["window"],
                       a["burn_short"], a["burn_long"])
                      for a in mon.evaluate()]
    return fired, mon.gauges(), mon.max_burn()


def test_burn_monitor_fires_as_jax_on_one_clock():
    ours = _burn_script(thealth)
    ref = _burn_script(jhealth)
    assert ours == ref
    assert "ttft" in {a[1] for a in ours[0]}
    assert thealth.default_burn_rules() == tuple(
        thealth.BurnRule(r.slo, r.objective_ms, r.budget)
        for r in jhealth.default_burn_rules())
    with pytest.raises(ValueError):
        thealth.BurnRule("latency")


def test_attached_monitor_is_a_weak_reference():
    mon = thealth.BurnRateMonitor()
    thealth.attach_burn(mon)
    try:
        assert thealth.live_burn_monitor() is mon
    finally:
        thealth.attach_burn(None)
    assert thealth.live_burn_monitor() is None


# ---------------------------------------------------------------------------
# The engine: traces on by default
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_world():
    cfg = tg.PRESETS["tiny"]
    tree = tg.init_params_numpy(cfg, 0)
    return tg.make_model(cfg)[0], tg.params_from_numpy(tree, device="cpu")


def test_engine_traces_every_request_and_freezes_exemplars(engine_world):
    model, state = engine_world
    transport = InMemoryTransport()
    tflight.configure("server", "hotkey_9", transport=transport)
    burn = thealth.BurnRateMonitor(min_samples=1)
    try:
        eng = tserve.GenerationEngine(model, state, device="cpu",
                                      max_slots=2, page_size=8,
                                      prefix_cache=True, burn=burn)
        assert eng.trace is not None        # the JAX default
        rng = np.random.RandomState(0)
        sys_p = [int(t) for t in rng.randint(0, 512, 12)]
        reqs = [eng.submit(sys_p + [i], 6, temperature=0.5 * (i % 2),
                           seed=i) for i in range(4)]
        seen_live = {}
        for _ in range(200):
            if all(r.done_evt.is_set() for r in reqs):
                break
            eng.step()
            for r in reqs:
                tr = eng.trace.get(r.rid)
                if tr is not None:
                    seen_live[r.rid] = [e["stage"] for e in tr.stages]
        assert all(r.request_id and r.request_id.startswith("rq-")
                   for r in reqs)
        assert eng.trace.finished == 4 and eng.trace.live_count == 0
        # every timeline queued, then was admitted and prefilled (a hit
        # whose suffix starts in a shared page copies it first)
        for stages in seen_live.values():
            assert stages[0] == "queue" and stages.index("admit") < \
                stages.index("prefill")
        eng.close()                         # seals the window
        events = [e for e in tflight.recorder().events()
                  if e["kind"] == "serve.trace.exemplar"]
        assert events and {e["status"] for e in events} == {"done"}
        assert eng.trace.windows_sealed == 1
        assert burn._events["ttft"] and burn.max_burn() >= 0.0
    finally:
        tflight.reset()


def test_refusals_are_traced_at_the_frontend(engine_world):
    model, state = engine_world
    eng = tserve.GenerationEngine(model, state, device="cpu", max_slots=1,
                                  page_size=8, max_queue=1)
    fe = tserve.ServeHTTPFrontend(eng, 0, timeout_s=5.0)
    port = fe.start()
    try:
        eng.submit([1, 2, 3], 4)            # fills the queue
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": [1]}).encode(),
            headers={trt.REQUEST_ID_HEADER: "rq-client-1"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 429
        body = json.loads(ei.value.read())
        assert body["request_id"] == "rq-client-1"
        assert ei.value.headers[trt.REQUEST_ID_HEADER] == "rq-client-1"
        assert eng.trace.rejected == 1 and eng.shed_count == 1
    finally:
        fe.close()
        eng.close()


def test_trace_false_builds_no_book(engine_world):
    model, state = engine_world
    eng = tserve.GenerationEngine(model, state, device="cpu", trace=False)
    try:
        assert eng.trace is None
        assert eng.generate([[1, 2, 3]], 2) and \
            eng.submit([4, 5], 1).request_id is None
    finally:
        eng.close()
        torch.set_num_threads(torch.get_num_threads())
