"""The port's flight recorder (utils/flight.py), AnomalyMonitor
(utils/obs.py) and TraceCapture (utils/metrics.py) against the JAX
package's, on the CPU.

- The ring, the sanitized config and the frozen bundle equal the JAX
  recorder's for the same events on the same clock (``bundle_id``
  included); a bundle of either package parses in the other, through
  ``parse_bundle`` and through ``fetch_bundle`` over one LocalFS root;
  unknown event kinds are refused by both producers and dropped by both
  readers; an oversized ring drops its oldest events to fit.
- The process-wide plane: ``configure``, spans and flushes reaching the
  ring through ``obs.attach_flight``, ``shutdown`` freezing a crash
  bundle, the crash hooks installed and removed.
- ``AnomalyMonitor`` fires the same rule at the same observation as the
  JAX monitor for the same loss, step-time and push-counter series, once.
- ``TraceCapture`` on the CPU profiler: disarmed ticks are free, an armed
  capture writes one Chrome trace of its window and never re-arms; a
  MinerLoop whose params are blown up mid-run (a planted loss spike)
  arms exactly one window, which writes its trace.
"""

import dataclasses
import json
import os
import sys
import threading

import pytest
import torch

from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.utils import flight as jflight
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.utils import flight, obs
from distributedtraining_tpu_torch.utils.metrics import TraceCapture

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")


@pytest.fixture(autouse=True)
def _clean():
    yield
    flight.reset()
    obs.reset()
    jflight.reset()
    jobs.reset()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _record_the_same(rec):
    rec.record("publish", outcome="ok", hotkey="m0", cid="m0-000001",
               shards=3)
    rec.record("anomaly", reason="loss_spike", armed=True)
    rec.record("note", what="x" * 1000, nested={"a": 1.5, "b": "skip"},
               ratio=0.5, flag=False, none=None, obj=object)
    rec.on_span("push.upload", 12.3456, "m0-000001", False)


def test_bundles_equal_and_parse_across_packages(tmp_path):
    cfg = {"role": "miner", "wallet_path": "/keys", "lr": 3e-4,
           "steps": 5, "fused": True, "skip": None, "mesh": [1, 2]}
    ours = flight.FlightRecorder("miner", "m0", capacity=8, config=cfg,
                                 clock=_Clock())
    theirs = jflight.FlightRecorder("miner", "m0", capacity=8, config=cfg,
                                    clock=_Clock())
    for rec in (ours, theirs):
        _record_the_same(rec)
        for i in range(6):        # past the capacity: the ring keeps 8
            rec.record("heartbeat", seq=i)
    assert ours.events() == theirs.events() and len(ours.events()) == 8
    assert ours.recorded == theirs.recorded == 11
    b_p, b_j = ours.freeze("test"), theirs.freeze("test")
    assert b_p == b_j
    assert b_p["bundle_id"] == flight.bundle_digest(b_p) == \
        jflight.bundle_digest(b_j)
    assert b_p["config"]["wallet_path"] == "<redacted>"
    data = json.dumps(b_p).encode()
    assert flight.parse_bundle(data) == jflight.parse_bundle(data)
    # the port's RunConfig sanitizes as the JAX one, key for key
    from distributedtraining_tpu.config import RunConfig as JRunConfig
    s_p = flight.sanitize_config(RunConfig.from_args("miner", []))
    s_j = jflight.sanitize_config(JRunConfig.from_args("miner", []))
    assert s_p == {k: s_j[k] for k in s_p}
    # through the transport, both ways
    root = str(tmp_path)
    ours.transport, theirs.transport = LocalFSTransport(root), JFS(root)
    assert ours.publish(b_p)
    got = jflight.fetch_bundle(JFS(root), "miner", "m0")
    assert got == flight.fetch_bundle(LocalFSTransport(root), "miner", "m0")
    assert got["bundle_id"] == b_p["bundle_id"] and got["reason"] == "test"
    theirs.hotkey = "m1"
    b2 = theirs.freeze("from-jax")
    assert theirs.publish(b2)
    assert flight.fetch_bundle(LocalFSTransport(root), "miner", "m1")[
        "bundle_id"] == b2["bundle_id"]


def test_unknown_kinds_and_oversized_rings():
    for mod in (flight, jflight):
        with pytest.raises(ValueError):
            mod.check_event_kind("bogus")
    hostile = {"pm": 1, "role": "miner", "hotkey": "m0", "reason": "r",
               "events": [{"t": 1.0, "kind": "bogus"},
                          {"t": 2.0, "kind": "note", "x": 1},
                          {"kind": "note"}, "junk"]}
    for mod in (flight, jflight):
        got = mod.parse_bundle(hostile)
        assert got["events_rejected"] == 3 and len(got["events"]) == 1
        assert mod.parse_bundle({"pm": 0, "role": "r", "hotkey": "h"}) is None
        assert mod.parse_bundle(b"x" * (mod.PM_MAX_BYTES + 1)) is None
    t = InMemoryTransport()
    rec = flight.FlightRecorder("averager", "a0", capacity=4096,
                                transport=t, clock=_Clock())
    for i in range(4096):
        rec.record("note", what="y" * 390, i=i)
    assert rec.publish(rec.freeze("big"))
    got = flight.fetch_bundle(t, "averager", "a0")
    assert got is not None and 0 < len(got["events"]) < 4096
    assert got["events"][-1]["i"] == 4095      # the newest evidence stays


def test_process_plane_hooks_and_shutdown():
    t = InMemoryTransport()
    assert flight.record("note", what="off") is None    # no recorder: no-op
    assert flight.freeze_and_publish("none") is None
    rec = flight.configure("validator", "v0", transport=t, capacity=64,
                           config=RunConfig.from_args("validator", []))
    obs.configure()
    with obs.span("val.eval", cid="c-1"):
        obs.count("val.rounds")
    obs.flush()
    kinds = [e["kind"] for e in rec.events()]
    assert kinds[0] == "config" and "span" in kinds and "metrics" in kinds
    span = next(e for e in rec.events() if e["kind"] == "span")
    assert span["name"] == "val.eval" and span["cid"] == "c-1"
    mon = obs.AnomalyMonitor()
    mon.trigger_external("lineage_drift", revision="r1")
    assert rec.events()[-1]["kind"] == "anomaly"
    hook = sys.excepthook
    flight.install_crash_hooks()
    assert flight.hooks_installed() and sys.excepthook is not hook
    try:
        raise RuntimeError("boom")
    except RuntimeError:
        flight.shutdown()
    assert sys.excepthook is hook and not flight.hooks_installed()
    assert flight.recorder() is None
    got = flight.fetch_bundle(t, "validator", "v0")
    assert got["reason"] == "crash" and got["crash"]["type"] == \
        "RuntimeError"
    assert got["events"][-1]["kind"] == "crash"
    # a normal exit freezes nothing
    flight.configure("validator", "v1", transport=t)
    flight.shutdown()
    assert flight.fetch_bundle(t, "validator", "v1") is None
    # a worker thread's crash freezes a bundle through the thread hook
    flight.configure("miner", "m2", transport=t)
    flight.install_crash_hooks()
    prev = flight._STATE.prev_threading_hook
    flight._STATE.prev_threading_hook = lambda args: None
    th = threading.Thread(target=lambda: 1 / 0)
    th.start()
    th.join()
    flight._STATE.prev_threading_hook = prev
    flight.reset()
    assert flight.fetch_bundle(t, "miner", "m2")["reason"] == "thread_crash"


def _series_trigger(mod, feed):
    """(index of the observation that fired, reason) of one monitor."""
    mon = mod.AnomalyMonitor(loss_warmup=3, push_failure_streak=2,
                             step_warmup=8, check_every=4)
    for i, (kind, *args) in enumerate(feed):
        before = mon.triggered
        getattr(mon, kind)(*args)
        if mon.triggered != before:
            fired = (i, mon.triggered)
    return fired if mon.triggered else None


@pytest.mark.parametrize("feed", [
    [("observe_loss", x) for x in (5.0, 4.8, 4.7, 4.6, 4.5, 9.5, 20.0)],
    [("observe_loss", x) for x in (5.0, 4.9, float("nan"), 50.0)],
    [("observe_step_ms", x) for x in [10.0] * 11 + [500.0] * 2 + [10.0] * 4],
    [("observe_push_counters", p, f) for p, f in
     ((1, 0), (1, 1), (2, 1), (2, 2), (2, 3), (2, 4))],
    [("observe_loss", 5.0)] * 12,
], ids=["loss_spike", "nonfinite", "step_p99", "push_streak", "quiet"])
def test_anomaly_monitor_fires_like_jax(feed):
    assert _series_trigger(obs, feed) == _series_trigger(jobs, feed)


def test_trace_capture_window_on_the_cpu_profiler(tmp_path):
    cap = TraceCapture(str(tmp_path / "t"), steps=2, skip=1, arm=False)
    for _ in range(3):
        cap.tick()
    assert not cap.armed and not cap.active and cap.trace_path is None
    cap.arm()
    cap.tick()                         # the skipped tick
    assert not cap.active
    cap.tick()                         # the window opens
    assert cap.active
    for _ in range(2):
        torch.randn(64, 64) @ torch.randn(64, 64)
        cap.tick()
    assert not cap.active and os.path.isfile(cap.trace_path)
    with open(cap.trace_path) as f:
        assert json.load(f)["traceEvents"]
    cap.arm()
    cap.tick()
    cap.tick()
    assert not cap.active and not cap.armed   # one window an instance


class _Sink:
    def log(self, record, step=None):
        pass


def test_planted_loss_spike_arms_one_capture_window(tmp_path):
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=2, seq_len=32,
                            repeat=True, shuffle=True, seed=1)
    batches = [next(it) for _ in range(12)]
    eng = ttrain.TrainEngine(tg.make_model(TINY)[0], device="cpu")
    t = InMemoryTransport()
    t.publish_base(tg.init_params_numpy(TINY, 0))
    cap = TraceCapture(str(tmp_path / "anomaly"), steps=2, skip=0,
                       arm=False)
    mon = obs.AnomalyMonitor(cap, loss_warmup=3)
    loop = ttrain.MinerLoop(eng, t, "m0", clock=FakeClock(),
                            send_interval=1e9, check_update_interval=1e9,
                            metrics=_Sink(), log_every=1, anomaly=mon)
    loop.bootstrap()
    loop.run(iter(batches[:5]))
    assert mon.triggered is None and not cap.armed
    with torch.no_grad():             # the planted divergence
        loop.state.params["wte"].mul_(50.0)
    loop.run(iter(batches[5:]))
    loop.flush()
    loop.close()
    assert mon.triggered == "loss_spike"
    assert cap.trace_path is not None and not cap.active
    assert os.listdir(str(tmp_path / "anomaly")) == [
        os.path.basename(cap.trace_path)]
    with open(cap.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("mm" in n or "addmm" in n for n in names)
