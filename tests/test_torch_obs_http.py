"""The port's Prometheus exporter (utils/obs_http.py) and its
``/debug/profile`` capture (utils/flight.capture_profile) against the
JAX package, on the CPU.

- ``render()``: registries fed the same calls, FleetMonitors of each
  package over one LocalFS root on one FakeClock schedule, and burn
  monitors fed the same requests give the same text; the device
  observatory's lines (real timings) agree by name and labels.
- ``/metrics`` serves ``render()``; ``/healthz`` answers JAX's JSON.
- ``/debug/dump``'s bundle parses in JAX's ``flight.parse_bundle``, and
  ``?publish=1`` ships it where the port's ``fetch_bundle`` reads it.
- ``/debug/profile`` writes a Chrome trace naming the programs that ran
  on other threads, and answers 409 beside a running capture and beside
  an active ``TraceCapture``; ``/debug/stacks`` lists the threads.
- Every test leaves no exporter, profile session or capture live.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from distributedtraining_tpu.engine import health as jh
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.utils import devprof as jdp
from distributedtraining_tpu.utils import flight as jflight
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu.utils import obs_http as jhttp
from distributedtraining_tpu.utils.metrics import InMemorySink as JSink
from distributedtraining_tpu_torch.engine import health as th
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.utils import devprof, flight, obs
from distributedtraining_tpu_torch.utils import obs_http
from distributedtraining_tpu_torch.utils.metrics import (InMemorySink,
                                                         TraceCapture,
                                                         live_captures)


def _reset_all():
    for m in (obs, jobs, devprof, jdp, flight, jflight):
        m.reset()
    th.attach_burn(None)
    jh.attach_burn(None)


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    for exp in obs_http.live_exporters() + jhttp.live_exporters():
        exp.close()
    live = flight.live_profile_sessions()
    for sess in live:
        sess.stop()
    caps = live_captures()
    for cap in caps:
        cap.close()
    _reset_all()
    assert not live and not caps
    assert not obs_http.live_exporters()


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


# ---------------------------------------------------------------------------
# render() against JAX's
# ---------------------------------------------------------------------------

MINERS = ("m0", "m1", "m2")


def _feed_registry(o):
    o.configure(InMemorySink() if o is obs else JSink(), role="validator")
    for i in range(5):
        o.count("val.rounds")
        o.observe("serve.ttft_ms", 10.0 + 3.5 * i)
        o.observe("serve.tpot_ms", 2.0 + 0.25 * i)
        o.observe("span.val.eval_ms", 100.0 * (i + 1))
    o.gauge("mem_peak_bytes", 1.5e9)
    o.count("chaos.faults", 2)


def _fleet(tmp_path):
    """A FleetMonitor of each package over one root, fed the same beats,
    staging, scores and credit on one FakeClock schedule."""
    root = str(tmp_path / "artifacts")
    pt, jt = LocalFSTransport(root), JFS(root)
    clock, jclock = FakeClock(1000.0), JFakeClock(1000.0)
    steps = {hk: 0 for hk in MINERS}
    pubs = [th.HeartbeatPublisher(
        pt, "miner", hk, interval=60.0, clock=clock,
        vitals=th.Vitals(steps=lambda hk=hk: steps[hk],
                         loss=lambda hk=hk: 2.0 + MINERS.index(hk) * 4,
                         clock=clock))
        for hk in MINERS]
    ours = th.FleetMonitor(pt, metrics=InMemorySink(), clock=clock)
    ref = jh.FleetMonitor(jt, metrics=JSink(), clock=jclock)
    try:
        for r in range(1, 7):
            for i, (hk, pub) in enumerate(zip(MINERS, pubs)):
                if hk == "m2" and r > 2:
                    continue          # m2 dies: stale_node
                steps[hk] += 100
                pub.beat_now(wait=True)
            assert ours.poll(MINERS) == ref.poll(MINERS)
            scores = {hk: 0.1 * (i + 1) * r for i, hk in enumerate(MINERS)}
            ours.record_scores(scores)
            ref.record_scores(scores)
            ours.record_credit({"m1": 0.25 * r})
            ref.record_credit({"m1": 0.25 * r})
            ours.evaluate_slos()
            ref.evaluate_slos()
            clock.advance(30.0)
            jclock.advance(30.0)
    finally:
        for p in pubs:
            p.close()
    return ours, ref


def _burns():
    out = []
    for mod in (th, jh):
        mon = mod.BurnRateMonitor(clock=lambda: 5000.0, min_samples=1)
        for i in range(40):
            mon.observe(4000.0 + 20 * i, ttft_ms=100.0 + 90 * (i % 7),
                        tpot_ms=30.0 + 25 * (i % 3), shed=i % 11 == 0)
        mod.attach_burn(mon)
        out.append(mon)
    return out


def _split(text: str) -> tuple[list, list]:
    """(every line not of the device observatory, its lines by name and
    labels only)."""
    rest, dp = [], []
    for line in text.splitlines():
        if re.match(r"(# TYPE )?dt_(prog_|compile_ms\{)", line):
            dp.append(line.rsplit(" ", 1)[0] if "{" in line else line)
        else:
            rest.append(line)
    return rest, dp


def test_render_equals_jax(tmp_path):
    # the fleets first, with the instruments off (their spans time the
    # host), then the same registry calls on each side
    ours_fleet, ref_fleet = _fleet(tmp_path)
    _feed_registry(obs)
    _feed_registry(jobs)
    burns = _burns()
    try:
        # the device observatory of each, on a matrix product
        devprof.enable()
        jdp.enable()
        f = devprof.wrap("train.eval", lambda x: x @ x, bucket="4x4")
        jf = jdp.wrap("train.eval", jax.jit(lambda x: x @ x), bucket="4x4")
        for _ in range(3):
            f(torch.ones(4, 4))
            jf(jnp.ones((4, 4)))
        text = obs_http.render(fleet=ours_fleet)
        ref = jhttp.render(fleet=ref_fleet)
        rest, dp = _split(text)
        jrest, jdp_lines = _split(ref)
        assert rest == jrest
        assert dp == jdp_lines and len(dp) > 6
        for want in ('dt_serve_ttft_ms{q="0.5"} ', "dt_slo_burn{",
                     'dt_fleet_slo_breached{role="miner",hotkey="m2",'
                     'rule="stale_node"} 1.0', "dt_lineage_credit{",
                     'dt_prog_calls{prog="train.eval",bucket="4x4"} 3.0'):
            assert want in text
        # off: the same text without the observatory's lines
        devprof.disable()
        jdp.disable()
        assert obs_http.render() == jhttp.render()
    finally:
        ours_fleet.close()
        ref_fleet.close()
        del burns


def test_metrics_and_healthz_equal_jax(tmp_path):
    ours_fleet, ref_fleet = _fleet(tmp_path)
    _feed_registry(obs)
    _feed_registry(jobs)
    exp = obs_http.ObsHTTPExporter(0, fleet=ours_fleet, role="validator")
    jexp = jhttp.ObsHTTPExporter(0, fleet=ref_fleet, role="validator")
    try:
        port, jport = exp.start(), jexp.start()
        assert port and exp.running and exp in obs_http.live_exporters()
        code, body, ctype = _get(port, "/metrics")
        jcode, jbody, jctype = _get(jport, "/metrics")
        assert (code, ctype) == (jcode, jctype) == (
            200, "text/plain; version=0.0.4; charset=utf-8")
        assert body.decode() == obs_http.render(fleet=ours_fleet)
        assert body == jbody
        code, body, _ = _get(port, "/healthz")
        jcode, jbody, _ = _get(jport, "/healthz")
        assert code == jcode == 200
        assert json.loads(body) == json.loads(jbody) == {
            "ok": True, "role": "validator", "metrics": len(obs.registry()),
            "fleet_nodes": 3}
        for path in ("/nope", "/debug/nope"):
            assert _get(port, path)[0] == _get(jport, path)[0] == 404
        code, body, _ = _get(port, "/debug/stacks")
        assert code == 200 and f"obs-http-{port}" in body.decode()
        assert _get(port, "/debug/dump")[0] == 503   # no recorder
    finally:
        exp.close()
        jexp.close()
        exp.close()                                  # idempotent
        ours_fleet.close()
        ref_fleet.close()
    assert not exp.running and not obs_http.live_exporters()


def test_debug_dump_parses_in_jax():
    obs.configure(InMemorySink(), role="miner")
    t = InMemoryTransport()
    rec = flight.configure("miner", "hotkey_5", transport=t, capacity=64,
                           config={"role": "miner", "wallet_path": "x"})
    with obs.span("push.snapshot", cid="hotkey_5-000001"):
        pass
    flight.record("note", what="hello")
    exp = obs_http.ObsHTTPExporter(0, role="miner")
    try:
        port = exp.start()
        code, body, ctype = _get(port, "/debug/dump?publish=1")
        assert code == 200 and ctype == "application/json"
        bundle = json.loads(body)
        parsed = jflight.parse_bundle(body)
        assert parsed is not None and parsed["events_rejected"] == 0
        assert parsed["bundle_id"] == bundle["bundle_id"]
        assert {e["kind"] for e in parsed["events"]} >= {"config", "span",
                                                         "note"}
        assert rec.published == 1
        fetched = flight.fetch_bundle(t, "miner", "hotkey_5")
        assert fetched["bundle_id"] == bundle["bundle_id"]
    finally:
        exp.close()


# ---------------------------------------------------------------------------
# /debug/profile
# ---------------------------------------------------------------------------

def _trace_names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_debug_profile_writes_a_trace_of_other_threads(tmp_path):
    """A capture on the request's thread records the loop's programs
    (``dt.<prog>[<bucket>]``) running on another thread."""
    obs.configure(None, role="miner")
    flight.configure("miner", "hotkey_1", capacity=16)
    devprof.enable()
    prog = devprof.wrap("train.step", lambda x: (x @ x).sum(),
                        bucket="2x8")
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            prog(torch.ones(16, 16))
            time.sleep(0.002)

    worker = threading.Thread(target=loop, name="loop", daemon=True)
    worker.start()
    exp = obs_http.ObsHTTPExporter(0, role="miner",
                                   profile_dir=str(tmp_path / "traces"))
    try:
        port = exp.start()
        code, body, _ = _get(port, "/debug/profile?ms=300")
        assert code == 200, body
        info = json.loads(body)
        assert info["ms"] == 300.0 and info["trace_dir"] == str(
            tmp_path / "traces")
        assert os.path.dirname(info["trace"]) == info["trace_dir"]
        names = _trace_names(info["trace"])
        assert "dt.train.step[2x8]" in names and "aten::mm" in names
        assert obs.registry().peek("flight.profiles_captured").value == 1
        assert any(e["kind"] == "note" and e.get("what") == "debug_profile"
                   for e in flight.recorder().events())
        assert _get(port, "/debug/profile?ms=x")[0] == 400
    finally:
        stop.set()
        worker.join()
        exp.close()


def test_debug_profile_answers_409_beside_another_capture(tmp_path):
    exp = obs_http.ObsHTTPExporter(0, profile_dir=str(tmp_path / "p"))
    try:
        port = exp.start()
        first = {}

        def long_capture():
            first["got"] = _get(port, "/debug/profile?ms=2500")

        t = threading.Thread(target=long_capture)
        t.start()
        deadline = time.monotonic() + 20
        while not flight.live_profile_sessions():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, body, _ = _get(port, "/debug/profile?ms=10")
        assert code == 409 and "already running" in json.loads(body)["error"]
        with pytest.raises(RuntimeError):
            flight.capture_profile(str(tmp_path / "q"), 10)
        t.join()
        assert first["got"][0] == 200
        assert not flight.live_profile_sessions()
        # beside an active TraceCapture window: the profiler is taken
        cap = TraceCapture(str(tmp_path / "cap"), steps=1, skip=0)
        cap.tick()
        assert cap.active and live_captures() == [cap]
        code, body, _ = _get(port, "/debug/profile?ms=10")
        assert code == 409 and "TraceCapture" in json.loads(body)["error"]
        cap.tick()
        assert not cap.active and os.path.exists(cap.trace_path)
        assert _get(port, "/debug/profile?ms=10")[0] == 200
    finally:
        exp.close()


def test_trace_capture_waits_for_a_profile_session(tmp_path):
    """A TraceCapture window due while /debug/profile holds the profiler
    starts at the first tick after the capture."""
    sess = flight.ProfileSession(str(tmp_path / "p"))
    sess.start()
    try:
        cap = TraceCapture(str(tmp_path / "cap"), steps=1, skip=0)
        cap.tick()
        assert not cap.active
    finally:
        sess.stop()
    assert os.path.exists(sess.trace_path)
    cap.tick()
    assert cap.active
    cap.close()
    assert os.path.exists(cap.trace_path)
