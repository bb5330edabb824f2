"""The port's fleet health plane (engine/health.py: heartbeats, Vitals,
HeartbeatPublisher, FleetMonitor and its SLO rules) against the JAX
package, on the CPU.

- Heartbeat bodies: ``build_heartbeat`` and ``parse_heartbeat`` agree
  with JAX's on the same fields and on JAX ``tests/test_health.py``'s
  hostile riders (and more); the rider bytes each package's LocalFS
  transport writes for one body are equal.
- ``Vitals`` / ``report_vitals`` over the same report, round by round on
  one FakeClock: the same bodies (step rate, loss EMA, counters).
- ``HeartbeatPublisher``: a beat still in flight is superseded, never
  queued; ``seq`` counts every beat collected; the timer's first beat
  fires at once and ``close`` leaves no thread.
- A fleet of JAX and port miners beating into one LocalFS root, watched
  by a FleetMonitor of each package on one FakeClock schedule that trips
  every default rule: the same ledger every round, the same breaches,
  the same sink records.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

from distributedtraining_tpu.engine import health as jh
from distributedtraining_tpu.engine import ingest as jingest
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.engine.train import MinerReport as JReport
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.base import heartbeat_id as jhb_id
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu.utils.metrics import InMemorySink as JSink
from distributedtraining_tpu_torch.engine import health as th
from distributedtraining_tpu_torch.engine import ingest as tingest
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.engine.train import MinerReport
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.transport.base import (heartbeat_id,
                                                          is_heartbeat_id)
from distributedtraining_tpu_torch.utils import obs
from distributedtraining_tpu_torch.utils.metrics import InMemorySink


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _j(x) -> str:
    """A canonical spelling that compares NaN equal to NaN."""
    return json.dumps(x, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# Heartbeat bodies
# ---------------------------------------------------------------------------

def test_heartbeat_ids_and_bodies_match_jax(tmp_path):
    assert heartbeat_id("miner", "hk0") == jhb_id("miner", "hk0") \
        == "__hb__.miner.hk0"
    assert is_heartbeat_id("__hb__.averager.x")
    assert not is_heartbeat_id("hotkey_1") and not is_heartbeat_id(7)
    assert th.HEARTBEAT_FIELDS == jh.HEARTBEAT_FIELDS
    fields = dict(steps=42, step_rate=1.5, loss_ema=2.25, pushes=3,
                  pushes_failed=1, base_revision="abc123",
                  registry_digest="deadbeef0123", phase="decode",
                  kv_adopted=4, tokens_per_sec=12.5, skipped=None)
    ours = th.build_heartbeat("miner", "hk0", 7, now=123.5, **fields)
    ref = jh.build_heartbeat("miner", "hk0", 7, now=123.5, **fields)
    assert ours == ref and list(ours) == list(ref)
    # the rider bytes each package's LocalFS transport writes are equal
    LocalFSTransport(str(tmp_path / "p")).publish_delta_meta(
        heartbeat_id("miner", "hk0"), ours)
    JFS(str(tmp_path / "j")).publish_delta_meta(
        jhb_id("miner", "hk0"), ref)
    name = "deltas/__hb__.miner.hk0.meta.json"
    assert (tmp_path / "p" / name).read_bytes() \
        == (tmp_path / "j" / name).read_bytes()
    # and each package parses the other's
    got = th.parse_heartbeat(JFS(str(tmp_path / "j")).fetch_delta_meta(
        jhb_id("miner", "hk0")))
    assert got == jh.parse_heartbeat(ref) and got["seq"] == 7
    for bad in ({"Bad Name": 1.0}, {"x/y": 2.0}):
        with pytest.raises(ValueError):
            th.build_heartbeat("miner", "h", 1, now=0.0, **bad)
        with pytest.raises(ValueError):
            jh.build_heartbeat("miner", "h", 1, now=0.0, **bad)


_GOOD = {"hb": 1, "role": "miner", "hotkey": "h", "seq": 2, "t": 1.0}

# JAX tests/test_health.py's hostile riders, and more of the same
HOSTILE = [
    None, [1, 2], "hb", {"base_revision": "x"},
    {"hb": 0, "role": "m", "hotkey": "h", "seq": 1},
    {"hb": 1, "role": "m", "hotkey": "h"},
    {"hb": 1, "role": 9, "hotkey": "h", "seq": 1},
    {"hb": 1, "role": "", "hotkey": "h", "seq": 1},
    {"hb": 1, "role": "m", "hotkey": "h" * 201, "seq": 1},
    {"hb": "1", "role": "m", "hotkey": "h", "seq": 1},
    {"hb": 1, "role": "m", "hotkey": "h", "seq": "1"},
    {"hb": 1, "role": "m", "hotkey": "h", "seq": 1.7, "t": "x"},
    {**_GOOD, "BadName": 1.0, "x/y": 2.0, "steps": "not-a-number",
     "note": "x" * 500, "loss_ema": 3.5},
    {**_GOOD, "base_revision": 5, "phase": "decode", "loss_ema": "high"},
    {**_GOOD, "hb": 2.9, "pushes": True, "mem_peak_bytes": 1e12},
    {**_GOOD, **{f"extra_{i}": float(i) for i in range(40)}},
    {**_GOOD, "nested": {"a": 1}, "listy": [1, 2], "ok_num": 1},
]


@pytest.mark.parametrize("rider", HOSTILE,
                         ids=[f"rider{i}" for i in range(len(HOSTILE))])
def test_parse_heartbeat_matches_jax_on_hostile_riders(rider):
    ours = th.parse_heartbeat(rider)
    assert _j(ours) == _j(jh.parse_heartbeat(rider))
    if isinstance(rider, dict) and rider.get("loss_ema") == 3.5:
        # non-conforming fields are dropped, never raised on
        assert ours == {**_GOOD, "loss_ema": 3.5}


# ---------------------------------------------------------------------------
# Vitals
# ---------------------------------------------------------------------------

def test_report_vitals_round_by_round_matches_jax():
    clock, jclock = FakeClock(100.0), JFakeClock(100.0)
    rep, jrep = MinerReport(), JReport()
    revs = {"rev": None}
    ours = th.report_vitals(rep, base_revision=lambda: revs["rev"],
                            clock=clock)
    ref = jh.report_vitals(jrep, base_revision=lambda: revs["rev"],
                           clock=jclock)
    script = [(0, float("nan"), 0, 0, None), (50, 4.0, 1, 0, "r1"),
              (120, 3.0, 2, 1, "r1"), (120, float("inf"), 2, 3, "r2"),
              (400, 2.5, 5, 3, "r2"), (401, 2.0, 6, 3, "")]
    bodies = []
    for i, (steps, loss, pushes, failed, rev) in enumerate(script):
        for r in (rep, jrep):
            r.steps, r.last_loss = steps, loss
            r.pushes, r.pushes_failed = pushes, failed
            r.base_pulls = i
        revs["rev"] = rev
        a, b = ours.collect(), ref.collect()
        assert _j(a) == _j(b)
        bodies.append(a)
        clock.advance(10.0)
        jclock.advance(10.0)
    assert "step_rate" not in bodies[0] and bodies[1]["step_rate"] == 5.0
    # the loss EMA skips non-finite samples: 4, then 4 + 0.2 (3 - 4)
    assert bodies[3]["loss_ema"] == pytest.approx(3.8)
    assert bodies[0]["registry_digest"] == obs.registry_digest()
    # a validator's Vitals of plain suppliers, and string extras
    v = th.Vitals(steps=lambda: 3, loss=lambda: None,
                  counters=lambda: {"phase": "x" * 300, "rounds": 3,
                                    "gone": None, "bad": float("nan")},
                  clock=FakeClock(0.0))
    jv = jh.Vitals(steps=lambda: 3, loss=lambda: None,
                   counters=lambda: {"phase": "x" * 300, "rounds": 3,
                                     "gone": None, "bad": float("nan")},
                   clock=JFakeClock(0.0))
    assert _j(v.collect()) == _j(jv.collect())


# ---------------------------------------------------------------------------
# The publisher
# ---------------------------------------------------------------------------

class _Gate:
    """A rider channel whose first publish blocks until released."""

    def __init__(self, base):
        self.base = base
        self.entered = threading.Event()
        self.release = threading.Event()
        self.seqs = []

    def publish_delta_meta(self, artifact_id, meta):
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(10)
        self.seqs.append(meta["seq"])
        self.base.publish_delta_meta(artifact_id, meta)

    def fetch_delta_meta(self, artifact_id):
        return self.base.fetch_delta_meta(artifact_id)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_publisher_supersedes_a_beat_in_flight(pkg):
    mod, clock = (th, FakeClock(5.0)) if pkg == "port" \
        else (jh, JFakeClock(5.0))
    gate = _Gate(InMemoryTransport())
    pub = mod.HeartbeatPublisher(gate, "miner", "hk1", interval=60.0,
                                 clock=clock,
                                 collect=lambda: {"steps": 1.0})
    pub.beat_now(wait=False)            # seq 1: in flight, blocked
    assert gate.entered.wait(10)
    pub.beat_now(wait=False)            # seq 2: queued ...
    pub.beat_now(wait=False)            # seq 3: ... and superseded by 3
    gate.release.set()
    assert pub.flush(timeout=10)
    assert gate.seqs == [1, 3] and pub.seq == 3 and pub.sent == 2
    assert pub._worker.jobs_superseded == 1 and pub.failed == 0
    got = th.parse_heartbeat(gate.fetch_delta_meta(
        heartbeat_id("miner", "hk1")))
    assert got["seq"] == 3 and got["t"] == 5.0 and got["steps"] == 1.0
    pub.close()
    with pytest.raises(ValueError):
        mod.HeartbeatPublisher(gate, "miner", "hk1", interval=0)


def test_publisher_timer_beats_at_once_and_closes_clean():
    t = InMemoryTransport()
    pub = th.HeartbeatPublisher(t, "miner", "hk2", interval=60.0).start()
    assert pub.start() is pub   # idempotent
    assert pub.flush(timeout=10)
    for _ in range(200):
        if pub.sent:
            break
        threading.Event().wait(0.01)
    assert pub.sent == 1 and pub.seq == 1
    pub.close()
    names = {th_.name for th_ in threading.enumerate()}
    assert "heartbeat-miner-hk2" not in names
    assert "heartbeat-upload-hk2" not in names

    class NoChannel:
        pass

    quiet = th.HeartbeatPublisher(NoChannel(), "miner", "hk3", interval=1)
    quiet.beat_now()            # no rider channel: disabled, not raised
    assert quiet.sent == 0 and quiet.failed == 0
    quiet.close()

    class Broken(InMemoryTransport):
        def publish_delta_meta(self, artifact_id, meta):
            raise OSError("down")

    broken = th.HeartbeatPublisher(Broken(), "miner", "hk4", interval=1)
    broken.beat_now()           # counted, never raised
    assert broken.failed == 1 and broken.sent == 0
    broken.close()


# ---------------------------------------------------------------------------
# A mixed fleet under one FleetMonitor of each package
# ---------------------------------------------------------------------------

MINERS = ("m0", "m1", "m2", "m3", "m4")
ROUNDS = 9


def _state(hk: str, r: int) -> dict | None:
    """Miner ``hk``'s state at round ``r`` (None: it no longer beats).
    m0 diverges in loss, m1 fails pushes, m2 dies after round 2, m3's
    step rate collapses, m4 is healthy."""
    if hk == "m2" and r > 2:
        return None
    steps = 100 * r if hk != "m3" or r <= 3 else 300 + (r - 3)
    loss = 10.0 if hk == "m0" else 2.0 + 0.01 * MINERS.index(hk)
    failed = max(0, r - 1) if hk == "m1" else 0
    return {"steps": steps, "loss": loss, "pushes": r if hk != "m1" else 1,
            "failed": failed}


def _staged(mod, r: int) -> list:
    out = []
    for hk in MINERS:
        st = _state(hk, r)
        if hk == "m2" and st is None:
            out.append(mod.StagedDelta(hk, None, "no_delta", None, None))
        elif hk == "m0":
            out.append(mod.StagedDelta(hk, None, "screen_magnitude",
                                       f"rev{r}", None, wire_bytes=10))
        else:
            out.append(mod.StagedDelta(hk, {"w": 1}, "ok",
                                       f"rev{r // 2}", f"{hk}-{r}",
                                       wire_bytes=100 * r))
    return out


def test_mixed_fleet_monitors_agree_on_ledger_and_breaches(tmp_path):
    root = str(tmp_path / "artifacts")
    pt, jt = LocalFSTransport(root), JFS(root)
    clock, jclock = FakeClock(1000.0), JFakeClock(1000.0)
    states = {hk: _state(hk, 1) for hk in MINERS}
    pubs = {}
    for hk in MINERS:
        # m0, m2 and m4 beat through the JAX package, m1, m3 the port's
        jax_side = hk in ("m0", "m2", "m4")
        mod, tr, ck = (jh, jt, jclock) if jax_side else (th, pt, clock)

        def sup(key, hk=hk):
            return lambda: states[hk][key]
        vit = mod.Vitals(steps=sup("steps"), loss=sup("loss"),
                         counters=lambda hk=hk: {
                             "pushes": states[hk]["pushes"],
                             "pushes_failed": states[hk]["failed"]},
                         clock=ck)
        pubs[hk] = mod.HeartbeatPublisher(tr, "miner", hk, interval=60.0,
                                          vitals=vit, clock=ck)
    sink, jsink = InMemorySink(), JSink()
    ours = th.FleetMonitor(pt, metrics=sink, clock=clock)
    ref = jh.FleetMonitor(jt, metrics=jsink, clock=jclock)
    fired, jfired = [], []
    try:
        for r in range(1, ROUNDS + 1):
            for hk in MINERS:
                st = _state(hk, r)
                if st is not None:
                    states[hk] = st
                    pubs[hk].beat_now(wait=True)
            assert ours.poll(MINERS) == ref.poll(MINERS)
            ours.record_staging(_staged(tingest, r))
            ref.record_staging(_staged(jingest, r))
            scores = {hk: 0.1 * i * r for i, hk in enumerate(MINERS)}
            scores["hotkey_99"] = 0.0   # never seen: no ledger row
            ours.record_scores(scores)
            ref.record_scores(scores)
            ours.record_credit({"m4": 0.5 * r, "zz": 0.0})
            ref.record_credit({"m4": 0.5 * r, "zz": 0.0})
            b, jb = ours.evaluate_slos(), ref.evaluate_slos()
            assert _j(b) == _j(jb)
            fired += b
            jfired += jb
            assert _j(ours.flush(step=r)) == _j(ref.flush(step=r))
            assert ours.fleet_median_loss() == ref.fleet_median_loss()
            clock.advance(30.0)
            jclock.advance(30.0)
        # every default rule fired, on the node the script made breach
        got = {(b["slo_breach"], b["hotkey"]) for b in fired}
        assert got == {("loss_divergence", "m0"),
                       ("push_failure_streak", "m1"),
                       ("stale_node", "m2"),
                       ("step_rate_collapse", "m3")}
        assert {b["slo_breach"] for b in fired} == {
            r.name for r in th.default_slo_rules()}
        # the re-arm of a breach (remediation's re-admission) agrees
        ours.clear_fired("miner", "m0", "loss_divergence")
        ref.clear_fired("miner", "m0", "loss_divergence")
        assert _j(ours.ledger()) == _j(ref.ledger())
        assert _j(ours.evaluate_slos()) == _j(ref.evaluate_slos())
        # the sink records (heartbeats, breaches, ledgers) are the same
        assert _j(sink.records) == _j(jsink.records)
        kinds = {next(k for k in ("heartbeat", "slo_breach",
                                  "fleet_ledger") if k in rec)
                 for rec in sink.records}
        assert kinds == {"heartbeat", "slo_breach", "fleet_ledger"}
        # a node that left the registry is pruned by both
        assert ours.poll(MINERS[1:]) == ref.poll(MINERS[1:])
        assert _j(ours.ledger()) == _j(ref.ledger())
        assert "miner/m0" not in ours.ledger()
    finally:
        for p in pubs.values():
            p.close()
        ours.close()
        ref.close()


def test_slo_rules_match_jax_on_node_grids():
    assert [dataclasses.astuple(r) for r in th.default_slo_rules()] \
        == [dataclasses.astuple(r) for r in jh.default_slo_rules()]
    with pytest.raises(ValueError):
        th.SLORule("x", "nope", threshold=1)
    rng = np.random.default_rng(0)
    for _ in range(200):
        kw = dict(beats=int(rng.integers(0, 5)),
                  last_seen_round=int(rng.integers(0, 8)),
                  step_rate=float(rng.uniform(0, 10)),
                  peak_step_rate=float(rng.uniform(0, 20)),
                  loss_ema=float(rng.choice([rng.uniform(1, 8), np.nan])),
                  push_fail_streak=float(rng.integers(0, 5)))
        node = th.NodeHealth(role="miner", hotkey="h", **kw)
        jnode = jh.NodeHealth(role="miner", hotkey="h", **kw)
        median = float(rng.choice([rng.uniform(1, 4), -1.0]))
        median = None if median < 0 else median
        for rule, jrule in zip(th.default_slo_rules(),
                               jh.default_slo_rules()):
            assert rule.evaluate(node, round_num=9,
                                 fleet_median_loss=median) \
                == jrule.evaluate(jnode, round_num=9,
                                  fleet_median_loss=median)


# ---------------------------------------------------------------------------
# The roles' heartbeats
# ---------------------------------------------------------------------------

def test_miner_cli_beats_and_writes_jsonl(tmp_path, monkeypatch):
    """The miner CLI with ``--heartbeat-interval`` and ``--metrics-path``
    on the CPU: the loop starts the beat, sends a last beat with its
    exit-state counters at flush, and leaves no heartbeat thread; the
    JSONL holds the loss records, the spans and the registry flushes,
    and a JAX FleetMonitor reads the port's beat."""
    import logging
    from distributedtraining_tpu_torch.neurons import miner as tminer
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work, jsonl = tmp_path / "run", tmp_path / "m.jsonl"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tminer.main([
            "--backend", "local", "--model", "tiny", "--dataset",
            "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
            "--checkpoint-interval", "0", "--no-anomaly-trace",
            "--flight-events", "0", "--work-dir", str(work),
            "--hotkey", "hotkey_3", "--max-steps", "3", "--seq-len", "32",
            "--batch-size", "2", "--log-every", "1",
            "--heartbeat-interval", "30", "--metrics-path", str(jsonl),
            "--metrics-rotate-mb", "1"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    assert not [t for t in threading.enumerate()
                if t.name.startswith("heartbeat")]
    hb = th.parse_heartbeat(LocalFSTransport(str(work / "artifacts"))
                            .fetch_delta_meta(heartbeat_id("miner",
                                                           "hotkey_3")))
    # the timer's first beat at start, the last one at flush
    assert hb["seq"] == 2 and hb["steps"] == 3.0 and hb["pushes"] == 1.0
    # no base was published: the miner trains from its genesis, which
    # names no revision
    assert np.isfinite(hb["loss_ema"]) and "base_revision" not in hb
    fleet = jh.FleetMonitor(JFS(str(work / "artifacts")),
                            clock=JFakeClock(0.0))
    try:
        assert fleet.poll(["hotkey_3"]) == 1
        assert fleet.ledger()["miner/hotkey_3"]["steps"] == 3.0
    finally:
        fleet.close()
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3]
    assert {"span", "obs_registry"} <= {k for r in recs for k in r}
    assert any(r.get("span") == "push.snapshot" or
               str(r.get("span", "")).startswith("publish")
               for r in recs)
    assert all(r.get("obs_registry") in (None, "miner") for r in recs)


def test_server_heartbeat_counters():
    """The serving worker's heartbeat extras: the always-on counters,
    and the prefix, speculative, latency and disaggregation fields only
    once they have something to say."""
    import types

    from distributedtraining_tpu_torch.engine.serve import \
        heartbeat_counters
    eng = types.SimpleNamespace(
        tokens_per_sec=12.5, queue_depth=2, tokens_emitted=40,
        shed_count=1, prefix_hits=0, prefix_misses=0, prefix_hit_rate=0.0,
        speculative=False, spec_rounds=0, spec_accept_rate=0.0,
        phase="unified", kv_exported=0, kv_adopted=0)
    assert heartbeat_counters(eng) == {"tokens_per_sec": 12.5,
                                       "queue_depth": 2.0, "tokens": 40.0,
                                       "shed": 1.0}
    obs.configure()
    for v in (10.0, 20.0, 30.0):
        obs.observe("serve.ttft_ms", v)

    class Burn:
        def max_burn(self):
            return 0.5
    eng.prefix_hits, eng.prefix_misses, eng.prefix_hit_rate = 3, 1, 0.75
    eng.speculative, eng.spec_rounds, eng.spec_accept_rate = True, 4, 0.6
    eng.phase, eng.kv_exported = "prefill", 7
    out = heartbeat_counters(eng, Burn())
    assert out["prefix_hit_rate"] == 0.75 and out["spec_accept_rate"] == 0.6
    assert out["ttft_ms_p95"] > 20.0 and "tpot_ms_p95" not in out
    assert out["slo_burn"] == 0.5 and out["phase"] == "prefill"
    assert out["kv_exported"] == 7.0 and out["kv_adopted"] == 0.0
    body = th.build_heartbeat("server", "s0", 1, now=0.0, **out)
    assert th.parse_heartbeat(body)["phase"] == "prefill"
