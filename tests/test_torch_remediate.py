"""The port's failover plane (engine/remediate.py parse_lease,
LeaseManager and StandbyAverager; the averager loop's lease calls; the
averager's ``--standby``) against the JAX package, on the CPU.

- Lease tokens: the rider bytes each package writes for the same acquire,
  renew and stamp on a FakeClock are equal, and ``parse_lease`` agrees
  on good and hostile tokens.
- The protocol: acquire, renew, supersede and re-acquire past the
  observed epoch; a renew that cannot read the token stands down; a JAX
  and a port manager supersede each other on one store.
- The standby on a FakeClock: it follows a renewing primary, read faults
  are no evidence (they do not reset the stall clock), and after the
  deadline it takes the lease at epoch + 1 and bootstraps from the
  current base (no genesis publish).
- A JAX primary with a port standby on one root: the port takes over,
  publishes under the next epoch, and the JAX primary's next round
  stands down.
- The CLI with ``--standby --failover-deadline`` under
  ``DT_FORCE_PLATFORM=cpu``.

f32 tiny GPT-2; weights and deltas from numpy with a seed.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import remediate as jrem
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.base import lease_id as jlease_id
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import remediate as rem
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import averager as tcli
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.transport.base import lease_id

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lease_bytes(root, role="averager"):
    with open(os.path.join(root, "deltas",
                           f"{lease_id(role)}.meta.json"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("role", ["averager", "subavg.n0"])
def test_lease_tokens_equal_jax(tmp_path, role):
    assert lease_id(role) == jlease_id(role)
    roots = {}
    for side in ("port", "jax"):
        root = str(tmp_path / side)
        if side == "port":
            t, clock = LocalFSTransport(root), FakeClock(1000.0)
            mk = lambda h: rem.LeaseManager(t, h, role=role, clock=clock)
        else:
            t, clock = JFS(root), JFakeClock(1000.0)
            mk = lambda h: jrem.LeaseManager(t, h, role=role, clock=clock)
        a, b = mk("avg0"), mk("avg1")
        steps = []
        assert a.acquire()
        steps.append(_lease_bytes(root, role))
        clock.advance(5.0)
        assert a.renew()
        steps.append(_lease_bytes(root, role))
        a.stamp("rev-1")
        steps.append(_lease_bytes(root, role))
        clock.advance(5.0)
        assert b.acquire() and not a.renew()
        steps.append(_lease_bytes(root, role))
        roots[side] = steps
    assert roots["port"] == roots["jax"]
    for token in (None, {}, {"epoch": 1}, {"lease": 1, "epoch": 0,
                                            "holder": "x"},
                  {"lease": 1, "epoch": 2, "holder": ""},
                  {"lease": True, "epoch": 2.7, "holder": "h", "t": "x"},
                  {"lease": 1, "epoch": 2, "holder": "h" * 201},
                  {"lease": 1, "epoch": 2, "holder": "h", "t": 5,
                   "base_revision": 9},
                  {"lease": 1, "epoch": 3, "holder": "h", "t": 5.5,
                   "base_revision": "r"}):
        assert rem.parse_lease(token) == jrem.parse_lease(token)


def test_lease_acquire_renew_supersede_across_packages(tmp_path):
    t = InMemoryTransport()
    a, b = rem.LeaseManager(t, "avg0"), rem.LeaseManager(t, "avg1")
    assert not a.holds()
    assert a.acquire() and a.epoch == 1
    assert a.renew() is True
    assert b.acquire() and b.epoch == 2
    assert a.renew() is False and not a.holds()
    assert b.renew() is True
    b.stamp("rev-42")
    cur = rem.parse_lease(t.fetch_delta_meta(lease_id()))
    assert (cur["epoch"], cur["holder"], cur["base_revision"]) == \
        (2, "avg1", "rev-42")
    assert a.acquire() and a.epoch == 3
    # a lazy first renew acquires; a vanished token is reclaimed past seen
    c = rem.LeaseManager(InMemoryTransport(), "avg2")
    assert c.renew() and c.epoch == 1

    class Flaky(InMemoryTransport):
        broken = False

        def fetch_delta_meta(self, miner_id):
            if self.broken:
                raise OSError("partitioned")
            return super().fetch_delta_meta(miner_id)

    f = Flaky()
    d = rem.LeaseManager(f, "avg0")
    assert d.acquire()
    f.broken = True
    assert d.renew() is False          # cannot confirm: no publish
    f.broken = False
    assert d.renew() is True
    # one LocalFS root, both packages
    root = str(tmp_path / "shared")
    port = rem.LeaseManager(LocalFSTransport(root), "port_avg")
    ref = jrem.LeaseManager(JFS(root), "jax_avg")
    assert port.acquire() and port.epoch == 1
    assert ref.acquire() and ref.epoch == 2
    assert not port.renew()
    assert port.acquire() and port.epoch == 3 and not ref.renew()


class _Loop:
    """The standby's view of a loop: a transport and a bootstrap."""

    def __init__(self, t):
        self.transport = t
        self.boots = 0

    def bootstrap(self):
        self.boots += 1


def test_standby_follows_then_takes_over_and_ignores_read_faults():
    class Flaky(InMemoryTransport):
        broken = False

        def fetch_delta_meta(self, miner_id):
            if self.broken:
                raise OSError("flap")
            return super().fetch_delta_meta(miner_id)

        def base_revision(self):
            if self.broken:
                raise OSError("flap")
            return super().base_revision()

    clock = FakeClock(0.0)
    t = Flaky()
    t.publish_base({"w": np.zeros(2, np.float32)})
    primary = rem.LeaseManager(t, "primary", clock=clock)
    assert primary.acquire()
    loop = _Loop(t)
    standby_lease = rem.LeaseManager(t, "standby", clock=clock)
    standby = rem.StandbyAverager(loop, standby_lease, deadline_s=100.0,
                                  poll_s=10.0, clock=clock)
    assert standby.poll_once() == "following"
    for _ in range(3):           # a renewing primary keeps it passive
        clock.advance(90.0)
        assert primary.renew()
        assert standby.poll_once() == "following"
    assert standby.stalled_for() == 0.0
    # the primary stops; the transport flaps meanwhile
    clock.advance(60.0)
    t.broken = True
    assert standby.poll_once() == "following"
    clock.advance(60.0)
    t.broken = False
    rev = t.base_revision()
    assert standby.poll_once() == "takeover"
    assert standby.active and standby_lease.epoch == 2 and loop.boots == 1
    assert standby.poll_once() == "active"
    assert t.base_revision() == rev             # no genesis publish
    assert not primary.renew()                  # the old primary stands down
    with pytest.raises(ValueError):
        rem.StandbyAverager(loop, standby_lease, deadline_s=0)


@pytest.fixture(scope="module")
def world():
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    return {"base": tg.init_params_numpy(TINY, 0), "val": val,
            "teng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _delta(seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale
                   ).astype(np.float32), tg.init_params_numpy(TINY, 0))


def test_jax_primary_port_standby(world, tmp_path):
    root, chain_dir = str(tmp_path / "artifacts"), str(tmp_path / "chain")
    jt = JFS(root)
    jclock, clock = JFakeClock(0.0), FakeClock(0.0)
    jlease = jrem.LeaseManager(jt, "hotkey_95", clock=jclock)
    primary = JLoop(world["jeng"], jt, JChain(chain_dir,
                                              my_hotkey="hotkey_95"),
                    JWA(), val_batches=lambda: iter(world["val"]),
                    publish_policy="always", lease=jlease)
    assert jlease.acquire()
    primary.bootstrap(params=jax.tree_util.tree_map(jnp.asarray,
                                                    world["base"]))
    jt.publish_delta("hotkey_1", _delta(1))
    assert primary.run_round() and primary.report.skipped_publishes == 0
    t = LocalFSTransport(root)
    lease = rem.LeaseManager(t, "hotkey_96", clock=clock)
    loop = tavg.AveragerLoop(
        world["teng"], t, LocalChain(chain_dir, my_hotkey="hotkey_96"),
        tavg.WeightedAverage(), val_batches=lambda: iter(world["val"]),
        publish_policy="always", lease=lease)
    standby = rem.StandbyAverager(loop, lease, deadline_s=50.0, poll_s=10.0,
                                  clock=clock)
    assert standby.poll_once() == "following"
    clock.advance(40.0)
    jt.publish_delta("hotkey_1", _delta(2))
    assert primary.run_round()        # a publish moves the base and lease
    assert standby.poll_once() == "following"
    rev = jt.base_revision()
    clock.advance(60.0)               # the primary goes quiet
    assert standby.poll_once() == "takeover"
    assert lease.epoch == jlease.seen + 1 == 2
    assert loop._base_revision == rev           # bootstrapped, no genesis
    jt.publish_delta("hotkey_1", _delta(3))
    assert loop.run_round() and loop.report.skipped_publishes == 0
    loop.close()
    token = rem.parse_lease(t.fetch_delta_meta(lease_id()))
    assert token["holder"] == "hotkey_96" and token["epoch"] == 2
    assert token["base_revision"] == t.base_revision() != rev
    # the deposed JAX primary merges but stands down at its publish
    jt.publish_delta("hotkey_1", _delta(4))
    before = jt.base_revision()
    assert primary.run_round()
    assert primary.report.skipped_publishes == 1
    assert jt.base_revision() == before
    primary.close()


def test_standby_cli_takes_over_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    common = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
              "--no-lineage", "--flight-events", "0", "--batch-size", "2",
              "--eval-batches", "2", "--eval-seq-len", "32",
              "--work-dir", work]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        # the primary's genesis and one miner
        assert tcli.main(common + ["--rounds", "1", "--strategy",
                                   "weighted", "--hotkey", "hotkey_95"]) == 1
        assert tminer.main(common + [
            "--checkpoint-interval", "0", "--no-anomaly-trace",
            "--hotkey", "hotkey_3", "--max-steps", "2",
            "--seq-len", "32"]) == 0
        t = LocalFSTransport(f"{work}/artifacts")
        rev = t.base_revision()
        # the standby: 1 s polls, 2 s deadline, then one round
        assert tcli.main(common + [
            "--standby", "--failover-deadline", "2",
            "--averaging-interval", "4", "--rounds", "1", "--strategy",
            "weighted", "--publish-policy", "always",
            "--hotkey", "hotkey_96"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    token = rem.parse_lease(t.fetch_delta_meta(lease_id()))
    assert token["holder"] == "hotkey_96" and token["epoch"] == 1
    assert t.base_revision() not in (None, rev)
    assert token["base_revision"] == t.base_revision()


# ---------------------------------------------------------------------------
# Quarantine and elastic cohorts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("configured", [0, 1, 2, 4, 8, 16, 24])
def test_elastic_cohort_grid_matches_jax(configured):
    for healthy in range(0, 26):
        for compiled in ((), (4,), (2, 16), (1, 8, 32), (5, 6)):
            assert rem.elastic_cohort(configured, healthy,
                                      compiled=compiled) \
                == jrem.elastic_cohort(configured, healthy,
                                       compiled=compiled)


def _breach(rule, hotkey, rnd, role="miner"):
    return {"slo_breach": rule, "role": role, "hotkey": hotkey,
            "detail": f"{rule} on {hotkey}", "round": rnd}


def test_remediation_engine_matches_jax_on_one_breach_script():
    """Quarantine, clean beats, probation, healthy, a relapse and a
    pruned node, driven the same way through each package's engine over
    its own FleetMonitor."""
    from distributedtraining_tpu.engine import health as jh
    from distributedtraining_tpu_torch.engine import health as th
    from distributedtraining_tpu_torch.utils.metrics import InMemorySink
    from distributedtraining_tpu.utils.metrics import InMemorySink as JSink
    sides = {}
    for side, h, r, sink in (("port", th, rem, InMemorySink()),
                             ("jax", jh, jrem, JSink())):
        fleet = h.FleetMonitor(InMemoryTransport(), metrics=sink)
        policy = r.RemediationPolicy(probation_beats=2, probation_rounds=1,
                                     score_decay=0.5)
        sides[side] = (fleet, r.RemediationEngine(fleet, policy=policy,
                                                  metrics=sink), sink)
    # round: (breaches, {hotkey: fresh beats this round}, scores)
    script = [
        ([], {"m1": 1, "m2": 1, "m3": 1}, {"m1": 1.0, "m2": 2.0}),
        ([_breach("stale_node", "m1", 2),
          _breach("step_rate_collapse", "m2", 2),     # not a policy rule
          _breach("loss_divergence", "m3", 2, role="validator")],
         {"m2": 1, "m3": 1}, {"m1": 1.0, "m2": 2.0}),
        ([_breach("stale_node", "m1", 3)], {}, {"m1": 4.0, "m3": 0.0}),
        ([], {"m1": 1}, {"m1": 4.0}),
        ([], {"m1": 1}, {"m1": 4.0}),     # 2 clean beats: probation
        ([], {}, {"m1": 4.0}),            # probation over: healthy
        ([_breach("push_failure_streak", "m1", 7)], {"m1": 1},
         {"m1": 8.0}),                    # relapse: requarantined
        ([], {"m1": 1}, {"m1": 8.0}),
    ]
    logs = {"port": [], "jax": []}
    for i, (breaches, beats, scores) in enumerate(script):
        for side, (fleet, eng, _) in sides.items():
            fleet.round += 1
            for hk, n in beats.items():
                node = fleet.node("miner", hk)
                node.beats += n
                node.last_seen_round = fleet.round
            if i == 7:   # m3 left the registry: its case closes
                fleet.nodes.pop(("miner", "m3"), None)
            acts = eng.observe_round(breaches)
            logs[side].append((
                [{k: a[k] for k in ("remediation", "hotkey", "rule",
                                    "round")} for a in acts],
                sorted(eng.quarantined()), eng.decay_scores(scores),
                [eng.is_excluded(h) for h in ("m1", "m2", "m3")],
                eng.filter_hotkeys(["m3", "m1", "m2"]),
                eng.quarantines, eng.readmissions,
                {k[1]: (n.quarantined, n.probation)
                 for k, n in sorted(fleet.nodes.items())}))
    assert logs["port"] == logs["jax"]
    actions = [a["remediation"] for acts, *_ in logs["port"] for a in acts]
    assert actions == ["quarantined", "readmitted", "healthy",
                       "requarantined"]
    assert logs["port"][2][2] == {"m1": 2.0, "m3": 0.0}   # decayed
    assert [r for r in sides["port"][2].records if "remediation" in r] \
        and len(sides["port"][2].records) == len(sides["jax"][2].records)
    for bad in (dict(probation_beats=0), dict(probation_rounds=-1),
                dict(score_decay=1.5)):
        with pytest.raises(ValueError):
            rem.RemediationPolicy(**bad)
    for fleet, *_ in sides.values():
        fleet.close()


def test_port_standby_follows_a_jax_primary_heartbeat(tmp_path):
    """A JAX primary that holds the lease but never renews it: only its
    ``__hb__.averager.<holder>`` heartbeat advances, and that keeps a
    port standby following well past its deadline; once the beats stop
    it takes the next epoch within the deadline plus one poll."""
    from distributedtraining_tpu.engine import health as jh
    root = str(tmp_path / "artifacts")
    jt, t = JFS(root), LocalFSTransport(root)
    jclock, clock = JFakeClock(0.0), FakeClock(0.0)
    jt.publish_base({"w": np.zeros(2, np.float32)})
    jlease = jrem.LeaseManager(jt, "hotkey_95", clock=jclock)
    assert jlease.acquire()
    beats = jh.HeartbeatPublisher(jt, "averager", "hotkey_95", interval=60,
                                  clock=jclock,
                                  collect=lambda: {"rounds": 1.0})
    lease = rem.LeaseManager(t, "hotkey_96", clock=clock)
    loop = _Loop(t)
    standby = rem.StandbyAverager(loop, lease, deadline_s=30.0, poll_s=5.0,
                                  clock=clock)
    try:
        beats.beat_now()
        assert standby.poll_once() == "following"
        for _ in range(12):            # 60 s of beats: past the deadline
            clock.advance(5.0)
            jclock.advance(5.0)
            beats.beat_now()
            assert standby.poll_once() == "following"
            assert standby.stalled_for() == 0.0
        last_beat = clock.now()
        polls = 0
        while standby.poll_once() != "takeover":
            clock.advance(5.0)
            polls += 1
            assert polls < 20
        assert last_beat + 30.0 <= clock.now() <= last_beat + 30.0 + 5.0
        assert lease.epoch == 2 and loop.boots == 1
        assert not jlease.renew()      # the JAX primary stands down
    finally:
        beats.close()
