"""The port's fault injection (transport/chaos.py) and chain-call deadline
(utils/timeout.py) against the JAX package, on the CPU.

- ``ChaosSpec`` parses and refuses as JAX's; the same spec, seed,
  schedule and call sequence through each package's ChaosTransport over
  its in-memory transport give the same operation count, the same faults
  on the same calls with the same messages, the same sleeps, the same
  results of the calls that pass, and the same ``chaos.*`` counters.
- ``--chaos-spec`` through the role CLIs on the CPU at the tiny preset:
  two dense miners (``hotkey_2`` partitioned) and a validator round with
  one ingest worker, every role exiting 0; the verdicts, the miners
  scored above 0 and every process's ``chaos.*`` counters are the
  ``CHAOS_ROUND`` outcome, which ``chip_smoke.py`` phase 31(c) holds the
  card's run to (the fault sequence is a function of the seed and of the
  transport calls, which do not depend on the model's size).
- ``run_with_timeout`` returns, raises and abandons as JAX's does, with
  the same accounting; ``device_metrics()`` carries JAX's keys, the
  abandoned-worker pair included, in JAX's order.
"""

import json
import logging
import threading
import time

import numpy as np
import pytest

from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.transport import chaos as jchaos
from distributedtraining_tpu.utils import metrics as jmetrics
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu.utils import timeout as jtimeout
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.transport import chaos
from distributedtraining_tpu_torch.utils import devprof, metrics, obs
from distributedtraining_tpu_torch.utils import timeout

# the phase 31(c) chaos round (chip_smoke.py holds the card to it)
CHAOS_SPEC = {"seed": 3, "fetch_error_rate": 0.2,
              "partitioned": ["hotkey_2"]}
CHAOS_ROUND = {
    "verdicts": {"hotkey_1": "ok", "hotkey_2": "fetch_error"},
    "positive": ["hotkey_1"],
    "chaos": {"hotkey_1": {},
              "hotkey_2": {"chaos.faults": 3.0,
                           "chaos.partition_faults": 3.0},
              "validator": {"chaos.faults": 28.0,
                            "chaos.fetch_faults": 23.0,
                            "chaos.partition_faults": 5.0}},
}


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jobs, devprof):
        m.reset()
    yield
    for m in (obs, jobs, devprof):
        m.reset()


# ---------------------------------------------------------------------------
# The fault model against JAX's
# ---------------------------------------------------------------------------

def test_spec_parses_and_refuses_as_jax():
    text = json.dumps({"publish_error_rate": 0.5, "partitioned": ["a"],
                       "killed_roles": ["miner"], "seed": 9,
                       "latency_s": 0.1, "latency_jitter": 0.5})
    ours = chaos.ChaosSpec.from_json(text)
    assert ours.partitioned == ("a",) and ours.killed_roles == ("miner",)
    assert vars(ours) == vars(jchaos.ChaosSpec.from_json(text))
    for bad in ('{"fetch_error_rat": 0.1}', "[1]",
                '{"fetch_error_rate": 1.5}', '{"latency_s": -1}',
                '{"latency_jitter": 2}'):
        with pytest.raises(ValueError):
            jchaos.ChaosSpec.from_json(bad)
        with pytest.raises(ValueError):
            chaos.ChaosSpec.from_json(bad)
    with pytest.raises(ValueError, match="unknown chaos action"):
        chaos.ChaosEvent(1, "explode", "x")
    assert issubclass(chaos.ChaosError, OSError)


def _script(t) -> list:
    """Every faultable operation of the surface, several rounds, as
    (name, callable) pairs."""
    calls = []
    for r in range(6):
        for hk in ("hk0", "hk1", "hk2"):
            data = f"{hk}-{r}".encode()
            calls += [
                ("publish_raw", lambda hk=hk, d=data:
                 t.publish_raw(hk, d)),
                ("publish_delta_raw", lambda hk=hk, d=data:
                 t.publish_delta_raw(hk, d)),
                ("publish_delta_meta", lambda hk=hk, r=r:
                 t.publish_delta_meta(hk, {"delta_id": f"{hk}-{r}"})),
                ("publish_shard", lambda hk=hk, d=data:
                 t.publish_shard(hk, "h_0/attn", d)),
                ("fetch_shard", lambda hk=hk:
                 t.fetch_shard(hk, "h_0/attn")),
                ("delta_revision", lambda hk=hk: t.delta_revision(hk)),
                ("fetch_delta_bytes", lambda hk=hk:
                 t.fetch_delta_bytes(hk)),
                ("fetch_delta_meta", lambda hk=hk: t.fetch_delta_meta(hk)),
            ]
        calls += [
            ("publish_base_raw", lambda r=r:
             t.publish_base_raw(f"base-{r}".encode())),
            ("fetch_base_bytes", lambda: t.fetch_base_bytes()),
            ("base_revision", lambda: t.base_revision()),
            ("publish_base_shard", lambda r=r:
             t.publish_base_shard("wte", f"s{r}".encode())),
            ("fetch_base_shard", lambda: t.fetch_base_shard("wte")),
            ("publish_base_manifest", lambda r=r:
             t.publish_base_manifest(f"rev{r}", b"{}")),
            ("fetch_base_manifest", lambda r=r:
             t.fetch_base_manifest(f"rev{r}")),
        ]
    return calls


def _run(mod, inner, o, spec, role):
    sleeps = []
    t = mod.ChaosTransport(
        inner, spec, role=role, sleep=sleeps.append,
        schedule=[mod.ChaosEvent(7, "partition", "hk1"),
                  mod.ChaosEvent(30, "heal", "hk1"),
                  mod.ChaosEvent(52, "kill_role", "miner"),
                  mod.ChaosEvent(60, "revive_role", "miner"),
                  mod.ChaosEvent(75, "heal", "hk2")])
    o.configure(object())
    out = []
    for name, call in _script(t):
        try:
            got = call()
            out.append((name, "ok", None if got is None else
                        type(got).__name__))
        except mod.ChaosError as e:
            out.append((name, "fault", str(e)))
    t.gc()
    counters = {k: v for k, v in o.registry().snapshot().items()
                if k.startswith("chaos.")}
    return out, t.ops, t.faults, sleeps, counters, sorted(t.partitioned())


@pytest.mark.parametrize("role,spec", [
    ("miner", dict(publish_error_rate=0.3, fetch_error_rate=0.25,
                   latency_s=0.01, latency_jitter=0.5,
                   partitioned=("hk2",), seed=11)),
    ("validator", dict(fetch_error_rate=0.2, partitioned=("hk0",),
                       seed=3)),
    ("averager", dict(killed_roles=("averager",), seed=5)),
])
def test_fault_sequence_equals_jax(role, spec):
    ours = _run(chaos, InMemoryTransport(), obs, chaos.ChaosSpec(**spec),
                role)
    theirs = _run(jchaos, JMem(), jobs, jchaos.ChaosSpec(**spec), role)
    assert ours == theirs
    calls, ops, faults = ours[:3]
    assert ops == len(calls) and faults == sum(
        1 for c in calls if c[1] == "fault") > 0
    assert ours[4]["chaos.faults"] == faults


def test_chaos_transport_draws_once_per_gate_across_threads():
    """The rate stream stays aligned under concurrent callers: the
    faults over N operations do not depend on which thread made them."""
    def faults(n_threads):
        t = chaos.ChaosTransport(InMemoryTransport(), chaos.ChaosSpec(
            fetch_error_rate=0.5, seed=1))
        per = 200 // n_threads

        def work():
            for _ in range(per):
                try:
                    t.fetch_delta_bytes("x")
                except chaos.ChaosError:
                    pass
        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for th_ in ths:
            th_.start()
        for th_ in ths:
            th_.join()
        return t.ops, t.faults
    assert faults(1) == faults(4)


# ---------------------------------------------------------------------------
# --chaos-spec through the role CLIs
# ---------------------------------------------------------------------------

def _registry(path) -> dict:
    recs = [json.loads(line) for line in open(path)]
    regs = [r for r in recs if "obs_registry" in r]
    return {k: v for k, v in (regs[-1] if regs else {}).items()
            if k.startswith("chaos.")}


def test_chaos_round_through_the_clis(tmp_path, monkeypatch):
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.neurons import miner, validator
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = tmp_path / "w"
    LocalFSTransport(str(work / "artifacts")).publish_base(
        gpt2.init_params_numpy(gpt2.PRESETS["tiny"], 0))
    common = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
              "--flight-events", "0", "--work-dir", str(work),
              "--batch-size", "2", "--eval-batches", "2",
              "--eval-seq-len", "32", "--chaos-spec",
              json.dumps(CHAOS_SPEC)]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        for hk in ("hotkey_1", "hotkey_2"):
            assert miner.main(common + [
                "--hotkey", hk, "--max-steps", "3", "--seq-len", "32",
                "--checkpoint-interval", "0", "--no-anomaly-trace",
                "--send-interval", "1e9", "--check-update-interval", "1e9",
                "--self-eval-interval", "0",
                "--metrics-path", str(tmp_path / f"{hk}.jsonl")]) == 0
        assert validator.main(common + [
            "--hotkey", "hotkey_91", "--rounds", "1", "--ingest-workers",
            "1", "--metrics-path", str(tmp_path / "validator.jsonl")]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    recs = [json.loads(line) for line in open(tmp_path / "validator.jsonl")]
    (rnd,) = [r for r in recs if "round_scores" in r]
    scores = rnd["round_scores"]
    assert {hk: scores[hk]["reason"] for hk in CHAOS_ROUND["verdicts"]} \
        == CHAOS_ROUND["verdicts"]
    assert sorted(hk for hk, s in scores.items() if s["score"] > 0) \
        == CHAOS_ROUND["positive"]
    got = {name: _registry(tmp_path / f"{name}.jsonl")
           for name in CHAOS_ROUND["chaos"]}
    assert got == CHAOS_ROUND["chaos"]


# ---------------------------------------------------------------------------
# The chain-call deadline and the metric stream (fault 2)
# ---------------------------------------------------------------------------

def test_device_metrics_keys_equal_jax():
    ours, theirs = metrics.device_metrics(), jmetrics.device_metrics()
    assert list(ours) == list(theirs)
    assert {"chain_abandoned_workers", "chain_abandoned_total"} <= set(ours)


@pytest.mark.parametrize("mod", [timeout, jtimeout],
                         ids=["port", "jax"])
def test_run_with_timeout_returns_raises_and_abandons(mod):
    assert mod.run_with_timeout(lambda: 41 + 1, 5.0, name="ok") == 42
    with pytest.raises(KeyError, match="boom"):
        mod.run_with_timeout(lambda: {}["boom"], 5.0)
    assert issubclass(mod.ChainTimeout, TimeoutError)
    release = threading.Event()
    killed = []
    total0 = mod.abandoned_total()
    with pytest.raises(mod.ChainTimeout, match="wedged exceeded 0.05s"):
        mod.run_with_timeout(release.wait, 0.05, name="wedged",
                             on_timeout=lambda: killed.append(1))
    assert killed == [1]
    assert mod.abandoned_total() == total0 + 1
    assert mod.abandoned_workers() >= 1
    release.set()                   # the parked IO returns: the leak ends
    deadline = time.monotonic() + 5
    while mod.abandoned_workers():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert mod.abandoned_total() == total0 + 1     # monotonic


def test_timeout_accounting_rides_device_metrics():
    release = threading.Event()
    base = metrics.device_metrics()["chain_abandoned_total"]
    try:
        for _ in range(timeout.ABANDON_WARN_THRESHOLD + 1):
            with pytest.raises(timeout.ChainTimeout):
                timeout.run_with_timeout(release.wait, 0.01)
        got = metrics.device_metrics()
        assert got["chain_abandoned_total"] == base + \
            timeout.ABANDON_WARN_THRESHOLD + 1
        assert got["chain_abandoned_workers"] >= \
            timeout.ABANDON_WARN_THRESHOLD + 1
        assert timeout.ABANDON_WARN_THRESHOLD == \
            jtimeout.ABANDON_WARN_THRESHOLD
    finally:
        release.set()
    deadline = time.monotonic() + 5
    while timeout.abandoned_workers():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    np.testing.assert_equal(metrics.device_metrics()[
        "chain_abandoned_workers"], 0.0)
