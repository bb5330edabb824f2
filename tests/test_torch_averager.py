"""The port's averager (engine/average.py WeightedAverage + AveragerLoop,
engine/ingest.py, chain/, neurons/averager.py, the averager half of
config.py) against the JAX package, on the CPU.

- Mixed rounds over one LocalFSTransport root, both ways: JAX
  ``--wire-v2`` miners (int8 and f32 kept values), a dense v1 miner, a
  hostile packed miner and a stale one, merged by the port's
  ``AveragerLoop(WeightedAverage)`` and by the JAX one on a copy of the
  root; then the port's ``MinerLoop(wire_v2=True)`` miners merged by both.
  The same accepted and rejected ids, the same weights (from a
  ``LocalChain.set_weights`` a validator made), published bases within
  1e-6 of each other and of base + sum w_i decode(delta_i).
- The round's rules: the packed submissions reach the merge packed (no
  densify fallback), stale submissions are skipped, a declined merge is
  not recomputed for the same submissions.
- The chain's JSON state crosses between the packages; the averager's
  flags parse as the JAX parser's and every refusal names its slice; the
  CLI runs under ``DT_FORCE_PLATFORM=cpu``; the averager's modules load
  without JAX.

f32 tiny GPT-2 on both sides, weights and deltas from numpy with a seed.
"""

import dataclasses
import logging
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.models.lora import LoRAConfig
from distributedtraining_tpu_torch.neurons import averager as tcli
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.utils import obs

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the validator's weights, set through the chain (not uniform)
SCORES = {"hotkey_1": 0.5, "hotkey_2": 0.3, "hotkey_3": 0.45,
          "hotkey_4": 0.4, "hotkey_5": 0.35}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(6)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    jmodel, _ = jg.make_model(JTINY)
    model, _ = tg.make_model(TINY)
    return {"base": tg.init_params_numpy(TINY, 0), "train": train,
            "val": val, "jeng": jtrain.TrainEngine(jmodel),
            "teng": ttrain.TrainEngine(model, device="cpu")}


def _delta(seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale
                   ).astype(np.float32), tg.init_params_numpy(TINY, 0))


def _template():
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  tg.init_params_numpy(TINY, 0))


class _Report:
    pushes = pushes_failed = pushes_superseded = 0


def _jpublish_v2(jt, hotkey, packed, rev, quant):
    fast = JRetry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)
    pub = JPub(jt, hotkey, report=_Report(), publish_retry=fast,
               meta_retry=fast,
               wire_spec={"format": 2, "density": 1.0 / 16.0,
                          "quant": quant})
    assert pub.publish_now(packed, None, rev, f"{hotkey}-000001")
    pub.close()


def _set_weights(chain_dir, jax_side=True):
    chain = (JChain if jax_side else LocalChain)(chain_dir,
                                                 my_hotkey="hotkey_91")
    chain.set_weights(SCORES)


def _port_loop(world, root, chain_dir, **kw):
    return tavg.AveragerLoop(
        world["teng"], LocalFSTransport(root),
        LocalChain(chain_dir, my_hotkey="hotkey_95"), tavg.WeightedAverage(),
        val_batches=lambda: iter(world["val"]), **kw)


def _jax_loop(world, root, chain_dir, **kw):
    return JLoop(world["jeng"], JFS(root),
                 JChain(chain_dir, my_hotkey="hotkey_95"), JWA(),
                 val_batches=lambda: iter(world["val"]), **kw)


def _published(root):
    fetched = JFS(root).fetch_base(_template())
    assert fetched is not None
    return tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, fetched[0]))


def _run_both(world, tmp_path, root, chain_dir):
    """The port's and the JAX averager, one round each on its own copy of
    ``root``; returns both loops after the round."""
    jroot = str(tmp_path / "jax_copy")
    shutil.copytree(root, jroot)
    obs.configure()
    try:
        port = _port_loop(world, root, chain_dir, publish_policy="always")
        port.bootstrap()
        assert port.run_round()
        snap = obs.flush()
    finally:
        obs.reset()
    ref = _jax_loop(world, jroot, chain_dir, publish_policy="always")
    ref.bootstrap()
    assert ref.run_round()
    return port, ref, jroot, snap


def _check_merge(world, port, ref, root, jroot, deltas_by_id, snap):
    """Same cohort, same weights, bases within 1e-6 of each other and of
    base + sum w_i decode(delta_i) (the plain versions)."""
    assert port.report.last_accepted == ref.report.last_accepted
    assert port.report.last_rejected == ref.report.last_rejected
    (ids_p, w_p), (ids_j, w_j) = (port.strategy._weights_cache[0][0],
                                  port.strategy._weights_cache[1]), \
        (ref.strategy._weights_cache[0][0],
         np.asarray(ref.strategy._weights_cache[1]))
    assert ids_p == ids_j == tuple(sorted(deltas_by_id))
    np.testing.assert_allclose(w_p, w_j, rtol=0, atol=1e-7)
    assert len(set(np.round(w_p, 6))) > 1          # not uniform
    ours, theirs = _published(root), _published(jroot)
    base = tdl.flatten_tree(world["base"])
    expect = {k: v.astype(np.float64) for k, v in base.items()}
    for h, wi in zip(ids_p, w_p):
        d = deltas_by_id[h]
        dense = (tdl.densify_packed_v2(d, _template())
                 if tdl.is_packed_v2(d) else d)
        for k, v in tdl.flatten_tree(dense).items():
            expect[k] += float(wi) * np.asarray(v, np.float64)
    for k in base:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours[k], expect[k], rtol=0, atol=1e-6)
    assert snap.get("delta.densify_fallbacks", 0) == 0
    assert snap["span.avg.merge_ms.count"] == 1


def test_mixed_round_jax_miners_port_averager(world, tmp_path):
    root = str(tmp_path / "artifacts")
    chain_dir = str(tmp_path / "chain")
    jt = JFS(root)
    rev = jt.publish_base(jax.tree_util.tree_map(jnp.asarray, world["base"]))
    _set_weights(chain_dir)
    deltas = {}
    for h, quant, seed in (("hotkey_1", "int8", 1), ("hotkey_2", "none", 2)):
        packed, _ = jdl.pack_delta_v2(
            jax.tree_util.tree_map(jnp.asarray, _delta(seed)),
            density=1.0 / 16.0, quant=quant)
        deltas[h] = jax.tree_util.tree_map(np.asarray, packed)
        _jpublish_v2(jt, h, deltas[h], rev, quant)
    deltas["hotkey_3"] = _delta(3)                     # dense v1
    jt.publish_delta("hotkey_3", deltas["hotkey_3"])
    jt.publish_delta_meta("hotkey_3", {"base_revision": rev})
    hostile, _ = jdl.pack_delta_v2(                    # negative scale
        jax.tree_util.tree_map(jnp.asarray, _delta(4)), density=1.0 / 16.0)
    hostile = jax.tree_util.tree_map(np.asarray, hostile)
    hostile["leaves"]["wpe"]["scale"] = np.asarray(-1.0, np.float32)
    _jpublish_v2(jt, "hotkey_4", hostile, rev, "int8")
    jt.publish_delta("hotkey_5", _delta(5))            # stale
    jt.publish_delta_meta("hotkey_5", {"base_revision": "old"})
    huge = jax.tree_util.tree_map(np.copy, deltas["hotkey_1"])
    huge["leaves"]["wte"]["scale"] = np.asarray(1e6, np.float32)
    _jpublish_v2(jt, "hotkey_6", huge, rev, "int8")   # over the cap

    port, ref, jroot, snap = _run_both(world, tmp_path, root, chain_dir)
    assert port.report.last_accepted == 3 and port.report.last_rejected == 2
    _check_merge(world, port, ref, root, jroot, deltas, snap)
    verdicts = {}
    for loop in (port, ref):
        staged = loop._ingest().stage(["hotkey_4", "hotkey_5", "hotkey_6"],
                                      base_revision=rev)
        verdicts[loop is port] = [s.reason for s in staged]
    # the negative scale fails admission at assembly (packed_matches):
    # no_delta in both packages, as the dense screen's shape_mismatch is
    assert verdicts[True] == verdicts[False]
    assert verdicts[True][:2] == ["no_delta", "stale_base"]
    assert verdicts[True][2].startswith("magnitude_exceeded(")
    port.close()
    ref.close()


def _port_miner(world, root, hotkey, quant, steps):
    eng = ttrain.TrainEngine(tg.make_model(TINY)[0], device="cpu")
    loop = ttrain.MinerLoop(eng, LocalFSTransport(root), hotkey,
                            clock=FakeClock(), send_interval=1e9,
                            check_update_interval=1e9, wire_v2=True,
                            wire_density=1.0 / 16.0, wire_quant=quant)
    loop.bootstrap()
    loop.run(iter(world["train"][:steps]))
    loop.flush()
    loop.close()
    return loop


def test_mixed_round_port_miners_jax_averager(world, tmp_path):
    root = str(tmp_path / "artifacts")
    chain_dir = str(tmp_path / "chain")
    LocalFSTransport(root).publish_base(world["base"])
    _set_weights(chain_dir, jax_side=False)
    deltas = {}
    for h, quant, steps in (("hotkey_1", "int8", 3), ("hotkey_2", "none",
                                                      2)):
        _port_miner(world, root, h, quant, steps)
        staged = _port_loop(world, root, chain_dir)._ingest().stage([h])[0]
        assert staged.reason == "ok" and tdl.is_packed_v2(staged.delta)
        deltas[h] = staged.delta
    meta = JFS(root).fetch_delta_meta("hotkey_1")
    assert meta["wire"] == {"format": 2, "density": 1.0 / 16.0,
                            "quant": "int8"}
    port, ref, jroot, snap = _run_both(world, tmp_path, root, chain_dir)
    _check_merge(world, port, ref, root, jroot, deltas, snap)
    # round 2 on the port's root: every submission names the old base now
    assert not port.run_round()
    assert port.report.last_accepted == 0 and port.report.last_rejected == 2
    port.close()
    ref.close()


def test_declined_merge_is_not_recomputed(world, tmp_path):
    root = str(tmp_path / "artifacts")
    chain_dir = str(tmp_path / "chain")
    t = LocalFSTransport(root)
    rev = t.publish_base(world["base"])
    t.publish_delta("hotkey_1", _delta(1, scale=1.0))   # ruins the model
    t.publish_delta_meta("hotkey_1", {"base_revision": rev})
    obs.configure()
    try:
        loop = _port_loop(world, root, chain_dir)
        loop.bootstrap()
        assert loop.run_round() and loop.run_round()
        snap = obs.flush()
    finally:
        obs.reset()
        loop.close()
    assert loop.report.skipped_publishes == 1 and loop.report.rounds == 2
    assert t.base_revision() == rev
    assert snap["span.avg.merge_ms.count"] == 1


def test_unported_planes_and_strategies_raise(world):
    # the lineage, base-distribution, lease, tree, fleet and remediation
    # planes are ported: accepted
    for kw in ({"lineage": object()}, {"base_dist": object()},
               {"lease": object()}, {"hierarchy": ["n0"]},
               {"lora_cfg": LoRAConfig(rank=4)}, {"fleet": object()},
               {"remediation": object()}):
        loop = tavg.AveragerLoop(world["teng"], None, None,
                                 tavg.WeightedAverage(), val_batches=None,
                                 **kw)
        assert getattr(loop, next(iter(kw))) == kw[next(iter(kw))]
    # a keyword the JAX loop does not take is still refused
    with pytest.raises(TypeError, match="unexpected keyword"):
        tavg.AveragerLoop(world["teng"], None, None, tavg.WeightedAverage(),
                          val_batches=None, exporter=object())
    # ParameterizedMerge, OuterOptMerge and GeneticMerge are ported
    # (tests/test_torch_parameterized_merge.py, test_torch_outer_merge.py,
    # test_torch_genetic_merge.py)
    assert tavg.GeneticMerge().lineage_weights([1.0]) == [1.0]
    outer = tavg.OuterOptMerge(tavg.WeightedAverage())
    assert outer.host_list_ingest and outer.lineage_weights([1.0]) is None


# ---------------------------------------------------------------------------
# Chain, config, CLI, isolation
# ---------------------------------------------------------------------------

def test_local_chain_state_crosses_between_packages(tmp_path):
    d = str(tmp_path / "chain")
    _set_weights(d, jax_side=True)
    port, ref = LocalChain(d), JChain(d)
    assert port.consensus_scores() == ref.consensus_scores() != {}
    assert port.sync().hotkeys == ref.sync().hotkeys
    assert port.get_validator_uids() == ref.get_validator_uids()
    LocalChain(d, my_hotkey="hotkey_92").set_weights({"hotkey_7": 1.0})
    assert JChain(d).consensus_scores() == port.consensus_scores()
    assert "hotkey_7" in port.consensus_scores()


AVG_ARGS = ["--backend", "local", "--model", "tiny", "--dataset",
            "synthetic", "--tokenizer", "word", "--strategy", "weighted",
            "--no-base-wire-v2", "--no-lineage", "--flight-events", "0"]


def test_averager_flags_match_the_jax_parser():
    from distributedtraining_tpu.config import RunConfig as JRunConfig
    from distributedtraining_tpu.config import build_parser as jparser
    from distributedtraining_tpu_torch.config import build_parser

    def table(p):
        return {o: (a.dest, a.default, a.choices)
                for a in p._actions for o in a.option_strings}
    assert table(build_parser("averager")) == table(jparser("averager"))
    argv = AVG_ARGS + ["--rounds", "2", "--merge-chunk", "4",
                       "--max-delta-abs", "0", "--stale-deltas", "accept",
                       "--publish-policy", "always", "--no-wire-v2",
                       "--ingest-workers", "1", "--eval-batches", "3"]
    for args in (argv, []):
        ours = dataclasses.asdict(RunConfig.from_args("averager", args))
        ref = dataclasses.asdict(JRunConfig.from_args("averager", args))
        assert ours == {k: ref[k] for k in ours}
    RunConfig.from_args("averager", argv).check_ported()


@pytest.mark.parametrize("extra,slice_no", [
    # the JAX defaults (--base-wire-v2, --lineage, --flight-events 512)
    # and the opt-outs of them are ported: None means accepted
    ([], None),
    (["--strategy", "weighted"], None),
    (["--strategy", "weighted", "--no-base-wire-v2"], None),
    (["--strategy", "weighted", "--no-base-wire-v2", "--no-lineage"], None),
    # the genetic merge is ported (tests/test_torch_genetic_merge.py); the
    # id is the case's when slice 6 refused it
    pytest.param(AVG_ARGS + ["--strategy", "genetic"], None,
                 id="extra4-6"),
    # slice 5's flags are ported (tests/test_torch_outer_merge.py,
    # test_torch_hier_average.py, test_torch_remediate.py,
    # test_torch_signing.py run them through the CLI)
    (AVG_ARGS + ["--outer-momentum", "0.9"], None),
    (AVG_ARGS + ["--hier", "root"], None),
    (AVG_ARGS + ["--standby"], None),
    (AVG_ARGS + ["--sign-artifacts"], None),
    # the fleet health plane is ported (tests/test_torch_health.py,
    # test_torch_remediate.py); the ids are those of the cases when they
    # were refused
    pytest.param(AVG_ARGS + ["--remediate"], None, id="extra9-7"),
    (AVG_ARGS + ["--chain", "bittensor"], 7),
    # LoRA is ported (tests/test_torch_lora_train.py runs the CLIs)
    pytest.param(AVG_ARGS + ["--lora-rank", "4"], None, id="extra11-7"),
    pytest.param(AVG_ARGS + ["--metrics-path", "m.jsonl"], None,
                 id="extra12-7"),
    (AVG_ARGS + ["--heartbeat-interval", "2", "--remediate", "--standby"],
     None),
    # the exporter is ported (tests/test_torch_obs_http.py); the id is
    # the case's when it was refused
    pytest.param(AVG_ARGS + ["--obs-port", "9100"], None, id="extra14-7"),
])
def test_averager_refusals_name_their_slice(extra, slice_no):
    cfg = RunConfig.from_args("averager", extra)
    if slice_no is None:
        cfg.check_ported()
        return
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        cfg.check_ported()


def test_averager_cli_on_cpu_merges_a_wire_v2_miner(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    small = ["--batch-size", "2", "--eval-batches", "2",
             "--eval-seq-len", "32", "--work-dir", work]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        # genesis: no miner yet, so no merge (exit 1), but a base
        assert tcli.main(AVG_ARGS + small + ["--rounds", "1"]) == 1
        t = LocalFSTransport(f"{work}/artifacts")
        rev0 = t.base_revision()
        assert rev0 is not None
        assert tminer.main(
            ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--checkpoint-interval", "0", "--no-anomaly-trace",
             "--flight-events", "0", "--wire-v2", "--hotkey", "hotkey_3",
             "--max-steps", "3", "--seq-len", "32"] + small) == 0
        assert tcli.main(AVG_ARGS + small + ["--rounds", "1",
                                             "--publish-policy", "always",
                                             "--hotkey", "hotkey_95"]) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    assert t.base_revision() not in (None, rev0)


def test_averager_path_loads_without_jax():
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
                 "ml_dtypes", "distributedtraining_tpu")
    code = ("import sys\n"
            "import distributedtraining_tpu_torch.neurons.averager\n"
            "import distributedtraining_tpu_torch.engine.ingest\n"
            "import distributedtraining_tpu_torch.ops.dequant_scatter\n"
            "import distributedtraining_tpu_torch.chain\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{forbidden!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_remediate_round_matches_jax_with_a_stale_miner(world, tmp_path):
    """``--remediate`` averagers of both packages, each holding its
    publication lease, on copies of one root where three miners publish
    every round and beat until hotkey_3 stops after round 1: round 5
    breaches ``stale_node``, both quarantine it, round 6 merges without
    it. The same cohorts and quarantine every round, published bases
    within 1e-6, one lease epoch stamped with each revision."""
    from distributedtraining_tpu.engine import health as jh
    from distributedtraining_tpu.engine import remediate as jrem
    from distributedtraining_tpu.engine.scheduler import FakeClock as JClock
    from distributedtraining_tpu_torch.engine import health as th
    from distributedtraining_tpu_torch.engine import remediate as trem
    from distributedtraining_tpu_torch.transport.base import (heartbeat_id,
                                                              lease_id)
    from distributedtraining_tpu_torch.utils.metrics import InMemorySink
    roots = {s: str(tmp_path / s / "artifacts") for s in ("port", "jax")}
    chain_dir = str(tmp_path / "chain")
    _set_weights(chain_dir)
    sides = {}
    for side, root in roots.items():
        if side == "port":
            t = LocalFSTransport(root)
            fleet = th.FleetMonitor(t, clock=FakeClock(0.0))
            loop = _port_loop(world, root, chain_dir,
                              publish_policy="always", fleet=fleet,
                              metrics=InMemorySink(),
                              remediation=trem.RemediationEngine(fleet),
                              lease=trem.LeaseManager(t, "hotkey_95"))
        else:
            t = JFS(root)
            fleet = jh.FleetMonitor(t, clock=JClock(0.0))
            loop = _jax_loop(world, root, chain_dir,
                             publish_policy="always", fleet=fleet,
                             remediation=jrem.RemediationEngine(fleet),
                             lease=jrem.LeaseManager(t, "hotkey_95"))
        assert loop.lease.acquire()
        loop.bootstrap(params=(world["base"] if side == "port" else
                               jax.tree_util.tree_map(jnp.asarray,
                                                      world["base"])))
        sides[side] = {"t": t, "loop": loop, "log": []}
    miners = ("hotkey_1", "hotkey_2", "hotkey_3")
    try:
        for rnd in range(1, 7):
            for side, s in sides.items():
                jt = JFS(roots[side])
                rev = jt.base_revision()
                for i, h in enumerate(miners):
                    jt.publish_delta(h, _delta(10 * rnd + i))
                    jt.publish_delta_meta(h, {"base_revision": rev})
                    if h != "hotkey_3" or rnd == 1:
                        jt.publish_delta_meta(
                            heartbeat_id("miner", h),
                            th.build_heartbeat("miner", h, rnd, now=rnd,
                                               steps=10 * rnd))
                loop = s["loop"]
                assert loop.run_round()
                ids = sorted(h for h, st in loop._round_staged.items())
                s["log"].append((ids, sorted(loop.remediation.quarantined()),
                                 loop.report.last_rejected,
                                 loop.report.skipped_publishes))
        port, ref = sides["port"], sides["jax"]
        assert port["log"] == ref["log"]
        assert port["log"][3][:2] == (list(miners), []) and \
            port["log"][4][1] == ["hotkey_3"]
        assert port["log"][5] == (["hotkey_1", "hotkey_2"], ["hotkey_3"],
                                  1, 0)
        ours, theirs = _published(roots["port"]), _published(roots["jax"])
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-6)
        for side, s in sides.items():
            token = trem.parse_lease(s["t"].fetch_delta_meta(lease_id()))
            assert token["epoch"] == 1 and token["holder"] == "hotkey_95"
            assert token["base_revision"] == s["t"].base_revision()
        recs = port["loop"].metrics.records
        assert [r["lease_epoch"] for r in recs if "lease_epoch" in r] \
            == [1] * 6
        assert any("fleet_ledger" in r for r in recs)
    finally:
        for s in sides.values():
            s["loop"].close()
