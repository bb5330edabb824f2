"""The port's lineage plane (engine/lineage.py, its wiring into
AveragerLoop, transport/base.py's lineage ids) against the JAX package's,
on the CPU.

- One WeightedAverage round over the same fleet (a packed int8, a packed
  f32 and a dense v1 miner, chain weights) by the port's and the JAX
  averager, each with a LineagePlane, on copies of one root: the same
  contributions (hotkey, revision, cid, weight, wire bytes, verdict,
  score), and a record built from them has the same ``record_digest``
  and ``record_id`` in both packages.
- Each package's ``parse_record`` and ``replay_record`` accept the other's
  records and replay them within 1e-6 (the port's through the plain
  dequantize-scatter on the CPU); ``walk_chain`` crosses both packages'
  records down to the genesis record; a record with one byte changed
  raises ``LineageError`` in both.
- A scalar ParameterizedMerge round's record replays across packages.
  Its weights are torch's and JAX's softmax of logits learned by each
  package's meta-steps, which may differ in the last bit, so these
  records are held to cross-parsing and replay, not to digest equality.
- ``QualityDriftDetector``'s breaches equal JAX's for the same loss
  series.

f32 tiny GPT-2 on both sides, weights and deltas from numpy with a seed.
"""

import dataclasses
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import lineage as jlin
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import \
    ParameterizedMerge as JPM
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import lineage as lin
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.transport import base as tb

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
SCORES = {"hotkey_1": 0.5, "hotkey_2": 0.3, "hotkey_3": 0.45}


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
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    jmodel, _ = jg.make_model(JTINY)
    model, _ = tg.make_model(TINY)
    return {"base": tg.init_params_numpy(TINY, 0), "val": val,
            "jmodel": jmodel, "model": model,
            "jeng": jtrain.TrainEngine(jmodel),
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


def _fleet(world, root, chain_dir):
    """A JAX averager's genesis base (and its lineage record), three
    miners on ``root`` (a packed int8, a packed f32, a dense v1), the
    chain's weights; returns the base revision."""
    jt = JFS(root)
    genesis = _jax_loop(world, root, chain_dir)
    genesis.bootstrap(params=world["base"])
    rev = jt.base_revision()
    assert genesis.lineage.last_record["strategy"] == "genesis"
    JChain(chain_dir, my_hotkey="hotkey_91").set_weights(SCORES)
    fast = JRetry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)
    for h, quant, seed in (("hotkey_1", "int8", 1), ("hotkey_2", "none", 2)):
        packed, _ = jdl.pack_delta_v2(
            jax.tree_util.tree_map(jnp.asarray, _delta(seed)),
            density=1.0 / 16.0, quant=quant)
        pub = JPub(jt, h, report=_Report(), publish_retry=fast,
                   meta_retry=fast,
                   wire_spec={"format": 2, "density": 1.0 / 16.0,
                              "quant": quant})
        assert pub.publish_now(jax.tree_util.tree_map(np.asarray, packed),
                               None, rev, f"{h}-000001")
        pub.close()
    jt.publish_delta("hotkey_3", _delta(3))
    jt.publish_delta_meta("hotkey_3", {"base_revision": rev,
                                       "delta_id": "hotkey_3-000001"})
    return rev


def _port_loop(world, root, chain_dir, strategy=None, **kw):
    t = LocalFSTransport(root)
    return tavg.AveragerLoop(
        world["teng"], t, LocalChain(chain_dir, my_hotkey="hotkey_95"),
        strategy or tavg.WeightedAverage(),
        val_batches=lambda: iter(world["val"]), publish_policy="always",
        lineage=lin.LineagePlane(t, node="hotkey_95"), **kw)


def _jax_loop(world, root, chain_dir, strategy=None, **kw):
    t = JFS(root)
    return JLoop(world["jeng"], t, JChain(chain_dir, my_hotkey="hotkey_95"),
                 strategy or JWA(), val_batches=lambda: iter(world["val"]),
                 publish_policy="always",
                 lineage=jlin.LineagePlane(t, node="hotkey_95"), **kw)


@pytest.fixture(scope="module")
def rounds(world, tmp_path_factory):
    """One WeightedAverage round by each package on its own copy of one
    root."""
    tmp = tmp_path_factory.mktemp("lineage")
    root, chain_dir = str(tmp / "port"), str(tmp / "chain")
    rev = _fleet(world, root, chain_dir)
    jroot = str(tmp / "jax")
    shutil.copytree(root, jroot)
    port = _port_loop(world, root, chain_dir)
    port.bootstrap()
    assert port.run_round()
    ref = _jax_loop(world, jroot, chain_dir)
    ref.bootstrap()
    assert ref.run_round()
    port.close()
    ref.close()
    return {"port": port, "ref": ref, "root": root, "jroot": jroot,
            "genesis": rev, "chain": chain_dir}


def test_weighted_round_records_match_jax(rounds):
    port, ref = rounds["port"], rounds["ref"]
    pr, jr = port.lineage.last_record, ref.lineage.last_record
    assert pr["contributions"] == jr["contributions"]
    assert [c["hotkey"] for c in pr["contributions"]] == sorted(SCORES)
    assert all(c["weight"] is not None and c["rev"] and c["cid"]
               and c["wire_bytes"] > 0 for c in pr["contributions"])
    for key in ("kind", "node", "parent", "round", "strategy", "replayable",
                "weights_kind"):
        assert pr[key] == jr[key], key
    assert pr["parent"] == rounds["genesis"] and pr["replayable"]
    # the same round's record: digest and id equal in both packages
    kw = dict(kind="base", node="hotkey_95", revision="rev-x",
              parent=pr["parent"], round_no=0,
              contributions=pr["contributions"], strategy="WeightedAverage",
              loss=5.25, parent_loss=5.5, now=1.0)
    ours, theirs = lin.build_record(**kw), jlin.build_record(**kw)
    assert ours == theirs
    assert lin.record_digest(ours) == jlin.record_digest(ours) \
        == ours["record_id"]
    # and each package's own record carries its digest by the other's rule
    assert jlin.record_digest(pr) == pr["record_id"]
    assert lin.record_digest(jr) == jr["record_id"]
    # the contributions from each package's staging, side by side
    staged_p = lin.contributions_from_staging(
        [c["hotkey"] for c in pr["contributions"]],
        [c["weight"] for c in pr["contributions"]], port._round_staged,
        consensus=port.chain.consensus_scores(), cids=port._round_cids)
    staged_j = jlin.contributions_from_staging(
        [c["hotkey"] for c in jr["contributions"]],
        [c["weight"] for c in jr["contributions"]], ref._round_staged,
        consensus=ref.chain.consensus_scores(), cids=ref._round_cids)
    assert lin.build_record(**dict(kw, contributions=staged_p)) == \
        jlin.build_record(**dict(kw, contributions=staged_j))


def test_records_parse_and_replay_across_packages(rounds, world):
    port, ref = rounds["port"], rounds["ref"]
    for record, root in ((ref.lineage.last_record, rounds["jroot"]),
                         (port.lineage.last_record, rounds["root"])):
        data = json.dumps(record).encode()
        assert lin.parse_record(data) == jlin.parse_record(data)
        t, jt = LocalFSTransport(root), JFS(root)
        fetched = lin.fetch_record(t, record["revision"])
        assert fetched == jlin.fetch_record(jt, record["revision"])
        ours = lin.replay_record(t, fetched, _template(),
                                 parent=world["base"], device="cpu")
        theirs = jlin.replay_record(jt, fetched, _template(),
                                    parent=world["base"])
        assert ours.ok and theirs.ok and ours.contributions == 3
        assert ours.max_abs_diff <= 1e-6 and theirs.max_abs_diff <= 1e-6
    # a record names a merge a drifted base no longer is: loud
    with pytest.raises(lin.LineageError):
        lin.replay_record(LocalFSTransport(rounds["root"]),
                          port.lineage.last_record, _template(),
                          parent=jax.tree_util.tree_map(
                              lambda x: x + 1e-3, world["base"]),
                          device="cpu")


def test_walk_chain_across_packages_and_tamper(rounds, world, tmp_path):
    """The JAX averager's round 1, then a port averager's round 2 on the
    same root: both walkers reach the JAX genesis record."""
    root = str(tmp_path / "walk")
    shutil.copytree(rounds["jroot"], root)
    port = _port_loop(world, root, rounds["chain"], stale_deltas="accept")
    port.bootstrap()
    assert port.run_round()
    port.close()
    head = LocalFSTransport(root).base_revision()
    ours = lin.walk_chain(LocalFSTransport(root), head)
    theirs = jlin.walk_chain(JFS(root), head)
    assert [r["record_id"] for r in ours] == [r["record_id"] for r in theirs]
    assert len(ours) == 3 and ours[-1]["strategy"] == "genesis"
    assert ours[-1]["parent"] is None and ours[0]["node"] == "hotkey_95"
    assert ours[1]["revision"] == rounds["ref"].lineage.last_record[
        "revision"]
    # one byte changed: loud in both packages
    t = LocalFSTransport(root)
    data = t.fetch_delta_bytes(tb.lineage_id(head))
    i = data.index(b'"round": ') + len(b'"round": ')
    t.publish_raw(tb.lineage_id(head),
                  data[:i] + bytes([data[i] ^ 1]) + data[i + 1:])
    with pytest.raises(lin.LineageError):
        lin.fetch_record(t, head)
    with pytest.raises(jlin.LineageError):
        jlin.fetch_record(JFS(root), head)
    with pytest.raises(lin.LineageError):
        lin.walk_chain(t, head)


def test_scalar_parameterized_records_replay_across_packages(world,
                                                              tmp_path):
    root, chain_dir = str(tmp_path / "port"), str(tmp_path / "chain")
    _fleet(world, root, chain_dir)
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)
    port = _port_loop(world, root, chain_dir, tavg.ParameterizedMerge(
        world["model"], meta_epochs=1, per_tensor=False))
    port.bootstrap()
    assert port.run_round()
    port.close()
    ref = _jax_loop(world, jroot, chain_dir, JPM(
        world["jmodel"], meta_epochs=1, per_tensor=False))
    ref.bootstrap()
    assert ref.run_round()
    ref.close()
    pr, jr = port.lineage.last_record, ref.lineage.last_record
    assert pr["strategy"] == jr["strategy"] == "ParameterizedMerge"
    assert pr["replayable"] and jr["replayable"]
    pw = [c["weight"] for c in pr["contributions"]]
    jw = [c["weight"] for c in jr["contributions"]]
    np.testing.assert_allclose(pw, jw, rtol=0, atol=1e-6)
    assert math.isclose(sum(pw), 1.0, abs_tol=1e-6)
    for record, root_ in ((jr, jroot), (pr, root)):
        assert lin.parse_record(record) == jlin.parse_record(record)
        ours = lin.replay_record(LocalFSTransport(root_), record, _template(),
                                 parent=world["base"], device="cpu")
        theirs = jlin.replay_record(JFS(root_), record, _template(),
                                    parent=world["base"])
        assert ours.max_abs_diff <= 1e-6 and theirs.max_abs_diff <= 1e-6
    # the default, per-tensor merge is attribution-only in both
    assert lin.resolve_weights(tavg.ParameterizedMerge(world["model"]),
                               {"wte": torch.zeros(3)}, 3) == (None,
                                                               "opaque")


def test_drift_detector_breaches_match_jax():
    rng = np.random.default_rng(0)
    series = list(5.0 - 0.05 * np.arange(12) + rng.normal(0, 0.01, 12))
    series += [4.6, 4.9, 5.3, 5.6, 5.2, float("nan"), 5.0, 4.5, 6.5, 7.0]
    ours, theirs = lin.QualityDriftDetector(), jlin.QualityDriftDetector()
    out_p = [ours.update(x) for x in series]
    out_j = [theirs.update(x) for x in series]
    assert [o is None for o in out_p] == [o is None for o in out_j]
    for a, b in zip(out_p, out_j):
        if a is not None:
            assert a.keys() == b.keys() and a["reason"] == b["reason"]
            for k, v in a.items():
                if isinstance(v, float) and math.isnan(v):
                    assert math.isnan(b[k])
                else:
                    assert v == b[k], k
    assert ours.breaches == theirs.breaches >= 2
    assert (ours.ewma, ours.cusum) == (theirs.ewma, theirs.cusum)
