"""The port's tree averager (engine/hier_average.py plan_fanout,
subtree_weights and SubAverager; AveragerLoop(hierarchy=...); the "agg"
rider in engine/ingest.py; "agg" lineage records in engine/lineage.py;
engine/basedist.py MirrorDuty; the averager's ``--hier sub|root``)
against the JAX package, on the CPU.

- ``plan_fanout`` and ``subtree_weights`` equal JAX's.
- A port ``SubAverager`` and a JAX one on copies of one root (packed
  int8 and f32 and dense miners, a stale one, chain weights): the same
  accepted ids, riders and weight mass, aggregates within 1e-6, dense
  (v1) and lossless v2 (``--hier-wire-v2``).
- A port root over two port subs equals the flat weighted merge of the
  same miners within 1e-6; a JAX root over the port's subs agrees; an
  empty round publishes nothing; a killed sub degrades the root to the
  surviving subtree.
- "agg" lineage records: the same contributions and fields as JAX's,
  the same digest for the same revision, and each package replays the
  other's.
- ``MirrorDuty``: the replicas and the presence rider equal JAX's, a
  second sync moves nothing, and a fetcher reads the base off the mirror.
- The CLI: two ``--hier sub`` nodes (one ``--hier-wire-v2``) and a
  ``--hier root``, under ``DT_FORCE_PLATFORM=cpu``.

f32 tiny GPT-2; weights and deltas from numpy with a seed.
"""

import dataclasses
import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import basedist as jbd
from distributedtraining_tpu.engine import hier_average as jhier
from distributedtraining_tpu.engine import lineage as jlin
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.ingest import DeltaIngestor as JIngest
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport import base as jtbase
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import basedist as tbd
from distributedtraining_tpu_torch.engine import hier_average as thier
from distributedtraining_tpu_torch.engine import lineage as lin
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import averager as tcli
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.transport import base as tbase
from distributedtraining_tpu_torch.utils import obs

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
MINERS = ["hotkey_1", "hotkey_2", "hotkey_3", "hotkey_4"]
SCORES = {"hotkey_1": 0.5, "hotkey_2": 0.3, "hotkey_3": 0.45,
          "hotkey_4": 0.4}
NODES = ["n0", "n1"]
PLAN = {"n0": ["hotkey_1", "hotkey_3"], "n1": ["hotkey_2", "hotkey_4"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    val = list(tds.batch_iterator(
        tds.text_corpus(split="test", n_docs=64, seed=0),
        tds.WordTokenizer(tds.text_corpus(n_docs=64, seed=0),
                          vocab_size=TINY.vocab_size),
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


def _template():
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  tg.init_params_numpy(TINY, 0))


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _flat(t):
    return tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, t))


class _Report:
    pushes = pushes_failed = pushes_superseded = 0


FAST = JRetry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)


def _fleet(world, root, chain_dir, *, stale=None):
    """A JAX base, four miners (packed int8, packed f32 and two dense),
    the chain's weights; ``stale`` publishes that miner against another
    base. Returns the base revision."""
    jt = JFS(root)
    rev = jt.publish_base(_jtree(world["base"]))
    JChain(chain_dir, my_hotkey="hotkey_91").set_weights(SCORES)
    for h, quant, seed in (("hotkey_1", "int8", 1), ("hotkey_2", "none", 2)):
        packed, _ = jdl.pack_delta_v2(_jtree(_delta(seed)),
                                      density=1.0 / 16.0, quant=quant)
        pub = JPub(jt, h, report=_Report(), publish_retry=FAST,
                   meta_retry=FAST,
                   wire_spec={"format": 2, "density": 1.0 / 16.0,
                              "quant": quant})
        assert pub.publish_now(jax.tree_util.tree_map(np.asarray, packed),
                               None, rev, f"{h}-000001")
        pub.close()
    for h, seed in (("hotkey_3", 3), ("hotkey_4", 4)):
        jt.publish_delta(h, _delta(seed))
        jt.publish_delta_meta(h, {"base_revision": "old" if h == stale
                                  else rev, "delta_id": f"{h}-000001"})
    return rev


def _consensus(chain_dir):
    return lambda: LocalChain(chain_dir).consensus_scores()


def _port_sub(root, chain_dir, node, **kw):
    return thier.SubAverager(LocalFSTransport(root), node, _template,
                             PLAN[node], consensus=_consensus(chain_dir),
                             device="cpu", **kw)


def _jax_sub(root, chain_dir, node, **kw):
    return jhier.SubAverager(JFS(root), node, _template, PLAN[node],
                             consensus=lambda: JChain(
                                 chain_dir).consensus_scores(), **kw)


@pytest.mark.parametrize("hotkeys,nodes,fanout", [
    (["h3", "h1", "h2", "h1", "h0"], ["a", "b"], None),
    ([f"hk{i}" for i in range(7)], None, 3),
    ([], None, 2),
    (["x"], ["a", "b", "c"], None),
])
def test_plan_fanout_and_subtree_weights_equal_jax(hotkeys, nodes, fanout):
    assert thier.plan_fanout(hotkeys, nodes=nodes, fanout=fanout) == \
        jhier.plan_fanout(hotkeys, nodes=nodes, fanout=fanout)
    ids = sorted(set(hotkeys)) or ["z"]
    for consensus in (None, {}, {h: float(i) for i, h in enumerate(ids)},
                      {h: -1.0 for h in ids}):
        w, mass = thier.subtree_weights(ids, consensus)
        jw, jmass = jhier.subtree_weights(ids, consensus)
        np.testing.assert_array_equal(np.asarray(w), np.asarray(jw))
        assert mass == jmass
    with pytest.raises(ValueError):
        thier.plan_fanout(["a"])


@pytest.mark.parametrize("wire_v2", [False, True], ids=["dense", "v2"])
def test_sub_averager_matches_jax(world, tmp_path, wire_v2):
    root, chain_dir = str(tmp_path / "port"), str(tmp_path / "chain")
    _fleet(world, root, chain_dir, stale="hotkey_4")
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)
    obs.configure()
    try:
        ours = [_port_sub(root, chain_dir, n, wire_spec=wire_v2 or None)
                for n in NODES]
        assert all(s.run_round() for s in ours)
        snap = obs.flush()
    finally:
        obs.reset()
    theirs = [_jax_sub(jroot, chain_dir, n, wire_spec=wire_v2 or None)
              for n in NODES]
    assert all(s.run_round() for s in theirs)
    # packed contributions folded packed, never densified
    assert snap.get("delta.densify_fallbacks", 0) == 0
    for s, j in zip(ours, theirs):
        assert (s.report.last_accepted, s.report.last_rejected,
                s.report.last_weight_sum) == \
            (j.report.last_accepted, j.report.last_rejected,
             j.report.last_weight_sum)
        s.close()
        j.close()
    assert [s.report.last_accepted for s in ours] == [2, 1]   # one stale
    for n in NODES:
        aid = tbase.agg_id(n)
        meta = LocalFSTransport(root).fetch_delta_meta(aid)
        jmeta = JFS(jroot).fetch_delta_meta(aid)
        assert meta["agg"] == jmeta["agg"]
        assert meta["base_revision"] == jmeta["base_revision"]
        assert ("wire" in meta) == ("wire" in jmeta) == wire_v2
        got = DeltaIngestor(LocalFSTransport(root), _template(),
                            workers=1).stage([aid])[0]
        want = JIngest(JFS(jroot), _template(), workers=1).stage([aid])[0]
        assert got.reason == want.reason == "ok"
        assert got.agg_weight == want.agg_weight == meta["agg"]["weight"]
        g, w = tdl.flatten_tree(got.delta), _flat(want.delta)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), w[k], rtol=0,
                                       atol=1e-6)


def _flat_merge(world, root, chain_dir, ids):
    """base + sum_i (c_i / C) d_i over the decoded submissions, c the
    chain's consensus."""
    w = np.asarray(jdl.normalized_merge_weights(
        ids, JChain(chain_dir).consensus_scores()), np.float64)
    t = JFS(root)
    staged = {s.hotkey: s for s in JIngest(t, _template(), workers=1,
                                           stale_deltas="accept").stage(ids)}
    out = {k: v.astype(np.float64)
           for k, v in tdl.flatten_tree(world["base"]).items()}
    for h, wi in zip(ids, w):
        for k, v in _flat(staged[h].delta).items():
            out[k] += wi * v
    return out


def _root_loop(world, root, chain_dir, nodes, *, jax_side=False, **kw):
    if jax_side:
        return JLoop(world["jeng"], JFS(root),
                     JChain(chain_dir, my_hotkey="hotkey_95"), JWA(),
                     val_batches=lambda: iter(world["val"]),
                     publish_policy="always", hierarchy=nodes, **kw)
    return tavg.AveragerLoop(
        world["teng"], LocalFSTransport(root),
        LocalChain(chain_dir, my_hotkey="hotkey_95"), tavg.WeightedAverage(),
        val_batches=lambda: iter(world["val"]), publish_policy="always",
        hierarchy=nodes, **kw)


def test_root_over_two_subs_equals_the_flat_merge(world, tmp_path):
    root, chain_dir = str(tmp_path / "port"), str(tmp_path / "chain")
    rev0 = _fleet(world, root, chain_dir)
    mass = {}
    for n, v2 in zip(NODES, (False, True)):
        sub = _port_sub(root, chain_dir, n, wire_spec=v2 or None)
        assert sub.run_round()
        sub.close()
        mass[tbase.agg_id(n)] = sub.report.last_weight_sum
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)
    ours = _root_loop(world, root, chain_dir, NODES)
    ours.bootstrap()
    assert ours.run_round()
    # each aggregate weighs by the mass its rider declared
    assert ours._round_agg_weights == mass
    ref = _root_loop(world, jroot, chain_dir, NODES, jax_side=True)
    ref.bootstrap()
    assert ref.run_round()
    for lp in (ours, ref):
        lp.close()
    assert LocalFSTransport(root).base_revision() != rev0
    want = _flat_merge(world, jroot, chain_dir, MINERS)
    got = _flat(JFS(root).fetch_base(_template())[0])
    jgot = _flat(JFS(jroot).fetch_base(_template())[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(jgot[k], got[k], rtol=0, atol=1e-6)
    # the next round: the subs' aggregates name the old base, so the root
    # skips them as stale and publishes nothing
    rev1 = LocalFSTransport(root).base_revision()
    again = _root_loop(world, root, chain_dir, NODES)
    again.bootstrap()
    assert not again.run_round()
    again.close()
    assert LocalFSTransport(root).base_revision() == rev1


def test_empty_round_and_a_killed_sub(world, tmp_path):
    root, chain_dir = str(tmp_path / "port"), str(tmp_path / "chain")
    JFS(root).publish_base(_jtree(world["base"]))
    # an empty slice: nothing staged, nothing published
    sub = thier.SubAverager(LocalFSTransport(root), "n0", _template, [],
                            device="cpu")
    assert not sub.run_round()
    assert LocalFSTransport(root).fetch_delta_bytes(tbase.agg_id("n0")) \
        is None
    rev = LocalFSTransport(root).base_revision()
    empty = _root_loop(world, root, chain_dir, NODES)
    empty.bootstrap()
    assert not empty.run_round()
    empty.close()
    assert LocalFSTransport(root).base_revision() == rev
    # n1 dies before publishing: the root merges n0's subtree alone
    _fleet(world, root, chain_dir)
    sub = _port_sub(root, chain_dir, "n0")
    assert sub.run_round()
    sub.close()
    loop = _root_loop(world, root, chain_dir, NODES)
    loop.bootstrap()
    assert loop.run_round()
    loop.close()
    assert loop.report.last_accepted == 1
    # n0's subtree alone, renormalized
    want = _flat_merge(world, root, chain_dir, PLAN["n0"])
    got = _flat(JFS(root).fetch_base(_template())[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_agg_lineage_records_match_jax_and_replay(world, tmp_path):
    root, chain_dir = str(tmp_path / "port"), str(tmp_path / "chain")
    rev = _fleet(world, root, chain_dir)
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)
    sub = _port_sub(root, chain_dir, "n0", lineage=lin.LineagePlane(
        LocalFSTransport(root), node="subavg.n0"))
    jsub = _jax_sub(jroot, chain_dir, "n0", lineage=jlin.LineagePlane(
        JFS(jroot), node="subavg.n0"))
    assert sub.run_round() and jsub.run_round()
    sub.close()
    jsub.close()
    pr, jr = sub.lineage.last_record, jsub.lineage.last_record
    assert pr["kind"] == jr["kind"] == "agg"
    assert pr["contributions"] == jr["contributions"]
    for key in ("node", "parent", "round", "strategy", "replayable",
                "weights_kind", "artifact"):
        assert pr[key] == jr[key], key
    assert pr["parent"] == rev and pr["artifact"] == tbase.agg_id("n0")
    kw = dict(kind="agg", node="subavg.n0", revision="rev-agg",
              parent=rev, round_no=0, contributions=pr["contributions"],
              strategy="weighted", artifact=pr["artifact"], now=1.0)
    assert lin.build_record(**kw) == jlin.build_record(**kw)
    assert jlin.record_digest(pr) == pr["record_id"]
    assert lin.record_digest(jr) == jr["record_id"]
    for record, r in ((jr, jroot), (pr, root)):
        fetched = lin.fetch_record(LocalFSTransport(r), record["revision"])
        assert fetched == jlin.fetch_record(JFS(r), record["revision"])
        ours = lin.replay_record(LocalFSTransport(r), fetched, _template(),
                                 device="cpu")
        theirs = jlin.replay_record(JFS(r), fetched, _template())
        assert ours.ok and theirs.ok and ours.contributions == 2
        assert ours.max_abs_diff <= 1e-6 and theirs.max_abs_diff <= 1e-6
    # a superseded aggregate fails the audit loudly
    JFS(root).publish_delta(tbase.agg_id("n0"), _delta(9))
    with pytest.raises(lin.LineageError, match="superseded"):
        lin.replay_record(LocalFSTransport(root), pr, _template(),
                          device="cpu")


def test_mirror_duty_replicas_equal_jax(world, tmp_path):
    root = str(tmp_path / "port")
    jt = JFS(root)
    rev = jt.publish_base(_jtree(world["base"]))
    assert jbd.BasePublisher(jt, mirrors=["n0"]).publish_revision(
        _jtree(world["base"]), rev)
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)
    ours = tbd.MirrorDuty(LocalFSTransport(root), "n0")
    theirs = jbd.MirrorDuty(JFS(jroot), "n0")
    assert ours.sync() and theirs.sync()
    n = len(tbd.base_layer_items(world["base"]))
    assert ours.last_sync["shards"] == n
    mid = tbase.mirror_node_id("n0")
    for key in tbd.base_layer_items(world["base"]):
        mine = tbase.fetch_shard(LocalFSTransport(root), mid, key)
        ref = jtbase.fetch_shard(JFS(jroot), mid, key)
        assert mine is not None and mine == ref
        assert mine == tbase.fetch_base_shard(LocalFSTransport(root), key)
    assert LocalFSTransport(root).fetch_delta_meta(mid) == \
        JFS(jroot).fetch_delta_meta(mid) == {
            "mirror": {"revision": rev, "layers": n}}
    assert ours.sync() and ours.last_sync == {"shards": 0, "bytes": 0}
    # a fetcher reads every shard off the mirror the rider announces
    fetcher = tbd.BaseFetcher(LocalFSTransport(root))
    tree, frev = fetcher.fetch(_template())
    # (equal shards dedupe in the fetcher's store: zero biases, unit scales)
    assert frev == rev and fetcher.sharded_fetches_total == 1
    assert fetcher.mirror_hits_total == fetcher.network_shards_total > 0
    assert fetcher.mirror_hits_total + fetcher.store_hits_total == n
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(v, tdl.flatten_tree(world["base"])[k])
    # a monolithic-only averager: nothing to mirror
    bare = str(tmp_path / "bare")
    JFS(bare).publish_base(_jtree(world["base"]))
    assert not tbd.MirrorDuty(LocalFSTransport(bare), "n0").sync()


def test_hier_clis_on_cpu(world, tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    chain_dir = os.path.join(work, "chain")
    _fleet(world, os.path.join(work, "artifacts"), chain_dir)
    jbd.BasePublisher(JFS(os.path.join(work, "artifacts"))).publish_revision(
        _jtree(world["base"]),
        JFS(os.path.join(work, "artifacts")).base_revision())
    common = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--flight-events", "0",
              "--batch-size", "2", "--eval-batches", "2", "--eval-seq-len",
              "32", "--work-dir", work, "--rounds", "1",
              "--hier-nodes", "n0,n1"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(common + ["--hier", "sub", "--hier-node", "n0",
                                   "--hotkey", "hotkey_96"]) == 0
        assert tcli.main(common + ["--hier", "sub", "--hier-node", "n1",
                                   "--hier-wire-v2", "--no-lineage",
                                   "--hotkey", "hotkey_97"]) == 0
        assert tcli.main(common + ["--hier", "root", "--strategy",
                                   "weighted", "--publish-policy", "always",
                                   "--hotkey", "hotkey_95"]) == 0
        with pytest.raises(SystemExit, match="not in --hier-nodes"):
            tcli.main(common + ["--hier", "sub", "--hier-node", "n9"])
    finally:
        root.handlers[:], root.level = handlers, level
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    for n in NODES:
        assert t.fetch_delta_meta(tbase.agg_id(n))["agg"]["node"] == n
        assert t.fetch_delta_meta(tbase.mirror_node_id(n))["mirror"]
    # n0 froze an "agg" record; the root froze a base record over the
    # two aggregates, each contribution tagged with its tier
    rec = lin.fetch_record(t, t.base_revision())
    assert [c["hotkey"] for c in rec["contributions"]] == [
        tbase.agg_id("n0"), tbase.agg_id("n1")]
    assert all(c["tier"] == "agg" for c in rec["contributions"])
    agg_rev = t.delta_revision(tbase.agg_id("n0"))
    assert lin.fetch_record(t, agg_rev)["kind"] == "agg"
    assert json.loads(json.dumps(rec)) == rec
