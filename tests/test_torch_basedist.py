"""The port's sharded base distribution (engine/basedist.py, the base half
of serialization.py and transport/base.py) against the JAX package's, on
the CPU.

- Codec: base shard bytes, their sha256 digests and the manifest bytes
  equal the JAX package's for the same tree (a tiny GPT-2 from numpy);
  each package parses the other's manifest; hostile manifests parse as
  None in both.
- Mixed pulls over one LocalFS root: a JAX ``BasePublisher`` feeds the
  port's ``BaseFetcher`` (through a ``MinerLoop`` and a ``Validator``
  bootstrap) and the port's publisher feeds the JAX fetcher (and a JAX
  ``MinerLoop``); the assembled trees equal the monolithic base bit for
  bit, through the sharded path (no fallback). A warm pull fetches only
  the changed layer.
- Fallbacks: a hostile manifest, one whose hashes match nothing, a torn
  shard set and a manifest naming another revision all fall back to the
  monolithic pull, which seeds the store.
- The store's LRU and byte budget; the replica strikes and mirror order,
  step for step equal to the JAX fetcher's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.engine import basedist as jbd
from distributedtraining_tpu.transport import base as jtb
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import serialization as ser
from distributedtraining_tpu_torch.engine import basedist as bd
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.validate import Validator
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.transport import base as tb

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")


def _tree(seed=0):
    return tg.init_params_numpy(TINY, seed)


def _template():
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  _tree())


def _flat(tree):
    if any(isinstance(v, dict) for v in tree.values()):
        return {".".join(k): np.asarray(v) for k, v in _walk(tree)}
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bit_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def _publish(side, root, tree, mirrors=()):
    """Monolithic base, then the shard set and manifest, by ``side``'s
    publisher; returns (publisher, revision)."""
    if side == "jax":
        t = JFS(root)
        rev = t.publish_base(tree)
        pub = jbd.BasePublisher(t, mirrors=mirrors)
    else:
        t = LocalFSTransport(root)
        rev = t.publish_base(tree)
        pub = bd.BasePublisher(t, mirrors=mirrors)
    assert pub.publish_revision(tree, rev)
    return pub, rev


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def test_shard_digest_and_manifest_bytes_equal_jax():
    tree = _tree()
    ours = bd.base_layer_items(tree)
    ref = jbd.base_layer_items(tree)
    assert list(sorted(ours)) == list(sorted(ref))
    # the same keys from the port's state dict (".".joined -> "/")
    sd = tg.params_from_numpy(tree, device="cpu")
    assert sorted(bd.base_layer_items(sd)) == sorted(ref)
    layers = {}
    for k in ref:
        data = ser.pack_base_shard(ours[k])
        assert data == jser.pack_base_shard(ref[k])
        assert data == ser.pack_base_shard(sd[k.replace("/", ".")])
        assert ser.shard_digest(data) == jser.shard_digest(data)
        assert np.array_equal(ser.unpack_base_shard(data),
                              jser.unpack_base_shard(data))
        layers[k] = (ser.shard_digest(data), len(data))
    man = ser.build_base_manifest(layers, revision="rev-1")
    assert man == jser.build_base_manifest(layers, revision="rev-1")
    assert ser.parse_base_manifest(man) == jser.parse_base_manifest(man)
    assert ser.is_base_manifest(man) and not ser.is_wire_v2_manifest(man)
    for fn in (tb.base_shard_id, tb.lineage_id, tb.base_manifest_id,
               tb.lineage_slug):
        for s in ("h_0/attn/c_attn/kernel", "a/b.c", "r%1.2/x"):
            assert fn(s) == getattr(jtb, fn.__name__)(s)
    assert tb.pm_id("miner", "hk") == jtb.pm_id("miner", "hk")
    assert tb.mirror_node_id("m") == jtb.mirror_node_id("m")


@pytest.mark.parametrize("mutate", [
    lambda d: b"NOTMAGIC" + d[8:],
    lambda d: d[:8] + b"{garbage",
    lambda d: d[:8] + b'{"format":2,"layers":{}}',
    lambda d: d[:8] + b'{"format":1,"layers":{}}',
    lambda d: d[:8] + b'{"format":1,"revision":"r",'
                      b'"layers":{"k":{"h":"xx","n":1}}}',
    lambda d: d[:8] + b'{"format":1,"revision":"r","layers":'
                      b'{"k":{"h":"' + b"a" * 64 + b'","n":-1}}}',
    lambda d: d[:8] + b'{"format":1,"layers":'
                      b'{"k":{"h":"' + b"a" * 64 + b'","n":1}}}',
])
def test_hostile_manifests_parse_as_none_in_both(mutate):
    good = ser.build_base_manifest({"k": ("a" * 64, 1)}, revision="r")
    bad = mutate(good)
    assert ser.parse_base_manifest(bad) is None
    assert jser.parse_base_manifest(bad) is None


def test_assemble_checks_shape_and_dtype():
    tree = _tree()
    items = bd.base_layer_items(tree)
    tmpl = _template()
    assert _bit_equal(bd.assemble_base_tree(items, tmpl), tree)
    sd_tmpl = tg.params_from_numpy(tmpl, device="cpu")
    assert _bit_equal(bd.assemble_base_tree(items, sd_tmpl), tree)
    bad = dict(items, wte=items["wte"].astype(np.float64))
    assert bd.assemble_base_tree(bad, tmpl) is None
    bad = dict(items, wpe=items["wpe"][:-1])
    assert bd.assemble_base_tree(bad, tmpl) is None
    assert bd.assemble_base_tree({k: v for k, v in items.items()
                                  if k != "wte"}, tmpl) is None


# ---------------------------------------------------------------------------
# Mixed pulls
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    model, _ = tg.make_model(TINY)
    return ttrain.TrainEngine(model, device="cpu")


def test_jax_publisher_feeds_the_port_miner_and_validator(tmp_path,
                                                         engine):
    root = str(tmp_path)
    tree = _tree(1)
    _, rev = _publish("jax", root, tree)
    mono = LocalFSTransport(root).fetch_base(_template())[0]
    assert _bit_equal(mono, tree)
    # the miner's bootstrap pull goes through the manifest
    f = bd.BaseFetcher(LocalFSTransport(root))
    loop = ttrain.MinerLoop(engine, LocalFSTransport(root), "hotkey_1",
                            base_fetcher=f)
    loop.bootstrap()
    loop.close()
    assert loop._base_revision == rev
    assert _bit_equal(loop.base_params, tree)
    assert (f.sharded_fetches_total, f.fallbacks_total) == (1, 0)
    # identical layers (zero biases, unit scales) share one content hash
    assert f.network_shards_total + f.store_hits_total == len(
        bd.base_layer_items(tree))
    assert f.network_shards_total == len({
        ser.shard_digest(ser.pack_base_shard(v))
        for v in bd.base_layer_items(tree).values()})
    # the validator's too
    fv = bd.BaseFetcher(LocalFSTransport(root))
    val = Validator(engine, LocalFSTransport(root), None,
                    eval_batches=lambda: iter([]), cohort_size=1,
                    base_fetcher=fv)
    fetched = val._fetch_base_single()
    val.close()
    assert fetched[1] == rev and _bit_equal(fetched[0], tree)
    assert (fv.sharded_fetches_total, fv.fallbacks_total) == (1, 0)
    # a second JAX publish changes one leaf: the warm pull fetches it alone
    tree2 = jax.tree_util.tree_map(np.copy, tree)
    tree2["ln_f"]["scale"] = tree2["ln_f"]["scale"] + 1.0
    jt = JFS(root)
    rev2 = jt.publish_base(tree2)
    assert jbd.BasePublisher(jt).publish_revision(tree2, rev2)
    before = f.network_shards_total
    got = f.fetch(_template(), revision=rev2)
    assert got[1] == rev2 and _bit_equal(got[0], tree2)
    assert f.network_shards_total - before == 1
    assert f.fallbacks_total == 0


def test_port_publisher_feeds_the_jax_fetcher_and_miner(tmp_path):
    from distributedtraining_tpu.engine import train as jtrain
    from distributedtraining_tpu.models import gpt2 as jg
    root = str(tmp_path)
    tree = _tree(2)
    pub, rev = _publish("port", root, tree)
    assert pub.last_publish["shards_skipped"] == 0
    jf = jbd.BaseFetcher(JFS(root))
    got = jf.fetch(_template())
    assert got[1] == rev and _bit_equal(got[0], tree)
    assert (jf.sharded_fetches_total, jf.fallbacks_total) == (1, 0)
    jmodel, _ = jg.make_model(dataclasses.replace(jg.PRESETS["tiny"],
                                                  dtype="float32"))
    jf2 = jbd.BaseFetcher(JFS(root))
    jloop = jtrain.MinerLoop(jtrain.TrainEngine(jmodel), JFS(root),
                             "hotkey_2", base_fetcher=jf2)
    jloop.bootstrap()
    assert jloop._base_revision == rev
    assert _bit_equal(jax.device_get(jloop.base_params), tree)
    assert (jf2.sharded_fetches_total, jf2.fallbacks_total) == (1, 0)
    # the port's rider reads the same in both packages
    assert bd.read_base_wire_rider(LocalFSTransport(root)) == \
        jbd.read_base_wire_rider(JFS(root)) == {"revision": rev,
                                                "mirrors": []}
    # a re-publish of the same tree uploads no shard
    rev_b = LocalFSTransport(root).publish_base(tree)
    assert pub.publish_revision(tree, rev_b)
    assert pub.last_publish["shards_uploaded"] == 0


# ---------------------------------------------------------------------------
# Fallbacks
# ---------------------------------------------------------------------------

def _hostile(t, tree, rev):
    t.publish_raw(tb.base_manifest_id(rev),
                  ser.BASE_MANIFEST_MAGIC + b"{hostile")


def _bad_hashes(t, tree, rev):
    layers = {k: ("a" * 64, 10) for k in bd.base_layer_items(tree)}
    t.publish_raw(tb.base_manifest_id(rev),
                  ser.build_base_manifest(layers, revision=rev))


def _torn(t, tree, rev):
    bd.BasePublisher(t).publish_revision(tree, rev)
    # one (unique) shard's bytes flipped after the manifest landed
    data = bytearray(t.fetch_delta_bytes(tb.base_shard_id("wpe")))
    data[-1] ^= 0xFF
    t.publish_raw(tb.base_shard_id("wpe"), bytes(data))


def _other_revision(t, tree, rev):
    layers = {k: (ser.shard_digest(ser.pack_base_shard(v)), 1)
              for k, v in bd.base_layer_items(tree).items()}
    t.publish_raw(tb.base_manifest_id(rev),
                  ser.build_base_manifest(layers, revision="someone-else"))


@pytest.mark.parametrize("spoil", [_hostile, _bad_hashes, _torn,
                                   _other_revision])
def test_spoiled_manifests_fall_back_to_the_monolithic_pull(tmp_path,
                                                             spoil):
    t = LocalFSTransport(str(tmp_path))
    tree = _tree(3)
    rev = t.publish_base(tree)
    spoil(t, tree, rev)
    for fetcher in (bd.BaseFetcher(t), jbd.BaseFetcher(JFS(str(tmp_path)))):
        got = fetcher.fetch(_template())
        assert got is not None and got[1] == rev
        assert _bit_equal(got[0], tree)
        assert (fetcher.sharded_fetches_total,
                fetcher.fallbacks_total) == (0, 1)
    # the fallback seeded the port's store: a clean manifest for the same
    # tree (the same revision) then costs no shard bytes
    f = bd.BaseFetcher(t)
    f.fetch(_template())
    before = f.network_shards_total
    assert bd.BasePublisher(t).publish_revision(tree, rev)
    got = f.fetch(_template(), revision=rev)
    assert got[1] == rev and f.network_shards_total == before
    assert f.sharded_fetches_total == 1


def test_no_manifest_is_the_monolithic_pull_and_seeds_the_store(tmp_path):
    t = LocalFSTransport(str(tmp_path))
    assert bd.BaseFetcher(t).fetch(_template()) is None   # nothing published
    tree = _tree(4)
    rev = t.publish_base(tree)
    f = bd.BaseFetcher(t)
    got = f.fetch(_template())
    assert got[1] == rev and _bit_equal(got[0], tree)
    assert f.fallbacks_total == 1 and len(f.store) == len({
        ser.shard_digest(ser.pack_base_shard(v))
        for v in bd.base_layer_items(tree).values()})
    off = bd.BaseFetcher(t, store_bytes=0)     # no store: nothing seeded
    got = off.fetch(_template())
    assert _bit_equal(got[0], tree) and off.fallbacks_total == 1
    assert len(off.store) == 0


# ---------------------------------------------------------------------------
# Store and replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [bd, jbd], ids=["port", "jax"])
def test_store_lru_byte_budget(mod):
    store = mod.BaseShardStore(max_bytes=100)
    a = np.zeros(10, np.float32)   # 40 bytes
    store.put("d1", a)
    store.put("d2", a)
    assert len(store) == 2 and store.nbytes == 80
    store.put("d3", a)             # evicts d1, the least recently used
    assert store.lookup("d1") is None
    assert store.lookup("d2") is not None
    store.put("d4", a)             # d2 was looked up: d3 goes
    assert store.lookup("d3") is None and store.lookup("d2") is not None
    assert store.nbytes == 80
    store.put("big", np.zeros(1000, np.float32))   # over budget: refused
    assert store.lookup("big") is None
    off = mod.BaseShardStore(max_bytes=0)
    off.put("d", a)
    assert off.lookup("d") is None


def test_replica_strikes_and_order_match_jax(tmp_path):
    """Two announced mirrors: ``bad`` serves flipped bytes, ``good`` the
    right ones. Over fetches of changing bases both fetchers strike,
    bench and rotate the same way and count the same shards."""
    root = str(tmp_path)
    t = LocalFSTransport(root)
    port_f = bd.BaseFetcher(t, store_bytes=0)
    jax_f = jbd.BaseFetcher(JFS(root), store_bytes=0)
    pub = bd.BasePublisher(t, mirrors=["bad", "good"])
    for i in range(3):
        tree = _tree(10 + i)
        rev = t.publish_base(tree)
        assert pub.publish_revision(tree, rev)
        for k, v in bd.base_layer_items(tree).items():
            data = ser.pack_base_shard(v)
            tb.publish_shard(t, tb.mirror_node_id("good"), k, data)
            tb.publish_shard(t, tb.mirror_node_id("bad"), k,
                             data[:-1] + bytes([data[-1] ^ 1]))
        outs = [f.fetch(_template()) for f in (port_f, jax_f)]
        for got in outs:
            assert got[1] == rev and _bit_equal(got[0], tree)
        assert port_f._strikes == jax_f._strikes
        assert port_f._cooldown == jax_f._cooldown
        assert port_f._rotate == jax_f._rotate
        for attr in ("mirror_hits_total", "network_shards_total",
                     "bytes_fetched_total", "fallbacks_total",
                     "sharded_fetches_total"):
            assert getattr(port_f, attr) == getattr(jax_f, attr), attr
    assert port_f.mirror_hits_total > 0 and port_f.fallbacks_total == 0
