"""The port's wire v2 (delta.pack_delta_v2 and the packed screens,
serialization's shard container and manifest, engine/publish.py's shard
publish, engine/ingest.py's manifest-first staging, MinerLoop's
``wire_v2``) against the JAX package, on the CPU.

- Encoding: equal ``idx``, ``q`` and ``scale`` per leaf and a residual
  within 1e-7, with a leaf of tied magnitudes (``lax.top_k`` takes the
  lower index first; the port's stable descending sort does too).
- Verdicts: ``packed_matches``, ``screen_deltas`` and
  ``parse_wire_manifest`` agree on the same honest and hostile payloads.
- Bytes: ``pack_shard``, ``shard_digest`` and ``build_wire_manifest``
  equal the JAX package's for the same packed tree.
- Publish and ingest: unchanged layers are neither re-uploaded nor
  re-fetched, a torn shard set is a transient miss, and a JAX ingestor
  reads the port's shards as the port's does.
- MinerLoop: the error-feedback residual resets on a pull and survives a
  non-finite delta; ``wire_v2`` is refused with int8/sparse8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.engine import ingest as jingest
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.engine import ingest as tingest
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.publish import DeltaPublisher
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.transport.retry import RetryPolicy
from distributedtraining_tpu_torch.utils import obs

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
FAST = RetryPolicy(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)


def _delta_tree(seed: int, scale: float = 1e-2) -> dict:
    """A tiny GPT-2-shaped delta (nested numpy, the JAX layout)."""
    rng = np.random.default_rng(seed)
    base = tg.init_params_numpy(TINY, 0)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale
                   ).astype(np.float32), base)


def _template():
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  tg.init_params_numpy(TINY, 0))


def _state(tree):
    return {k: torch.from_numpy(np.array(v))
            for k, v in tdl.flatten_tree(tree).items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jpack(d, **kw):
    packed, res = jdl.pack_delta_v2(jax.tree_util.tree_map(jnp.asarray, d),
                                    **kw)
    return _np(packed), _np(res)


def _tpack(d, residual=None, **kw):
    packed, res = tdl.pack_delta_v2(
        _state(d), residual=None if residual is None else _state(residual),
        **kw)
    return packed, res


class _Report:
    pushes = pushes_failed = pushes_superseded = 0


def _publisher(transport, hotkey="m0", density=1.0 / 16.0, quant="int8"):
    return DeltaPublisher(transport, hotkey, report=_Report(),
                          publish_retry=FAST, meta_retry=FAST,
                          wire_spec={"format": 2, "density": density,
                                     "quant": quant})


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "none"])
def test_pack_delta_v2_matches_jax(quant):
    d = _delta_tree(1)
    # a leaf of tied magnitudes: 4096 of 8192 values at |1| for 128 slots
    rng = np.random.default_rng(2)
    tie = rng.choice(np.asarray([-1.0, 1.0, -0.5, 0.5], np.float32), 8192)
    d["tie"] = tie.reshape(64, 128)
    residual = jax.tree_util.tree_map(
        lambda x: (np.random.default_rng(3).standard_normal(np.shape(x))
                   * 1e-3).astype(np.float32), d)
    residual["tie"] = np.zeros((64, 128), np.float32)
    for r in (None, residual):
        jp, jres = _jpack(d, density=1.0 / 64.0, quant=quant, residual=r)
        tp, tres = _tpack(d, residual=r, density=1.0 / 64.0, quant=quant)
        assert int(tp[tdl.WIRE_V2_KEY]) == int(jp[jdl.WIRE_V2_KEY]) == 2
        j_entries = jdl.packed_layer_entries(jp)
        t_entries = tdl.packed_layer_entries(tp)
        assert sorted(j_entries) == sorted(t_entries)
        for key, je in j_entries.items():
            te = t_entries[key]
            for f in ("idx", "q", "scale"):
                assert te[f].dtype == je[f].dtype, (key, f)
                np.testing.assert_array_equal(te[f], je[f], err_msg=key)
        for key, v in tdl.flatten_tree(jres).items():
            np.testing.assert_allclose(tres[key].numpy(), v, atol=1e-7)
    assert t_entries["tie"]["idx"].shape[0] == 128


def test_densify_and_v1_decodes_match_jax():
    template = _template()
    d = _delta_tree(4)
    jp, _ = _jpack(d, density=1.0 / 8.0)
    ours = tdl.densify_packed_v2(jp, template)
    ref = _np(jdl.densify_packed_v2(jp, template))
    for (p, a), (_, b) in zip(tdl._walk_state_dict(ours),
                              tdl._walk_state_dict(ref)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    # sparse8 and int8 v1 artifacts, decoded from the JAX package's bytes
    sparse = jser.to_msgpack(_np(jdl.sparsify_delta(
        jax.tree_util.tree_map(jnp.asarray, d), density=1.0 / 8.0)))
    ours = tdl.sparse_delta_from_bytes(sparse, template)
    ref = jdl.sparse_delta_from_bytes(sparse, template)
    quant = jser.to_msgpack(_np(jdl.quantize_delta(
        jax.tree_util.tree_map(jnp.asarray, d))))
    ours_q = tingest.densify_delta_bytes(quant, template)
    ref_q = _np(jdl.dequantize_delta(jser.validated_load(
        quant, jdl.quantized_template(template), check_dtypes=True)))
    for mine, theirs in ((ours, ref), (ours_q, ref_q)):
        for (p, a), (_, b) in zip(tdl._walk_state_dict(mine),
                                  tdl._walk_state_dict(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


# ---------------------------------------------------------------------------
# Verdicts on honest and hostile payloads
# ---------------------------------------------------------------------------

def _honest():
    jp, _ = _jpack(_delta_tree(5), density=1.0 / 8.0)
    return jp


def _mutate(kind):
    p = _honest()
    e = p["leaves"]["wte"]
    if kind == "honest":
        pass
    elif kind == "negative_scale":
        e["scale"] = np.asarray(-1.0, np.float32)
    elif kind == "nan_scale":
        e["scale"] = np.asarray(np.nan, np.float32)
    elif kind == "idx_out_of_range":
        e["idx"] = e["idx"].copy()
        e["idx"][0] = 512 * 64
    elif kind == "idx_negative":
        e["idx"] = e["idx"].copy()
        e["idx"][3] = -1
    elif kind == "q_int16":
        e["q"] = e["q"].astype(np.int16)
    elif kind == "idx_int64":
        e["idx"] = e["idx"].astype(np.int64)
    elif kind == "scale_shape":
        e["scale"] = e["scale"].reshape(1)
    elif kind == "q_length":
        e["q"] = e["q"][:-1]
    elif kind == "missing_leaf":
        del p["leaves"]["wpe"]
    elif kind == "extra_leaf":
        p["leaves"]["extra"] = dict(e)
    elif kind == "extra_field":
        e["z"] = np.zeros((1,), np.float32)
    elif kind == "bad_marker":
        p[jdl.WIRE_V2_KEY] = np.int32(3)
    elif kind == "string_marker":
        p[jdl.WIRE_V2_KEY] = "2"
    elif kind == "f32_inf":
        e["q"] = e["q"].astype(np.float32)
        e["q"][1] = np.inf
    elif kind == "huge":
        e["scale"] = np.asarray(1e9, np.float32)
    return p


HOSTILE = ["honest", "negative_scale", "nan_scale", "idx_out_of_range",
           "idx_negative", "q_int16", "idx_int64", "scale_shape", "q_length",
           "missing_leaf", "extra_leaf", "extra_field", "bad_marker",
           "string_marker", "f32_inf", "huge"]


@pytest.mark.parametrize("kind", HOSTILE)
def test_packed_verdicts_match_jax(kind):
    template = _template()
    p = _mutate(kind)
    assert tdl.packed_matches(p, template) == jdl.packed_matches(p, template)
    for max_abs in (None, 1e3):
        assert (tdl.screen_deltas([p], template, max_abs=max_abs)
                == jdl.screen_deltas([p], template, max_abs=max_abs)), kind
    if kind == "honest":
        assert tdl.screen_deltas([p], template) == [(True, "ok")]
    if kind == "negative_scale":
        assert tdl.screen_deltas([p], template)[0] == (False,
                                                       "shape_mismatch")


@pytest.mark.parametrize("kind", ["honest", "nonfinite", "magnitude", "f64",
                                  "int_leaf", "missing", "bf16", "shape"])
def test_dense_verdicts_match_jax(kind):
    template = _template()
    d = _delta_tree(6)
    if kind == "nonfinite":
        d["wte"][0, 0] = np.nan
    elif kind == "magnitude":
        d["wpe"][1, 1] = 5e3
    elif kind == "f64":
        d["ln_f"]["scale"] = d["ln_f"]["scale"].astype(np.float64)
    elif kind == "int_leaf":
        d["ln_f"]["bias"] = d["ln_f"]["bias"].astype(np.int32)
    elif kind == "missing":
        del d["h_1"]
    elif kind == "shape":
        d["wpe"] = d["wpe"][:-1]
    jd = d
    if kind == "bf16":
        jd = dict(d, wte=d["wte"].astype(ml_dtypes.bfloat16))
        d = dict(d, wte=torch.from_numpy(d["wte"]).to(torch.bfloat16))
    for max_abs in (None, 1e3):
        ours = tdl.screen_deltas([d], template, max_abs=max_abs)
        ref = jdl.screen_deltas([jd], template, max_abs=max_abs)
        assert ours == ref, (kind, ours, ref)
        assert [tdl.screen_delta(d, template, max_abs=max_abs)] == ours


def _manifest_variants():
    good = jser.build_wire_manifest({"a/b": ("ab" * 32, 10), "c": ("0" * 64,
                                                                   3)},
                                    density=0.125, quant="int8")
    body = good[len(jser.WIRE_V2_MAGIC):]
    return {
        "honest": good,
        "no_magic": body,
        "not_json": jser.WIRE_V2_MAGIC + b"{nope",
        "format_3": good.replace(b'"format":2', b'"format":3'),
        "layers_list": jser.WIRE_V2_MAGIC + b'{"format":2,"layers":[]}',
        "short_hash": good.replace(b"ab" * 32, b"ab" * 31),
        "upper_hash": good.replace(b"ab" * 32, b"AB" * 32),
        "negative_n": good.replace(b'"n":10', b'"n":-1'),
        "float_n": good.replace(b'"n":10', b'"n":1.5'),
        "long_key": jser.WIRE_V2_MAGIC + (
            '{"format":2,"layers":{"%s":{"h":"%s","n":1}}}'
            % ("k" * 600, "0" * 64)).encode(),
        "string_density": good.replace(b'"density":0.125',
                                       b'"density":"x"'),
        "int_quant": good.replace(b'"quant":"int8"', b'"quant":7'),
        "oversize": good + b" " * (1 << 20),
    }


@pytest.mark.parametrize("kind", sorted(_manifest_variants()))
def test_parse_wire_manifest_matches_jax(kind):
    data = _manifest_variants()[kind]
    assert tser.is_wire_v2_manifest(data) == jser.is_wire_v2_manifest(data)
    assert tser.parse_wire_manifest(data) == jser.parse_wire_manifest(data)
    assert (tser.parse_wire_manifest(data) is not None) == (
        kind in ("honest", "string_density", "int_quant"))


# ---------------------------------------------------------------------------
# Bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "none"])
def test_shard_and_manifest_bytes_equal_jax(quant):
    d = _delta_tree(7)
    jp, _ = _jpack(d, density=1.0 / 16.0, quant=quant)
    tp, _ = _tpack(d, density=1.0 / 16.0, quant=quant)
    layers = {}
    for key, je in jdl.packed_layer_entries(jp).items():
        te = tdl.packed_layer_entries(tp)[key]
        jb, tb = jser.pack_shard(je), tser.pack_shard(te)
        assert tb == jb, key
        assert tser.shard_digest(tb) == jser.shard_digest(jb)
        layers[key] = (tser.shard_digest(tb), len(tb))
        back = tser.unpack_shard(tb)
        for f in ("idx", "q", "scale"):
            np.testing.assert_array_equal(back[f], je[f])
    assert (tser.build_wire_manifest(layers, density=1.0 / 16.0,
                                     quant=quant)
            == jser.build_wire_manifest(layers, density=1.0 / 16.0,
                                        quant=quant))


# ---------------------------------------------------------------------------
# Publish and ingest
# ---------------------------------------------------------------------------

def _stage(transport, **kw):
    ing = tingest.DeltaIngestor(transport, _template(), densify=False,
                                workers=1, **kw)
    try:
        return ing.stage(["m0"])[0], ing
    finally:
        ing.close()


def test_publish_dedupes_unchanged_shards_and_ingest_reuses_them():
    t = InMemoryTransport()
    pub = _publisher(t)
    d = _delta_tree(8)
    tp, _ = _tpack(d, density=1.0 / 16.0)
    obs.configure()
    try:
        assert pub.publish_now(tp, None, "rev0", "m0-000001")
        n_layers = len(tdl.packed_layer_entries(tp))
        snap = obs.flush()
        assert snap["wire.shards_uploaded"] == n_layers
        assert snap["wire.manifest_publishes"] == 1
        meta = t.fetch_delta_meta("m0")
        assert meta["wire"] == {"format": 2, "density": 1.0 / 16.0,
                                "quant": "int8"}
        assert meta["base_revision"] == "rev0"
        ing = tingest.DeltaIngestor(t, _template(), densify=False,
                                    workers=1)
        (s,) = ing.stage(["m0"])
        assert s.reason == "ok" and tdl.is_packed_v2(s.delta)
        # one layer changes: one shard up, the rest reused on both sides
        d["wpe"] = d["wpe"] * 2
        tp2, _ = _tpack(d, density=1.0 / 16.0)
        assert pub.publish_now(tp2, None, "rev0")
        snap = obs.flush()
        assert snap["wire.shards_uploaded"] == n_layers + 1
        assert snap["wire.shards_skipped"] == n_layers - 1
        (s2,) = ing.stage(["m0"])
        ing.close()
        snap = obs.flush()
        assert s2.reason == "ok"
        assert snap["wire.shards_deduped"] == n_layers - 1
        assert snap.get("delta.densify_fallbacks", 0) == 0
        assert s2.wire_bytes < s.wire_bytes
    finally:
        obs.reset()
        pub.close()


def test_torn_shard_set_is_a_transient_miss():
    from distributedtraining_tpu_torch.transport import base as tbase
    t = InMemoryTransport()
    pub = _publisher(t)
    tp, _ = _tpack(_delta_tree(9), density=1.0 / 16.0)
    assert pub.publish_now(tp, None, "rev0")
    # a publisher that died after overwriting one shard, before the
    # manifest: the old manifest names a hash the shard no longer has
    good = tbase.fetch_shard(t, "m0", "wte")
    t.publish_raw(tbase.shard_id("m0", "wte"), good + b"\x00")
    obs.configure()
    try:
        ing = tingest.DeltaIngestor(t, _template(), densify=False,
                                    workers=1)
        (s,) = ing.stage(["m0"])
        assert (s.reason, s.delta) == ("no_delta", None)
        assert obs.flush()["wire.torn_fetches"] == 1
        # not cached as a verdict: once the shard is whole again, the
        # same manifest stages
        t.publish_raw(tbase.shard_id("m0", "wte"), good)
        (s,) = ing.stage(["m0"])
        ing.close()
        assert s.reason == "ok"
    finally:
        obs.reset()
        pub.close()


def test_jax_ingest_reads_the_ports_shards(tmp_path):
    root = str(tmp_path / "artifacts")
    pub = _publisher(LocalFSTransport(root), quant="none")
    tp, _ = _tpack(_delta_tree(10), density=1.0 / 16.0, quant="none")
    assert pub.publish_now(tp, None, "rev0")
    pub.close()
    jing = jingest.DeltaIngestor(JFS(root), _template(), densify=False,
                                 workers=1)
    (js,) = jing.stage(["m0"])
    jing.close()
    (ts, _) = _stage(LocalFSTransport(root))
    assert js.reason == ts.reason == "ok"
    jent = jdl.packed_layer_entries(js.delta)
    for key, te in tdl.packed_layer_entries(ts.delta).items():
        for f in ("idx", "q", "scale"):
            np.testing.assert_array_equal(te[f], jent[key][f])


# ---------------------------------------------------------------------------
# MinerLoop with wire_v2
# ---------------------------------------------------------------------------

def _loop(transport, **kw):
    model, _ = tg.make_model(TINY)
    eng = ttrain.TrainEngine(model, device="cpu")
    kw = {"wire_density": 1.0 / 16.0, **kw}
    return ttrain.MinerLoop(eng, transport, "m0", clock=FakeClock(),
                            send_interval=1e9, check_update_interval=1e9,
                            wire_v2=True, **kw)


def test_miner_residual_resets_on_pull_and_survives_nonfinite():
    t = InMemoryTransport()
    t.publish_base(tg.init_params_numpy(TINY, 0))
    loop = _loop(t)
    loop.bootstrap()
    with torch.no_grad():
        for v in loop.state.params.values():
            v.add_(torch.randn_like(v) * 1e-3)
    packed, finite = loop._push_snapshot()
    assert bool(finite) and tdl.is_packed_v2(packed)
    res = {k: v.clone() for k, v in loop._wire_residual.items()}
    d = tdl.compute_delta(loop.state.params, loop.base_params)
    _, expect = tdl.pack_delta_v2(d, density=1.0 / 16.0,
                                  residual={k: torch.zeros_like(v)
                                            for k, v in d.items()})
    for k in res:
        torch.testing.assert_close(res[k], expect[k], rtol=0, atol=0)
    # a non-finite delta: no push, and the residual stays as it was
    with torch.no_grad():
        loop.state.params["wte"][0, 0] = float("nan")
    _, finite = loop._push_snapshot()
    assert not bool(finite)
    for k in res:
        torch.testing.assert_close(loop._wire_residual[k], res[k], rtol=0,
                                   atol=0)
    assert not loop._publisher.publish_now(*loop._push_snapshot(), None)
    # a base pull restarts the residual
    t.publish_base(tg.init_params_numpy(TINY, 1))
    loop._check_pull()
    assert loop.report.base_pulls == 1 and loop._wire_residual is None
    loop.close()


def test_miner_wire_v2_refuses_v1_compressed_forms():
    for dtype in ("int8", "sparse8"):
        with pytest.raises(ValueError, match="wire_v2 replaces"):
            _loop(InMemoryTransport(), delta_dtype=dtype)
    with pytest.raises(ValueError, match="wire_density"):
        _loop(InMemoryTransport(), wire_density=0.0)
    with pytest.raises(ValueError, match="wire_quant"):
        _loop(InMemoryTransport(), wire_quant="int4")
