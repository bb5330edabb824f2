"""The validator and the averager of the PyTorch port on a mesh
(parallel/collectives.py's merge, serialization's wire-v2 blob,
engine/ingest.py's pod path, engine/batched_eval.py's mesh spelling,
the pod paths of engine/validate.py and engine/average.py, and the
entry points under ``--multihost-*``) against the JAX package, on the
CPU; and the two repairs of the pod start-up (a server or router run as
several processes, and the signing identity of a world).

JAX runs in-process on the host devices of tests/conftest.py (a dp 2 or
dp 4 mesh); the port runs one process a rank over gloo
(tests/torch_mesh_worker.py, which imports no JAX), one spawn per world
for every case of it, with a timeout on each spawn and join. Inputs are
made with numpy from a seed; the models are the tiny GPT-2 at f32 on
both sides. Tolerances: merges 1e-6; losses and scores the validator
tests' 1e-5 relative and four ulps of the loss; averaged bases rtol
1e-5, atol 1e-6 (JAX's own mesh-against-host fixture,
tests/test_parallel.py::test_averager_round_on_mesh_matches_host);
bucket arithmetic, verdicts, blob bytes and staged deltas exact.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.data import (ByteTokenizer, batch_iterator,
                                          text_corpus)
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import GeneticMerge as JGM
from distributedtraining_tpu.engine.average import \
    ParameterizedMerge as JPM
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.batched_eval import \
    BatchedCohortEvaluator as JEval
from distributedtraining_tpu.engine.ingest import DeltaIngestor as JIngest
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.engine.scheduler import FakeClock as JClock
from distributedtraining_tpu.engine.validate import Validator as JValidator
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.parallel import MeshConfig as JMeshConfig
from distributedtraining_tpu.parallel import collectives as jcoll
from distributedtraining_tpu.parallel import make_mesh
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport import base as jtbase
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.parallel import collectives as tcoll
from distributedtraining_tpu_torch.transport import LocalFSTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
SPAWN_TIMEOUT = 300
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
FSDP_TP = {"fsdp": 2, "tp": 2}
STAGED = ("hotkey_1", "hotkey_2", "hotkey_3", "hotkey_4", "hotkey_5",
          "hotkey_6")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["DT_FORCE_PLATFORM"] = "cpu"
    return env


def _wait(procs) -> list[str]:
    """Every process's output; each one killed past SPAWN_TIMEOUT."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _run_world(io_dir, world: int, inputs: dict, args: dict) -> list[dict]:
    """Every case of ``args["cases"]`` on a gloo world of ``world`` ranks;
    each rank's outputs, in rank order."""
    os.makedirs(io_dir, exist_ok=True)
    np.savez(os.path.join(io_dir, "inputs.npz"), **inputs)
    with open(os.path.join(io_dir, "args.json"), "w") as f:
        json.dump(args, f)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                               port, str(io_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env())
             for r in range(world)]
    outs = _wait(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(os.path.join(io_dir, f"out_{r}.npz")))
            for r in range(world)]


def _run_cli(io_dir, role: str, argv: list, world: int = 2):
    """``role``'s entry point as ``world`` processes joined by the
    ``--multihost-*`` flags: ``(return codes, outputs, results)``, a
    result None where the process ended before writing one."""
    os.makedirs(io_dir, exist_ok=True)
    port = _free_port()
    rank_argv = [["--multihost-coordinator", f"127.0.0.1:{port}",
                  "--multihost-processes", str(world), "--multihost-id",
                  str(r)] for r in range(world)]
    with open(os.path.join(io_dir, "args.json"), "w") as f:
        json.dump({"role": role, "argv": argv, "rank_argv": rank_argv}, f)
    procs = [subprocess.Popen([sys.executable, WORKER, "cli", str(r),
                               str(io_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=REPO)
             for r in range(world)]
    outs = _wait(procs)
    results = []
    for r in range(world):
        path = os.path.join(io_dir, f"cli_{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    return [p.returncode for p in procs], outs, results


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            tdl.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                    tree)).items()}


def _jmesh(n: int, shape: dict | None = None):
    return make_mesh(JMeshConfig(**(shape or {"dp": n})),
                     devices=jax.devices()[:n])


class _FastPub:
    pushes = pushes_failed = pushes_superseded = 0


def _jpublish_v2(jt, hotkey, packed, rev, cid):
    fast = JRetry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)
    pub = JPub(jt, hotkey, report=_FastPub(), publish_retry=fast,
               meta_retry=fast,
               wire_spec={"format": 2, "density": 1.0 / 16.0,
                          "quant": "int8"})
    assert pub.publish_now(packed, None, rev, cid)
    pub.close()


# ---------------------------------------------------------------------------
# The fleet and the worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A JAX-initialized f32 tiny base; a root of six submissions for the
    stage and the validator (dense v1, int8 v1, a wire-v2 manifest, a
    torn shard set, a stale delta, a missing one); two roots of JAX's
    averager fixture (three constant deltas 0.005 (i + 1)); the merge's
    inputs (three bf16 deltas and their weights) and two eval batches."""
    rng = np.random.default_rng(0)
    jmodel, _ = jg.make_model(JTINY)
    base_tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    base = _flat(base_tree)
    docs = text_corpus(split="train", n_docs=64, source="synthetic")
    it = batch_iterator(docs, ByteTokenizer(), batch_size=8, seq_len=32,
                        repeat=True, max_vocab=JTINY.vocab_size)
    val_ids = np.stack([np.asarray(next(it)["input_ids"])
                        for _ in range(2)])

    def noise(scale):
        return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                for k, v in base.items()}

    d = {h: noise(2e-3) for h in ("hotkey_1", "hotkey_2", "hotkey_3",
                                  "hotkey_4", "hotkey_5")}
    root = str(tmp_path_factory.mktemp("fleet") / "artifacts")
    jt = JFS(root)
    rev = jt.publish_base(jax.tree_util.tree_map(jnp.asarray, base_tree))
    jt.publish_delta("hotkey_1", tdl.nest_tree(d["hotkey_1"]))
    jt.publish_delta_meta("hotkey_1", {"base_revision": rev,
                                       "delta_id": "cid-1"})
    jt.publish_delta("hotkey_2", jax.tree_util.tree_map(
        np.asarray, jdl.quantize_delta(jax.tree_util.tree_map(
            jnp.asarray, tdl.nest_tree(d["hotkey_2"])))))
    jt.publish_delta_meta("hotkey_2", {"base_revision": rev,
                                       "delta_id": "cid-2"})
    packs = {}
    for h in ("hotkey_3", "hotkey_4"):
        packed, _ = jdl.pack_delta_v2(jax.tree_util.tree_map(
            jnp.asarray, tdl.nest_tree(d[h])), density=1.0 / 16.0,
            quant="int8")
        packs[h] = jax.tree_util.tree_map(np.asarray, packed)
        _jpublish_v2(jt, h, packs[h], rev, f"cid-{h[-1]}")
    # a torn set: one shard of hotkey_4's manifest replaced by other bytes
    layer, entry = next(iter(jdl.packed_layer_entries(
        packs["hotkey_3"]).items()))
    jtbase.publish_shard(jt, "hotkey_4", layer, jser.pack_shard(entry))
    jt.publish_delta("hotkey_5", tdl.nest_tree(d["hotkey_5"]))
    jt.publish_delta_meta("hotkey_5", {"base_revision": "old",
                                       "delta_id": "cid-5"})
    # JAX's averager fixture: three constant deltas on the base
    avg_roots = {}
    for name in ("weighted", "param", "genetic", "retry"):
        r = str(tmp_path_factory.mktemp(f"avg_{name}") / "artifacts")
        t = JFS(r)
        t.publish_base(jax.tree_util.tree_map(jnp.asarray, base_tree))
        for i in range(3):
            t.publish_delta(f"hotkey_{i}", jax.tree_util.tree_map(
                lambda x, s=i + 1: 0.005 * s * np.ones_like(x), base_tree))
        avg_roots[name] = r
    merge_d = [{k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                for k, v in noise(1e-2).items()} for _ in range(3)]
    w = rng.random(3).astype(np.float32)
    w /= w.sum()
    inputs = {"val_ids": val_ids, "w": w}
    inputs.update({f"base/{k}": v for k, v in base.items()})
    for i, md in enumerate(merge_d):
        inputs.update({f"d{i}/{k}": v for k, v in md.items()})
    return {"base_tree": base_tree, "base": base, "root": root, "rev": rev,
            "avg_roots": avg_roots, "merge_d": merge_d, "w": w,
            "val": [{"input_ids": x} for x in val_ids], "inputs": inputs,
            "jmodel": jmodel, "tmp": tmp_path_factory}


def _world(fleet, n: int, cases: list[str], mesh: dict | None = None
           ) -> list[dict]:
    d = fleet["tmp"].mktemp(f"world{n}")
    roots = {"root_empty": str(d / "avg_empty")}
    os.makedirs(roots["root_empty"])
    for name, src in fleet["avg_roots"].items():
        roots[f"root_{name}"] = str(d / f"avg_{name}")
        shutil.copytree(src, roots[f"root_{name}"])
    return _run_world(str(d / "io"), n, fleet["inputs"], {
        "cases": cases, "root": fleet["root"], "rev": fleet["rev"],
        "hotkeys": list(STAGED), "chain_dir": str(d / "chain"),
        "mesh": mesh or {"dp": n}, **roots})


@pytest.fixture(scope="module")
def world2(fleet):
    return _world(fleet, 2, ["merge", "stage", "eval", "validator",
                             "avg_weighted", "avg_param", "avg_genetic",
                             "avg_publish_fail"])


@pytest.fixture(scope="module")
def world4(fleet):
    return _world(fleet, 4, ["merge", "avg_weighted", "avg_param"])


@pytest.fixture(scope="module")
def world4_fsdp_tp(fleet):
    """Four ranks on fsdp 2 x tp 2: the merge axis is fsdp, and the
    engine splits every parameter (its evaluations take the shard
    branch of ``TrainEngine.local``)."""
    return _world(fleet, 4, ["validator", "avg_weighted"], FSDP_TP)


# ---------------------------------------------------------------------------
# The merge collectives
# ---------------------------------------------------------------------------

class _Shape:
    """A mesh's shape alone: what merge_axis and merge_bucket read."""

    def __init__(self, shape: dict):
        self.shape = shape


@pytest.mark.parametrize("shape", [
    {"dp": 2, "fsdp": 1, "sp": 1, "tp": 1},
    {"dp": 2, "fsdp": 2, "sp": 1, "tp": 2},
    {"dp": 1, "fsdp": 4, "sp": 1, "tp": 2},
    {"dp": 1, "fsdp": 1, "sp": 1, "tp": 4},
])
def test_merge_bucket_and_axis_match_jax(devices, shape):
    """The merge axis (ties prefer dp), the bucket ladder rounded to a
    multiple of it, and the preference for dispatched buckets, query for
    query, on the same mesh shape."""
    jmesh = make_mesh(JMeshConfig(**shape))
    tmesh = _Shape(dict(jmesh.shape))
    assert tcoll.merge_axis(tmesh) == jcoll.merge_axis(jmesh)
    jcoll.reset_merge_cache()
    tcoll.reset_merge_cache()
    try:
        for m in (1, 2, 3, 5, 8, 9, 17, 33):
            assert tcoll.merge_bucket(m, tmesh) == \
                jcoll.merge_bucket(m, jmesh), m
            assert tcoll.merge_bucket(m) == jcoll.merge_bucket(m), m
        axis = jcoll.merge_axis(jmesh)
        big = jcoll.merge_bucket(16, jmesh)
        assert tcoll.mark_merge_bucket(big, tmesh, axis) == \
            jcoll.mark_merge_bucket(big, jmesh, axis) is True
        assert tcoll.mark_merge_bucket(big, tmesh, axis) == \
            jcoll.mark_merge_bucket(big, jmesh, axis) is False
        for m in (1, 3, 5, 17):
            assert tcoll.merge_bucket(m, tmesh) == \
                jcoll.merge_bucket(m, jmesh), m
        with pytest.raises(ValueError):
            tcoll.merge_bucket(0)
    finally:
        jcoll.reset_merge_cache()
        tcoll.reset_merge_cache()


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_cohort_merge_matches_jax(devices, fleet, n, request):
    """M = 3 bf16 deltas into the f32 base on a world of 2 and of 4
    (padding live): each rank's block is P(dp)'s slice of the bucketed
    stack, and the merge, replicated on every rank, is JAX's
    ``sharded_cohort_merge`` on a dp n mesh within 1e-6; the same deltas
    in f32 through the port's one path give JAX's
    ``psum_weighted_merge`` of the full f32 stack."""
    ranks = request.getfixturevalue(f"world{n}")
    mesh = _jmesh(n)
    axis = jcoll.merge_axis(mesh)
    jcoll.reset_merge_cache()
    m_pad = jcoll.merge_bucket(3, mesh, axis)
    bf16 = [jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   tdl.nest_tree(d)) for d in fleet["merge_d"]]
    base = jax.tree_util.tree_map(jnp.asarray, fleet["base_tree"])
    stacked = jcoll.stack_deltas_sharded(bf16, mesh, axis, target=m_pad)
    want = _flat(jcoll.sharded_cohort_merge(base, stacked,
                                            jnp.asarray(fleet["w"]), mesh,
                                            axis=axis))
    full = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jax.tree_util.tree_map(jnp.asarray, tdl.nest_tree(d))
          for d in fleet["merge_d"]])
    want_psum = _flat(jcoll.psum_weighted_merge(
        base, full, jnp.asarray(fleet["w"]), mesh, axis=axis))
    jcoll.reset_merge_cache()
    for r, out in enumerate(ranks):
        assert str(out["merge/axis"]) == axis
        assert int(out["merge/m_pad"]) == m_pad == 4
        assert int(out["merge/k_local"]) == m_pad // n
        assert int(out["merge/start"]) == r * (m_pad // n)
        for k, v in want.items():
            np.testing.assert_allclose(out[f"merge/merged/{k}"], v,
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(out[f"merge/merged_f32/{k}"],
                                       want_psum[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_a_sharded_stack_holds_only_its_block():
    """Without a world: ``stack_deltas_sharded`` on a stand-in mesh
    (coordinates only) keeps P(dp)'s slice of the padded stack (zero
    deltas in the padding slots, each key in its promoted dtype), pads
    to the next multiple of the axis without a target, and refuses a
    target the axis does not divide."""

    class Mesh2:
        shape = {"dp": 2, "fsdp": 1, "sp": 1, "tp": 1}
        coords = {"dp": 1, "fsdp": 0, "sp": 0, "tp": 0}

        def size(self, axis):
            return self.shape[axis]

    deltas = [{"a": np.full(2, i, np.float32),
               "b": np.full(3, i, np.float16 if i else np.float32)}
              for i in range(3)]
    st = tcoll.stack_deltas_sharded(deltas, Mesh2(), "dp")
    assert (st.m_pad, st.k_local, st.start) == (4, 2, 2)
    np.testing.assert_array_equal(st.block["a"].numpy(), [[2, 2], [0, 0]])
    assert st.block["b"].dtype == tcoll.torch.float32
    st8 = tcoll.stack_deltas_sharded(deltas, Mesh2(), "dp", target=8)
    assert (st8.m_pad, st8.k_local, st8.start) == (8, 4, 4)
    assert not st8.block["a"].any()
    with pytest.raises(ValueError, match="does not divide"):
        tcoll.stack_deltas_sharded(deltas, Mesh2(), "dp", target=5)
    with pytest.raises(ValueError, match="empty"):
        tcoll.stack_deltas_sharded([], Mesh2(), "dp")


# ---------------------------------------------------------------------------
# The wire-v2 blob
# ---------------------------------------------------------------------------

def test_wire_blob_bytes_match_jax(fleet):
    """``pack_wire_blob`` gives JAX's bytes for the same packed tree, each
    package's ``unpack_wire_blob`` densifies either's blob to the same
    delta, a truncated blob reads as None, and ``densify_delta_bytes``
    takes a blob as JAX's ``densify_delta_bytes`` does."""
    from distributedtraining_tpu.engine.lora_train import \
        densify_delta_bytes as jdensify
    from distributedtraining_tpu_torch.engine.ingest import \
        densify_delta_bytes as tdensify
    packed, _ = jdl.pack_delta_v2(jax.tree_util.tree_map(
        jnp.asarray, tdl.nest_tree({k: v * 0 + 1e-3 * np.arange(
            v.size, dtype=np.float32).reshape(v.shape) % 0.07
            for k, v in fleet["base"].items()})), density=1.0 / 16.0,
        quant="int8")
    packed = jax.tree_util.tree_map(np.asarray, packed)
    blob = tser.pack_wire_blob(packed)
    assert blob == jser.pack_wire_blob(packed)
    assert tser.is_wire_v2_blob(blob) and not tser.is_wire_v2_blob(blob[4:])
    template = jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.float32), fleet["base_tree"])
    want = _flat(jser.unpack_wire_blob(blob, template))
    for got in (tser.unpack_wire_blob(blob, template),
                tdensify(blob, template)):
        got = _flat(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        _flat(jdensify(blob, template))["wte"], want["wte"])
    assert tser.unpack_wire_blob(blob[:-7], template) is None
    assert jser.unpack_wire_blob(blob[:-7], template) is None


# ---------------------------------------------------------------------------
# The pod's ingest, cohort evaluation and validator round
# ---------------------------------------------------------------------------

def test_stage_multi_matches_jax_single_host(fleet, world2):
    """``stage(multi=True)`` at world 2 over dense, int8, wire-v2, torn,
    stale and missing submissions: the same verdicts, revisions, cids and
    dense deltas on both ranks and in JAX's single-host stage; rank 1
    never touches the transport."""
    from distributedtraining_tpu.engine.train import host_wire_template
    jeng = jtrain.TrainEngine(fleet["jmodel"])
    ing = JIngest(JFS(fleet["root"]), lambda: host_wire_template(jeng),
                  stale_deltas="skip", workers=4)
    want = ing.stage(list(STAGED), base_revision=fleet["rev"])
    ing.close()
    r0, r1 = world2
    v0 = json.loads(str(r0["stage/verdicts"]))
    assert v0 == json.loads(str(r1["stage/verdicts"]))
    assert v0 == [[s.hotkey, s.reason, s.revision, s.cid] for s in want]
    assert [v[1] for v in v0] == ["ok", "ok", "ok", "no_delta",
                                  "stale_base", "no_delta"]
    assert int(r0["stage/transport_calls"]) > 0
    assert int(r1["stage/transport_calls"]) == 0
    for s in want:
        keys = sorted(k for k in r0 if k.startswith(f"stage/delta/"
                                                    f"{s.hotkey}/"))
        if s.delta is None:
            assert not keys
            continue
        jd = _flat(s.delta)
        assert len(keys) == len(jd)
        for k, v in jd.items():
            key = f"stage/delta/{s.hotkey}/{k}"
            np.testing.assert_array_equal(r0[key], r1[key])
            np.testing.assert_array_equal(r0[key], v, err_msg=key)


def test_batched_evaluator_on_mesh_matches_jax(fleet, world2):
    """k = 3 candidates at world 2: the bucket (4), each rank's block of
    real candidates (rank 0 slots 0-1, rank 1 slot 2; slot 3 is padding
    and not evaluated), and every (loss, perplexity) on both ranks within
    1e-5 of JAX's ``BatchedCohortEvaluator`` on a dp 2 mesh."""
    jeng = jtrain.TrainEngine(fleet["jmodel"], mesh=_jmesh(2))
    jev = JEval(jeng)
    base = jeng.place_params(jax.tree_util.tree_map(jnp.asarray,
                                                    fleet["base_tree"]))
    want = jev.evaluate_cohort(
        base, [jax.tree_util.tree_map(jnp.asarray, tdl.nest_tree(
            {k[3:]: v for k, v in fleet["inputs"].items()
             if k.startswith(f"d{i}/")})) for i in range(3)],
        iter(fleet["val"]))
    assert jev.bucket_for(3) == 4
    for r, out in enumerate(world2):
        assert int(out["eval/bucket"]) == 4
        assert int(out["eval/candidate_batches"]) == (2 if r == 0 else 1) * 2
        np.testing.assert_allclose(out["eval/scores"], np.array(want),
                                   rtol=1e-5, atol=0)


def _check_validator_round(fleet, ranks, jdir, shape: dict) -> None:
    """A validator round on the world ``ranks`` against JAX's
    ``Validator`` on a mesh engine of the same shape: the same base loss
    (1e-5), reasons and scores (four ulps of the loss), the same on
    every rank, exactly one ``set_weights`` (the coordinator's), and no
    transport read off the coordinator."""
    n = len(ranks)
    jv = JValidator(jtrain.TrainEngine(fleet["jmodel"],
                                       mesh=_jmesh(n, shape)),
                    JFS(fleet["root"]),
                    JChain(str(jdir), my_hotkey="hotkey_91"),
                    eval_batches=lambda: iter(fleet["val"]), cohort_size=8,
                    stale_deltas="accept")
    jv.bootstrap()
    want = {s.hotkey: s for s in jv.validate_and_score()}
    jv.close()
    rows = [json.loads(str(out["validator/scores"])) for out in ranks]
    assert all(r == rows[0] for r in rows[1:])
    got = {h: (score, loss, reason) for h, score, loss, reason in rows[0]}
    assert set(got) == set(want) and len(got) == 99
    for out in ranks:
        assert float(out["validator/base_loss"]) == pytest.approx(
            jv.base_loss, rel=1e-5)
    for h, s in want.items():
        score, loss, reason = got[h]
        assert reason == s.reason, h
        if s.loss is None:
            assert loss is None and score == 0.0
            continue
        assert loss == pytest.approx(s.loss, rel=1e-5, abs=0), h
        ulp = float(np.spacing(np.float32(max(s.loss, jv.base_loss))))
        assert abs(score - s.score) <= max(1e-6, 4 * ulp), h
    assert [got[h][2] for h in STAGED] == ["ok", "ok", "ok", "no_delta",
                                           "ok", "no_delta"]
    assert [int(out["validator/set_weights"]) for out in ranks] == \
        [1] + [0] * (n - 1)
    assert all(int(out["validator/transport_calls"]) == 0
               for out in ranks[1:])


def test_validator_round_on_mesh_matches_jax(fleet, world2, tmp_path):
    """A validator round at world 2 (cohort 8, stale deltas accepted)
    against JAX's ``Validator`` on a dp 2 mesh engine
    (``_check_validator_round``)."""
    _check_validator_round(fleet, world2, tmp_path / "jchain", {"dp": 2})
    # 4 valid candidates: a bucket of 4, two a rank, 2 eval batches; the
    # base in its own cohort on rank 0
    assert [int(out["validator/candidate_batches"]) for out in world2] == \
        [(1 + 2) * 2, 2 * 2]


def test_validator_round_on_fsdp_tp_mesh_matches_jax(fleet, world4_fsdp_tp,
                                                     tmp_path):
    """The same round at world 4 on fsdp 2 x tp 2 against JAX's on the
    same mesh shape. The candidates are sharded over fsdp (the merge
    axis), so the ranks that differ only in tp evaluate the same block:
    ranks 0 and 1 (fsdp 0) the base and two candidates, ranks 2 and 3
    the other two."""
    _check_validator_round(fleet, world4_fsdp_tp, tmp_path / "jchain",
                           FSDP_TP)
    assert [int(out["validator/candidate_batches"])
            for out in world4_fsdp_tp] == [(1 + 2) * 2] * 2 + [2 * 2] * 2


# ---------------------------------------------------------------------------
# The averager's round
# ---------------------------------------------------------------------------

def _jax_avg(fleet, strategy: str, n: int, shape: dict | None = None):
    """JAX's averager round on the fixture, on a mesh of ``shape``
    (default dp n): ``(base, the strategy's winning weights)``."""
    jmodel = fleet["jmodel"]
    transport = JMem()
    transport.publish_base(jax.tree_util.tree_map(jnp.asarray,
                                                  fleet["base_tree"]))
    for i in range(3):
        transport.publish_delta(f"hotkey_{i}", jax.tree_util.tree_map(
            lambda x, s=i + 1: 0.005 * s * jnp.ones_like(x),
            jax.tree_util.tree_map(jnp.asarray, fleet["base_tree"])))
    chain = JChain(str(fleet["tmp"].mktemp(f"jchain_{strategy}_{n}")),
                   my_hotkey="hotkey_99", epoch_length=0, clock=JClock())
    strat = {"weighted": lambda: JWA(),
             "param": lambda: JPM(jmodel, meta_epochs=2, meta_lr=0.3,
                                  per_tensor=True, meta_optimizer="sgd"),
             "genetic": lambda: JGM(population=4, generations=2,
                                    screen_batches=1)}[strategy]()
    winners = []
    inner = strat.merge

    def merge(*a, **kw):
        merged, w = inner(*a, **kw)
        winners.append(w)
        return merged, w
    strat.merge = merge
    loop = JLoop(jtrain.TrainEngine(jmodel, mesh=_jmesh(n, shape),
                                    seq_len=32),
                 transport, chain, strat,
                 val_batches=lambda: fleet["val"], clock=JClock(),
                 publish_policy="always")
    loop.bootstrap()
    assert loop.run_round()
    assert loop.report.last_accepted == 3
    return _flat(jax.device_get(loop.base_params)), winners[-1]


def _check_avg_round(ranks, case: str, want: dict) -> None:
    """Every rank merged the three deltas, the coordinator alone
    published, every rank holds the same revision and the same base,
    within rtol 1e-5, atol 1e-6 of JAX's ``want``."""
    for r, out in enumerate(ranks):
        assert bool(out[f"{case}/merged"]) and \
            int(out[f"{case}/accepted"]) == 3
        assert int(out[f"{case}/publishes"]) == (1 if r == 0 else 0)
        assert json.loads(str(out[f"{case}/revision"])) == \
            json.loads(str(ranks[0][f"{case}/revision"])) is not None
        for k, v in want.items():
            got = out[f"{case}/base/{k}"]
            np.testing.assert_array_equal(got, ranks[0][f"{case}/base/{k}"])
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["weighted", "param"])
def test_averager_round_on_mesh_matches_jax(devices, fleet, strategy, n,
                                            request):
    """JAX's averager fixture (three constant deltas, M = 3 not dividing
    the axis; ``WeightedAverage``, and ``ParameterizedMerge`` per-tensor
    with SGD, two epochs at lr 0.3) at world 2 and 4 against the JAX loop
    on a dp n mesh, both publishing (``--publish-policy always``, so the
    merged base is the new base): every rank's base within rtol 1e-5,
    atol 1e-6, the same on every rank, and one publish, the
    coordinator's."""
    ranks = request.getfixturevalue(f"world{n}")
    want, _ = _jax_avg(fleet, strategy, n)
    _check_avg_round(ranks, f"avg_{strategy}", want)


def test_weighted_round_on_fsdp_tp_mesh_matches_jax(devices, fleet,
                                                    world4_fsdp_tp):
    """``WeightedAverage`` at world 4 on fsdp 2 x tp 2 (the stack sharded
    over fsdp, the guard's evaluation on the split parameters) against
    the JAX loop on the same mesh shape (``_check_avg_round``)."""
    want, _ = _jax_avg(fleet, "weighted", 4, FSDP_TP)
    _check_avg_round(world4_fsdp_tp, "avg_weighted", want)


def test_genetic_round_on_mesh_matches_jax(devices, fleet, world2):
    """``GeneticMerge`` at world 2 (its tiers one candidate at a time:
    each a merge over the sharded stack and an evaluation on the mesh
    engine) against JAX's ``AveragerLoop`` with the same ``GeneticMerge``
    on a dp 2 mesh (sequential tiers too): the same winning weights and
    base within rtol 1e-5, atol 1e-6, on both ranks, and one publish."""
    want, winner = _jax_avg(fleet, "genetic", 2)
    _check_avg_round(world2, "avg_genetic", want)
    for out in world2:
        np.testing.assert_allclose(out["avg_genetic/winner"],
                                   np.asarray(winner), rtol=1e-5, atol=1e-6)


def test_a_failed_publish_keeps_the_world_in_step(devices, fleet, world2):
    """The coordinator's ``publish_base`` raising once, on a world of 2:
    a genesis publish raises on both ranks, and the next bootstrap
    publishes the genesis, the same revision on both; a round whose
    publish fails fails on both ranks, and ``run_periodic``'s next round
    merges and publishes on both, in step: one merged round, the same
    revision and the same base on both, JAX's weighted base within rtol
    1e-5, atol 1e-6, and two publish calls on the coordinator only (the
    failed one and the one that landed)."""
    want, _ = _jax_avg(fleet, "weighted", 2)
    case = "avg_publish_fail"
    revs = set()
    for r, out in enumerate(world2):
        assert "base publish failed" in str(out[f"{case}/genesis_raised"])
        assert "planted publish failure" in \
            str(out[f"{case}/genesis_raised"])
        revs.add(json.loads(str(out[f"{case}/genesis_revision"])))
        assert int(out[f"{case}/genesis_publishes"]) == \
            (2 if r == 0 else 0)
        assert int(out[f"{case}/merged_rounds"]) == 1
        assert int(out[f"{case}/publishes"]) == (2 if r == 0 else 0)
        assert json.loads(str(out[f"{case}/revision"])) != \
            json.loads(str(out[f"{case}/before"]))
        for k, v in want.items():
            got = out[f"{case}/base/{k}"]
            np.testing.assert_array_equal(got, world2[0][f"{case}/base/{k}"])
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert len(revs) == 1 and None not in revs
    assert json.loads(str(world2[0][f"{case}/revision"])) == \
        json.loads(str(world2[1][f"{case}/revision"]))


def test_genetic_round_on_mesh_matches_world_one(fleet, world2, tmp_path):
    """``GeneticMerge`` at world 2 (its tiers one candidate at a time:
    each a merge over the sharded stack and an evaluation on the mesh
    engine) against the port's own single-process round on the same
    fixture: the same winner, the same base within rtol 1e-5, atol 1e-6,
    one publish."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              GeneticMerge)
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    root = str(tmp_path / "artifacts")
    shutil.copytree(fleet["avg_roots"]["genetic"], root)
    model, _ = tg.make_model(dataclasses.replace(tg.PRESETS["tiny"],
                                                 dtype="float32"))
    loop = AveragerLoop(TrainEngine(model, device="cpu"),
                        LocalFSTransport(root),
                        LocalChain(str(tmp_path / "chain"),
                                   my_hotkey="hotkey_99", epoch_length=0),
                        GeneticMerge(population=4, generations=2,
                                     screen_batches=1),
                        val_batches=lambda: fleet["val"], clock=FakeClock(),
                        publish_policy="always")
    loop.bootstrap()
    assert loop.run_round()
    loop.close()
    for r, out in enumerate(world2):
        assert int(out["avg_genetic/publishes"]) == (1 if r == 0 else 0)
        assert int(out["avg_genetic/accepted"]) == 3
        for k, v in loop.base_params.items():
            np.testing.assert_allclose(out[f"avg_genetic/base/{k}"],
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The entry points, and the repaired start-up
# ---------------------------------------------------------------------------

_CLI = ["--backend", "local", "--model", "tiny", "--dataset", "synthetic",
        "--tokenizer", "word", "--no-base-wire-v2", "--no-lineage",
        "--flight-events", "0", "--rounds", "1", "--eval-batches", "2"]


def _cli_root(tmp_path):
    """A work dir with a published base and two dense deltas on it."""
    work = tmp_path / "work"
    t = LocalFSTransport(str(work / "artifacts"))
    base = tg.init_params_numpy(tg.PRESETS["tiny"], 0)
    rev = t.publish_base(base)
    rng = np.random.default_rng(1)
    for h in ("hotkey_1", "hotkey_2"):
        t.publish_delta(h, jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(np.shape(x)) * 1e-3).astype(
                np.float32), base))
        t.publish_delta_meta(h, {"base_revision": rev})
    return work


def test_validator_and_averager_clis_on_two_processes(tmp_path):
    """Both CLIs as two CPU processes joined by ``--multihost-*``: each
    rank exits 0, the validator sets weights once and the averager
    publishes once (the coordinator), and the published base moved."""
    work = _cli_root(tmp_path)
    common = _CLI + ["--work-dir", str(work)]
    rcs, outs, res = _run_cli(tmp_path / "val", "validator",
                              common + ["--hotkey", "hotkey_91"])
    assert rcs == [0, 0], "\n".join(outs)
    assert [r["rc"] for r in res] == [0, 0]
    assert [r["counts"].get("set_weights", 0) for r in res] == [1, 0]
    weights = JChain(str(work / "chain")).get_weights("hotkey_91")
    assert weights and sum(weights.values()) > 0
    before = LocalFSTransport(str(work / "artifacts")).base_revision()
    rcs, outs, res = _run_cli(tmp_path / "avg", "averager",
                              common + ["--hotkey", "hotkey_95",
                                        "--publish-policy", "always",
                                        "--strategy", "weighted"])
    assert rcs == [0, 0], "\n".join(outs)
    assert [r["counts"].get("publish_base", 0) for r in res] == [1, 0]
    assert LocalFSTransport(str(work / "artifacts")).base_revision() \
        != before


@pytest.mark.parametrize("role,argv", [
    ("server", []),
    ("server", ["--multihost-processes", "2"]),
    ("router", None),
])
def test_server_and_router_refuse_a_world(monkeypatch, role, argv):
    """A server or router started as several processes (``WORLD_SIZE``
    2, or a ``--multihost-*`` flag) raises NotImplementedError naming
    slice 7 before any process group exists."""
    import torch.distributed as dist
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    if argv is None or not argv:
        monkeypatch.setenv("WORLD_SIZE", "2")
    if role == "router":
        from distributedtraining_tpu_torch.neurons import router
        with pytest.raises(NotImplementedError, match="slice 7"):
            router.main(["--backend", "http://127.0.0.1:1"])
    else:
        from distributedtraining_tpu_torch.neurons.common import build
        with pytest.raises(NotImplementedError, match="slice 7"):
            build(RunConfig.from_args("server", [
                "--model", "tiny", "--dataset", "synthetic", "--tokenizer",
                "word"] + argv))
    assert not dist.is_initialized()


def test_config_takes_the_mesh_flags_for_the_three_roles():
    for role in ("miner", "validator", "averager"):
        for extra in (["--fsdp", "2"], ["--mesh-auto"],
                      ["--multihost-processes", "2"]):
            RunConfig.from_args(role, extra).check_ported()
    with pytest.raises(NotImplementedError, match="slice 7"):
        RunConfig.from_args("server", ["--tp", "2"]).check_ported()


def test_a_signing_world_keeps_one_wallet(tmp_path):
    """A two-rank miner with ``--sign-artifacts`` and no wallet: one
    wallet file, written by the coordinator, whose key is the hotkey's
    registered key; both ranks exit 0."""
    from distributedtraining_tpu_torch.chain import LocalAddressStore
    from distributedtraining_tpu_torch.utils.identity import Identity
    work = tmp_path / "work"
    rcs, outs, _ = _run_cli(tmp_path / "io", "miner", [
        "--backend", "local", "--work-dir", str(work), "--model", "tiny",
        "--dataset", "synthetic", "--tokenizer", "word",
        "--no-base-wire-v2", "--flight-events", "0", "--max-steps", "2",
        "--checkpoint-interval", "0", "--no-anomaly-trace", "--batch-size",
        "2", "--seq-len", "32", "--sign-artifacts", "--hotkey", "hotkey_3"])
    assert rcs == [0, 0], "\n".join(outs)
    wallets = os.listdir(work / "wallets")
    assert wallets == ["hotkey_3.json"]
    key = Identity.load(str(work / "wallets" / "hotkey_3.json")).public_bytes
    assert LocalAddressStore(str(work / "chain")).retrieve_pubkey(
        "hotkey_3") == key


def test_a_mismatched_key_ends_every_rank_promptly(tmp_path):
    """A hotkey whose registered key is not its wallet's: both ranks of a
    signing validator exit with the mismatch, in seconds, not at the
    collective timeout."""
    from distributedtraining_tpu_torch.chain import LocalAddressStore
    from distributedtraining_tpu_torch.utils.identity import Identity
    work = _cli_root(tmp_path)
    LocalAddressStore(str(work / "chain")).store_pubkey(
        "hotkey_91", Identity.generate().public_bytes)
    t0 = time.perf_counter()
    rcs, outs, res = _run_cli(tmp_path / "io", "validator", _CLI + [
        "--work-dir", str(work), "--hotkey", "hotkey_91",
        "--sign-artifacts"])
    elapsed = time.perf_counter() - t0
    assert all(rc != 0 for rc in rcs), "\n".join(outs)
    assert res == [None, None]
    for out in outs:
        assert "different registered pubkey" in out
    assert elapsed < 120


def _lease(work, role="averager"):
    from distributedtraining_tpu_torch.engine.remediate import parse_lease
    from distributedtraining_tpu_torch.transport.base import lease_id
    return parse_lease(LocalFSTransport(str(work / "artifacts"))
                       .fetch_delta_meta(lease_id(role)))


def test_remediate_averager_cli_holds_one_lease_on_two_processes(tmp_path):
    """``--remediate --heartbeat-interval`` on a world of two: the
    coordinator acquires the lease once at boot, renews and stamps it
    for its one publish, beats and writes the JSONL; rank 1 does none of
    it and follows every verdict."""
    from distributedtraining_tpu_torch.engine.health import parse_heartbeat
    from distributedtraining_tpu_torch.transport.base import heartbeat_id
    work = _cli_root(tmp_path)
    jsonl = tmp_path / "avg.jsonl"
    rcs, outs, res = _run_cli(tmp_path / "avg", "averager", _CLI + [
        "--work-dir", str(work), "--hotkey", "hotkey_95",
        "--publish-policy", "always", "--strategy", "weighted",
        "--remediate", "--heartbeat-interval", "0.2",
        "--metrics-path", str(jsonl)])
    assert rcs == [0, 0], "\n".join(outs)
    assert [r["rc"] for r in res] == [0, 0]
    assert [r["counts"].get("acquire", 0) for r in res] == [1, 0]
    assert [r["counts"].get("stamp", 0) for r in res] == [1, 0]
    assert [r["counts"].get("publish_base", 0) for r in res] == [1, 0]
    token = _lease(work)
    t = LocalFSTransport(str(work / "artifacts"))
    assert token["epoch"] == 1 and token["holder"] == "hotkey_95"
    assert token["base_revision"] == t.base_revision()
    hb = parse_heartbeat(t.fetch_delta_meta(
        heartbeat_id("averager", "hotkey_95")))
    # the first beat fires at the plane's start; the round may end
    # before the next (the JAX averager sends no last beat either)
    assert hb["role"] == "averager" and hb["seq"] >= 1
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["lease_epoch"] for r in recs if "lease_epoch" in r] == [1]
    assert any("fleet_ledger" in r for r in recs)
    assert any(r.get("span") == "avg.publish" for r in recs)


def test_standby_world_takes_over_together(tmp_path):
    """A ``--standby`` averager on a world of two behind a primary that
    went quiet at epoch 1: the coordinator's verdict reaches both ranks,
    which take over at epoch 2, bootstrap and merge together (each exits
    0); the coordinator alone acquires, stamps and publishes."""
    from distributedtraining_tpu_torch.engine.remediate import LeaseManager
    work = _cli_root(tmp_path)
    assert LeaseManager(LocalFSTransport(str(work / "artifacts")),
                        "hotkey_95").acquire()
    rcs, outs, res = _run_cli(tmp_path / "sb", "averager", _CLI + [
        "--work-dir", str(work), "--hotkey", "hotkey_96",
        "--publish-policy", "always", "--strategy", "weighted",
        "--standby", "--failover-deadline", "2",
        "--averaging-interval", "4"])
    assert rcs == [0, 0], "\n".join(outs)
    assert [r["rc"] for r in res] == [0, 0]
    assert [r["counts"].get("acquire", 0) for r in res] == [1, 0]
    assert [r["counts"].get("stamp", 0) for r in res] == [1, 0]
    assert [r["counts"].get("publish_base", 0) for r in res] == [1, 0]
    token = _lease(work)
    assert token["epoch"] == 2 and token["holder"] == "hotkey_96"


def test_hier_sub_world_publishes_world_one_bytes(tmp_path, monkeypatch):
    """``--hier sub --remediate`` on a world of two and on one process,
    each on a copy of one root (two dense deltas and a JAX miner's
    int8 wire-v2 submission, which one process folds packed, by the
    scatter): the coordinator publishes one ``__agg__.n0`` artifact
    whose bytes (and rider) are the one-process node's, and the
    per-node ``subavg.n0`` lease is acquired and stamped once, by the
    coordinator."""
    from distributedtraining_tpu_torch.neurons import averager as tcli
    work = _cli_root(tmp_path)
    jt = JFS(str(work / "artifacts"))
    rng = np.random.default_rng(2)
    packed, _ = jdl.pack_delta_v2(jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.standard_normal(np.shape(x))
                               * 1e-3).astype(np.float32)),
        tg.init_params_numpy(tg.PRESETS["tiny"], 0)),
        density=1.0 / 16.0, quant="int8")
    _jpublish_v2(jt, "hotkey_3", jax.tree_util.tree_map(np.asarray, packed),
                 jt.base_revision(), "cid-3")
    one = tmp_path / "one"
    shutil.copytree(work, one)
    sub = _CLI + ["--hotkey", "hotkey_97", "--hier", "sub", "--hier-node",
                  "n0", "--hier-nodes", "n0", "--remediate"]
    rcs, outs, res = _run_cli(tmp_path / "sub", "averager",
                              sub + ["--work-dir", str(work)])
    assert rcs == [0, 0], "\n".join(outs)
    assert [r["rc"] for r in res] == [0, 0]
    assert [r["counts"].get("acquire", 0) for r in res] == [1, 0]
    assert [r["counts"].get("stamp", 0) for r in res] == [1, 0]
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    import logging
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(sub + ["--work-dir", str(one)]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    for name in ("__agg__.n0.msgpack", "__agg__.n0.meta.json"):
        got = (work / "artifacts" / "deltas" / name).read_bytes()
        assert got == (one / "artifacts" / "deltas" / name).read_bytes()
    rider = json.loads((work / "artifacts" / "deltas" /
                        "__agg__.n0.meta.json").read_text())
    assert rider["agg"] == {"weight": 3.0, "miners": 3, "node": "n0"}
    token = _lease(work, "subavg.n0")
    assert token["epoch"] == 1 and token["holder"] == "hotkey_97"
