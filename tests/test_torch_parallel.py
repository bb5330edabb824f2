"""The mesh plane of the PyTorch port (distributedtraining_tpu_torch/
parallel, the sharded fused CE, TrainEngine(mesh=...)) against the JAX
package on the CPU.

JAX runs on the 8 host devices of tests/conftest.py; the port runs one
process per device over gloo (tests/torch_parallel_worker.py, which
imports no JAX), and each rank's results are held against the JAX
arrays at the same mesh coordinates. Inputs are made with numpy from a
seed. Tolerances: mesh arithmetic and shards exact; the sharded CE's
value, dh and dW shards 1e-5 (f32, summation order); three AdamW steps
of the mesh engine 1e-5 relative in loss and 1e-5 per shard element.
"""

import dataclasses
import itertools
import json
import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.ops import pallas_ce as jce
from distributedtraining_tpu.parallel import MeshConfig as JMeshConfig
from distributedtraining_tpu.parallel import make_mesh
from distributedtraining_tpu.parallel import mesh as jmesh
from distributedtraining_tpu.parallel.sharding import mesh_shardings
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.parallel import mesh as tmesh
from distributedtraining_tpu_torch.parallel import multihost as tmh
from distributedtraining_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
SPAWN_TIMEOUT = 240
# worlds' store ports: a block of PORT_BLOCK a worker from PORT_BASE, under
# the ephemeral range (32768-60999 on Linux)
PORT_BASE, PORT_BLOCK = 20000, 500


def _free_port() -> int:
    """A free port for a world's store, from a block of this xdist
    worker's own below the kernel's ephemeral range: between this check
    and the coordinator's bind, neither another worker's world nor an
    outgoing connection (which takes ephemeral ports) can take it."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    idx = int(worker[2:]) if worker[2:].isdigit() else 0
    base = PORT_BASE + PORT_BLOCK * (idx % 16)
    start = random.randrange(PORT_BLOCK)
    for off in range(PORT_BLOCK):
        port = base + (start + off) % PORT_BLOCK
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port in {base}..{base + PORT_BLOCK - 1}")


def _iter_coords(cfg):
    """``(rank, coords)`` over the whole mesh, in rank order."""
    for rank, c in enumerate(itertools.product(*(range(n)
                                                 for n in cfg.shape))):
        yield rank, dict(zip(tmesh.AXES, c))


def _run_world(tmp_path, case: str, mesh: dict, inputs: dict,
               args: dict | None = None) -> list[dict]:
    """Run ``case`` on a gloo world of the mesh's size (the CPU, as the
    port's roles run under ``DT_FORCE_PLATFORM=cpu``); each rank's
    outputs, in rank order."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "args.json").write_text(json.dumps({"mesh": mesh,
                                                    **(args or {})}))
    world = int(np.prod(list(mesh.values())))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["DT_FORCE_PLATFORM"] = "cpu"
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r),
                               str(world), port, str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# Mesh arithmetic and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 64])
def test_mesh_arithmetic_matches_jax(n):
    for params in (0, 10**6, 124 * 10**6, 7 * 10**9, 70 * 10**9):
        assert dataclasses.astuple(tmesh.best_mesh_shape(
            n, model_params=params)) == dataclasses.astuple(
            jmesh.best_mesh_shape(n, model_params=params))
    for kw in ({}, {"fsdp": 2}, {"tp": 2}, {"dp": 2, "fsdp": 2},
               {"auto": True, "model_params": 7 * 10**9},
               {"auto": True, "model_params": 124 * 10**6, "dcn_dp": 1}):
        assert dataclasses.astuple(tmesh.resolve_mesh_config(
            n_devices=n, **kw)) == dataclasses.astuple(
            jmesh.resolve_mesh_config(n_devices=n, **kw))
    assert tmesh._largest_pow2_divisor(n) == jmesh._largest_pow2_divisor(n)


@pytest.mark.parametrize("shape", [(2, 2, 1, 2), (1, 4, 1, 2), (2, 1, 1, 4),
                                   (8, 1, 1, 1)])
def test_rank_coordinates_follow_the_jax_device_layout(devices, shape):
    """Rank r sits where JAX's mesh puts device r; a group's ranks run in
    coordinate order along its axes."""
    jm = make_mesh(JMeshConfig(*shape))
    cfg = tmesh.MeshConfig(*shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, coords in _iter_coords(cfg):
        assert tmesh.rank_coords(rank, cfg) == coords
        assert ids[tuple(coords[a] for a in tmesh.AXES)] == rank
    for axes in tmesh.GROUP_AXES:
        for ranks in tmesh.group_ranks(cfg, axes):
            others = [{a: c for a, c in tmesh.rank_coords(r, cfg).items()
                       if a not in axes} for r in ranks]
            assert all(o == others[0] for o in others)
            assert len(ranks) == cfg.n_devices // len(
                tmesh.group_ranks(cfg, axes))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _tiny_tree(seed=0):
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
    return cfg, tg.init_params_numpy(cfg, seed)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_param_specs_match_the_jax_models_annotations(devices):
    jmodel, _ = jg.make_model(dataclasses.replace(jg.PRESETS["tiny"],
                                                  dtype="float32"))
    mesh = make_mesh(JMeshConfig(2, 2, 1, 2))
    shardings = _flat(mesh_shardings(jmodel, mesh, seq_len=16))
    ours = tsh.param_specs(shardings)
    for k, s in shardings.items():
        spec = tuple(s.spec) + (None,) * (len(ours[k]) - len(s.spec))
        assert ours[k] == spec, k


@pytest.mark.parametrize("shape", [(2, 2, 1, 2), (1, 4, 1, 2), (1, 2, 1, 4),
                                   (8, 1, 1, 1)])
def test_shard_params_equals_jax_addressable_shards(devices, shape):
    jmodel, _ = jg.make_model(dataclasses.replace(jg.PRESETS["tiny"],
                                                  dtype="float32"))
    _, tree = _tiny_tree()
    mesh = make_mesh(JMeshConfig(*shape))
    placed = _flat(jax.tree_util.tree_map(
        jax.device_put, tree, mesh_shardings(jmodel, mesh, seq_len=16)))
    flat = _flat(tree)
    cfg = tmesh.MeshConfig(*shape)
    shape_of_mesh = dict(zip(tmesh.AXES, shape))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank, coords in _iter_coords(cfg):
        ours = tsh.shard_params(flat, shape_of_mesh=shape_of_mesh,
                                coords=coords)
        dev = ids[tuple(coords[a] for a in tmesh.AXES)]
        for k, arr in placed.items():
            piece = next(s.data for s in arr.addressable_shards
                         if s.device.id == dev)
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(piece), err_msg=k)


def test_shard_params_refuses_a_dim_its_axis_does_not_divide():
    _, tree = _tiny_tree()
    with pytest.raises(ValueError, match="not divisible"):
        tsh.shard_params({"wpe": _flat(tree)["wpe"]},
                         shape_of_mesh={"dp": 1, "fsdp": 3, "sp": 1,
                                        "tp": 1},
                         coords=dict.fromkeys(tmesh.AXES, 0))


def test_batch_rows_and_document_shards_follow_the_coordinates():
    class _M:     # the two methods batch_rows reads
        def __init__(self, coords):
            self.coords = coords
            self.shape = {"dp": 2, "fsdp": 2, "sp": 1, "tp": 2}

        size = tmesh.Mesh.size
        index = tmesh.Mesh.index

    ids = np.arange(8 * 3).reshape(8, 3)
    seen = {}
    for rank, coords in _iter_coords(tmesh.MeshConfig(2, 2, 1, 2)):
        rows = tsh.batch_rows({"input_ids": ids}, _M(coords))["input_ids"]
        g = coords["dp"] * 2 + coords["fsdp"]
        np.testing.assert_array_equal(rows, ids[2 * g:2 * g + 2])
        seen.setdefault(g, []).append(rows)
    assert all(np.array_equal(a, b) for a, b in seen.values())  # tp peers
    docs = [f"d{i}" for i in range(10)]
    parts = [list(tmh.shard_documents(docs, process_index=i,
                                      process_count=4)) for i in range(4)]
    assert sorted(sum(parts, [])) == sorted(docs)
    assert parts[1] == ["d1", "d5", "d9"]


def test_a_miner_mesh_needs_its_processes():
    """One process: no mesh by default; a mesh of several devices asks
    for the launch that gives it its processes."""
    from distributedtraining_tpu_torch.config import RunConfig
    from distributedtraining_tpu_torch.neurons.common import role_mesh
    model, _ = tg.make_model("tiny")
    assert role_mesh(RunConfig.from_args("miner", []), model) is None
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        role_mesh(RunConfig.from_args("miner", ["--fsdp", "2", "--tp",
                                                "2"]), model)


# ---------------------------------------------------------------------------
# Collectives and pod helpers on gloo worlds
# ---------------------------------------------------------------------------

def test_collectives_and_their_transposes(tmp_path):
    """dp2 x fsdp2: all_gather along dim 1 (backward: reduce-scatter),
    reduce_scatter (backward: all-gather), all_reduce (backward: the
    identity) and copy_to (backward: the sum over the axis)."""
    outs = _run_world(tmp_path, "collectives", {"dp": 2, "fsdp": 2}, {})
    base = np.arange(12.0).reshape(3, 4)
    for rank, coords in _iter_coords(tmesh.MeshConfig(2, 2, 1, 1)):
        o, r = outs[rank], rank + 1
        peers = [2 * coords["dp"] + f + 1 for f in range(2)]  # fsdp group
        np.testing.assert_array_equal(
            o["all_gather/y"], np.concatenate([p * base for p in peers], 1))
        # the cotangent r * ones is [3, 8]: each peer's chunk summed
        np.testing.assert_array_equal(o["all_gather/dx"],
                                      sum(peers) * np.ones((3, 4)))
        half = slice(2 * coords["fsdp"], 2 * coords["fsdp"] + 2)
        np.testing.assert_array_equal(o["reduce_scatter/y"],
                                      sum(peers) * base[:, half])
        dx = np.concatenate([p * np.ones((3, 2)) for p in peers], 1)
        np.testing.assert_array_equal(o["reduce_scatter/dx"], dx)
        np.testing.assert_array_equal(o["all_reduce/y"], 10 * base)
        np.testing.assert_array_equal(o["all_reduce/dx"], r * np.ones((3, 4)))
        np.testing.assert_array_equal(o["copy_to/y"], r * base)
        np.testing.assert_array_equal(o["copy_to/dx"],
                                      sum(peers) * np.ones((3, 4)))


def test_pod_helpers_give_every_rank_the_coordinators_value(tmp_path):
    outs = _run_world(tmp_path, "pod", {"dp": 2}, {})
    for rank, o in enumerate(outs):
        assert json.loads(str(o["json"])) == {"rank": 0, "x": [1.5, None]}
        assert bytes(o["bytes"]) == b"\x00payload"
        assert bool(o["none_bytes"]) and bool(o["empty_bytes"])
        assert bool(o["flag"]) and not bool(o["agree"])
        np.testing.assert_array_equal(o["tree_a"], np.full((2, 3), 7.0))
        assert o["tree_a"].dtype == np.float32
        np.testing.assert_array_equal(o["tree_b"], np.arange(4))
        assert bool(o["tree_none"])
        assert json.loads(str(o["metagraph"])) == {
            "hotkeys": ["h0"], "uids": [0], "stakes": [1.0], "block": 10}
        assert str(o["fetch_rev"]) == "r0"
        np.testing.assert_array_equal(o["fetch_a"], np.ones((2, 3)))
        assert bool(o["fetch_current"]) and bool(o["fetch_raised"])
        assert bool(o["stale"]) and not bool(o["not_stale"])
        assert bytes(o["read"]) == b"read"
        # the gate: the coordinator publishes, the other rank does not
        assert int(o["published"]) == (1 if rank == 0 else 0)
        assert str(o["publish_ret"]) == ("rev" if rank == 0 else "None")


# ---------------------------------------------------------------------------
# The sharded fused CE on 4 gloo ranks against JAX's on 4 devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 1, 2), (2, 1, 1, 2)],
                         ids=["fsdp2xtp2", "dp2xtp2"])
def test_sharded_fused_ce_matches_jax(devices, tmp_path, shape):
    """B 2, T 7: each dp x fsdp group holds 7 rows, which tp 2 does not
    divide (one padding row at mask 0)."""
    rng = np.random.default_rng(1)
    B, T, E, V = 2, 7, 64, 256
    inp = {"hidden": rng.standard_normal((B, T, E), dtype=np.float32),
           "head": rng.standard_normal((V, E), dtype=np.float32) * 0.1,
           "labels": rng.integers(0, V, (B, T)).astype(np.int32),
           "mask": (rng.random((B, T)) > 0.2).astype(np.float32)}
    mesh = make_mesh(JMeshConfig(*shape))
    rows = NamedSharding(mesh, P(("dp", "fsdp")))
    h = jax.device_put(inp["hidden"], rows)
    w = jax.device_put(inp["head"], NamedSharding(mesh, P("tp", "fsdp")))
    y = jax.device_put(inp["labels"], rows)
    m = jax.device_put(inp["mask"], rows)

    def loss_fn(h, w):
        return jce.fused_ce_loss_sharded(h, w, y, m, mesh=mesh,
                                         inner="scan")[0]

    loss, (dh, dw) = jax.value_and_grad(loss_fn, argnums=(0, 1))(h, w)
    dh, dw = np.asarray(dh), np.asarray(dw)
    outs = _run_world(tmp_path, "ce", dict(zip(tmesh.AXES, shape)), inp)
    cfg = tmesh.MeshConfig(*shape)
    shape_of_mesh = dict(zip(tmesh.AXES, shape))
    # dW leaves the CE reduce-scattered over tp and fsdp; the engine sums
    # every gradient over dp once, so the dp replicas' shards add up here
    dw_sum: dict = {}
    for rank, coords in _iter_coords(cfg):
        key = (coords["fsdp"], coords["tp"])
        dw_sum[key] = dw_sum.get(key, 0) + outs[rank]["dw"]
    for rank, coords in _iter_coords(cfg):
        o = outs[rank]
        np.testing.assert_allclose(o["loss"], float(loss), rtol=1e-5)
        assert float(o["count"]) == float(inp["mask"].sum())
        g = coords["dp"] * shape[1] + coords["fsdp"]
        per = B // (shape[0] * shape[1])
        np.testing.assert_allclose(o["dh"], dh[g * per:(g + 1) * per],
                                   atol=1e-5, rtol=1e-5)
        sl = tsh.shard_slices("wte", dw.shape, ("tp", "fsdp"),
                              shape_of_mesh, coords)
        np.testing.assert_allclose(dw_sum[coords["fsdp"], coords["tp"]],
                                   dw[sl], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# TrainEngine(mesh=...) on 8 gloo ranks against JAX's on dp2 x fsdp2 x tp2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,fused,accum", [
    ((2, 2, 1, 2), True, 1),
    ((1, 2, 1, 2), False, 2),
], ids=["dp2xfsdp2xtp2-fused", "fsdp2xtp2-unfused-accum2"])
def test_mesh_engine_matches_jax_engine(devices, tmp_path, shape, fused,
                                        accum):
    """Three AdamW steps with a binding --grad-clip (the setup of
    tests/test_fused_loss.py:290-327): with --fused-loss on dp2 x fsdp2 x
    tp2, and with the materialised head and two microbatches on fsdp2 x
    tp2. Losses within 1e-5 relative and Adam's first moments (linear in
    the gradients) within 1e-5 a shard element. Parameters within 1e-5,
    and 1e-4 with microbatches: the two packages cut the microbatches
    from other rows (JAX row-major over the global batch, the port over
    each rank's rows), so the gradients agree only to summation order,
    and Adam's ``m / sqrt(v)`` turns that order into up to ~lr a step
    on an element whose gradient is near zero (why tests/
    test_fused_loss.py steps with SGD)."""
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32",
                              n_embd=128, n_head=4)
    jcfg = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32",
                               n_embd=128, n_head=4)
    tree = tg.init_params_numpy(cfg, 0)
    rng = np.random.default_rng(2)
    steps, B, T = 3, 4, 16
    ids = rng.integers(0, cfg.vocab_size, (steps, B, T)).astype(np.int32)
    lr, clip = 1e-3, 0.05
    jmodel, _ = jg.make_model(jcfg)
    jmesh_ = make_mesh(JMeshConfig(*shape))
    jeng = jtrain.TrainEngine(jmodel, mesh=jmesh_, seq_len=T,
                              fused_loss="scan" if fused else False,
                              accum_steps=accum,
                              optimizer=jtrain.default_optimizer(
                                  lr, grad_clip=clip))
    state = jeng.init_state(params=jax.tree_util.tree_map(jnp.asarray,
                                                          tree))
    jlosses, jtokens = [], []
    for i in range(steps):
        state, m = jeng.train_step(state, jeng.place_batch(
            {"input_ids": jnp.asarray(ids[i])}))
        jlosses.append(float(m["loss"]))
        jtokens.append(float(m["tokens"]))
    jparams = {k: np.asarray(v) for k, v in _flat(state.params).items()}
    adam = state.opt_state[1][0]
    jmu = {k: np.asarray(v) for k, v in _flat(adam.mu).items()}
    # the clip binds: the first step's global norm is above it
    g0 = jax.grad(lambda p: jtrain._fused_lm_loss(
        jmodel, p, {"input_ids": jnp.asarray(ids[0])}, impl="scan")[0])(
        jax.tree_util.tree_map(jnp.asarray, tree))
    assert float(jnp.sqrt(sum(jnp.sum(x * x) for x in
                              jax.tree_util.tree_leaves(g0)))) > clip

    inputs = {"input_ids": ids, **{f"p/{k}": v
                                   for k, v in _flat(tree).items()}}
    outs = _run_world(tmp_path, "engine", dict(zip(tmesh.AXES, shape)),
                      inputs, {"preset": "tiny", "fused": fused, "lr": lr,
                               "accum": accum,
                               "grad_clip": clip,
                               "overrides": {"dtype": "float32",
                                             "n_embd": 128, "n_head": 4}})
    shape_of_mesh = dict(zip(tmesh.AXES, shape))
    specs = tsh.param_specs(jparams)
    p_atol = 1e-5 if accum == 1 else 1e-4
    for rank, coords in _iter_coords(tmesh.MeshConfig(*shape)):
        o = outs[rank]
        np.testing.assert_allclose(o["losses"], jlosses, rtol=1e-5)
        assert list(o["tokens"]) == jtokens == [float(B * (T - 1))] * steps
        for k, ref in jparams.items():
            sl = tsh.shard_slices(k, ref.shape, specs[k], shape_of_mesh,
                                  coords)
            np.testing.assert_allclose(o[f"p/{k}"], ref[sl], atol=p_atol,
                                       err_msg=f"rank {rank} {k}")
            np.testing.assert_allclose(o[f"mu/{k}"], jmu[k][sl], atol=1e-5,
                                       err_msg=f"rank {rank} mu {k}")
            np.testing.assert_allclose(o[f"full/{k}"], ref, atol=p_atol,
                                       err_msg=f"rank {rank} gathered {k}")


@pytest.mark.parametrize("mesh,dtype", [
    ({"fsdp": 2}, "float32"), ({"fsdp": 2}, "bfloat16"),
    ({"tp": 2}, "float32")], ids=["fsdp2-f32", "fsdp2-bf16", "tp2-f32"])
def test_mesh_engine_frees_each_blocks_gathered_parameters(tmp_path, mesh,
                                                           dtype):
    """ZeRO-3 on the tensors autograd keeps: after the forward no
    gathered parameter is alive (without the hooks some are, so the
    check sees them); every one the backward kept as a shard is gathered
    again exactly once, and loss and gradients are bit-equal to the run
    that kept the gathered tensors."""
    overrides = {"dtype": dtype, "n_embd": 128, "n_head": 4}
    cfg = dataclasses.replace(tg.PRESETS["tiny"], **overrides)
    ids = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    inputs = {"input_ids": ids,
              **{f"p/{k}": v
                 for k, v in _flat(tg.init_params_numpy(cfg, 0)).items()}}
    outs = _run_world(tmp_path, "regather", mesh, inputs,
                      {"preset": "tiny", "overrides": overrides})
    for rank, o in enumerate(outs):
        assert o["on/alive"] == 0, rank
        assert o["off/alive"] > 0, rank
        assert o["on/count/saved_as_shard"] > 0, rank
        assert o["on/count/regathered"] == o["on/count/saved_as_shard"]
        assert o["off/count/saved_as_shard"] == 0
        np.testing.assert_array_equal(o["on/loss"], o["off/loss"])
        for k in (k for k in o if k.startswith("on/grad/")):
            np.testing.assert_array_equal(o[k], o["off" + k[2:]],
                                          err_msg=f"rank {rank} {k}")


# ---------------------------------------------------------------------------
# The miner CLI on two gloo ranks (twin of test_multihost_spmd.py's)
# ---------------------------------------------------------------------------

def _miner_argv(work, extra):
    return ["--work-dir", str(work), "--backend", "local", "--model", "tiny",
            "--dataset", "synthetic", "--hotkey", "hotkey_0",
            "--batch-size", "4", "--seq-len", "32", "--fused-loss",
            "--send-interval", "0", "--check-update-interval", "0",
            "--dp", "0", "--fsdp", "2", *extra]


def _publish_tiny_base(work, seed=5):
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg = tg.PRESETS["tiny"]
    tree = tg.init_params_numpy(cfg, seed)
    LocalFSTransport(str(work / "artifacts")).publish_base(tree)
    return _flat(tree)


def _delta_on_the_wire(work):
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.engine.train import _wire_template
    model, _ = tg.make_model("tiny")
    data = (work / "artifacts" / "deltas" / "hotkey_0.msgpack").read_bytes()
    return _flat(ser.from_msgpack(data, _wire_template(model)))


def test_two_process_miner_cli(tmp_path):
    """Two ranks of the port's miner CLI on fsdp2: each rank's shards
    after the pull are the base's slices, bit for bit; the coordinator
    alone publishes; both ranks end on the same parameters; the delta on
    the wire is finite and equals the gathered trained - base."""
    work = tmp_path / "work"
    base = _publish_tiny_base(work)
    io = tmp_path / "io"
    io.mkdir()
    outs = _run_world(io, "miner", {"dp": 2}, {}, {
        "argv": _miner_argv(work, ["--max-steps", "4",
                                   "--checkpoint-interval", "0"])})
    assert sorted(os.listdir(work / "artifacts" / "deltas")) == [
        "hotkey_0.meta.json", "hotkey_0.msgpack"]
    assert [int(o["rc"]) for o in outs] == [0, 0]
    assert int(outs[0]["pushes"]) >= 5 and int(outs[1]["pushes"]) == 0
    assert [int(o["superseded"]) for o in outs] == [0, 0]
    assert [int(o["steps"]) for o in outs] == [4, 4]
    specs = tsh.param_specs(base)
    mesh_shape = {"dp": 1, "fsdp": 2, "sp": 1, "tp": 1}
    for o in outs:
        coords = json.loads(str(o["coords"]))
        for k, v in base.items():
            sl = tsh.shard_slices(k, v.shape, specs[k], mesh_shape, coords)
            np.testing.assert_array_equal(o[f"boot/{k}"], v[sl], err_msg=k)
            np.testing.assert_array_equal(o[f"base/{k}"], v, err_msg=k)
            np.testing.assert_array_equal(o[f"full/{k}"],
                                          outs[0][f"full/{k}"], err_msg=k)
    delta = _delta_on_the_wire(work)
    for k, v in base.items():
        d = np.asarray(delta[k])
        assert np.isfinite(d).all()
        np.testing.assert_array_equal(d, outs[0][f"full/{k}"] - v,
                                      err_msg=k)
    assert any(np.abs(np.asarray(d)).max() > 0 for d in delta.values())


def test_two_process_miner_resumes_from_its_checkpoint(tmp_path):
    """The coordinator writes the gathered state at exit; a second world
    reads it on the coordinator, broadcasts and re-shards: it resumes at
    the saved step and moments with the saved shards, bit for bit."""
    work = tmp_path / "work"
    _publish_tiny_base(work)
    runs = []
    for i, steps in enumerate(("3", "2")):
        io = tmp_path / f"io{i}"
        io.mkdir()
        runs.append(_run_world(io, "miner", {"dp": 2}, {}, {
            "argv": _miner_argv(work, ["--max-steps", steps,
                                       "--checkpoint-interval", "3600"])}))
    first, second = runs
    assert sorted(os.listdir(work / "checkpoints" / "hotkey_0"))
    specs = tsh.param_specs({k[len("full/"):]: v for k, v in first[0].items()
                             if k.startswith("full/")})
    mesh_shape = {"dp": 1, "fsdp": 2, "sp": 1, "tp": 1}
    for a, b in zip(first, second):
        assert int(b["boot_step"]) == int(a["step"]) == 3
        assert int(b["boot_count"]) == int(a["count"]) == 3
        assert int(b["step"]) == 5 and int(b["steps"]) == 5
        coords = json.loads(str(b["coords"]))
        for k, spec in specs.items():
            ref = a[f"full/{k}"]
            sl = tsh.shard_slices(k, ref.shape, spec, mesh_shape, coords)
            np.testing.assert_array_equal(b[f"boot/{k}"], ref[sl],
                                          err_msg=k)
