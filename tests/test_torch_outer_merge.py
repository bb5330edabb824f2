"""The port's outer Nesterov merge (engine/average.py OuterOptMerge, the
loop's ``commit()``, ``ParameterizedMerge(softmax_weights=False)``, the
averager's ``--outer-momentum``) against the JAX package, on the CPU.

- Two published ``AveragerLoop`` rounds with ``OuterOptMerge`` around
  ``WeightedAverage(uniform=True)`` and around ``ParameterizedMerge``, in
  both packages on copies of one LocalFS root: the published bases
  within 1e-6 of each other relative to the leaf's largest value, and
  the velocities within 1e-6 relative to the largest value of the base
  leaf they move. The inner merges already differ in the last bit (XLA
  orders and contracts the f32 sums its own way: 21,147 of 141,056
  merged values on this tiny model), and ``merged - base`` cancels, so
  the velocity's error relative to its own size (~1e-3 of the base's) is
  ~6e-6. Each package decodes the other's velocity file.
- A round the publish guard declines and a round whose lease stands
  down leave the velocity unchanged, in memory and on disk; a restarted
  strategy restores the committed velocity from its file.
- ``softmax_weights=False`` (raw weights, uniform at the start) against
  the JAX strategy, per-tensor and scalar.
- The CLI with ``--outer-momentum`` under ``DT_FORCE_PLATFORM=cpu``
  writes the velocity file after its publish.

f32 tiny GPT-2 on both sides; weights and deltas from numpy with a seed.
"""

import dataclasses
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import OuterOptMerge as JOuter
from distributedtraining_tpu.engine.average import \
    ParameterizedMerge as JPM
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.remediate import LeaseManager
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import averager as tcli
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import LocalFSTransport

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
IDS = ["hotkey_1", "hotkey_2", "hotkey_3"]


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
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    base = tg.init_params_numpy(TINY, 0)
    fast = ttrain.TrainEngine(
        model, optimizer=ttrain.default_optimizer(1e-2), device="cpu")
    deltas = []
    for i in range(3):
        state = fast.init_state(tg.params_from_numpy(base, device="cpu"))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        for b in train[2 * i:2 * i + 2]:
            state, _ = fast.train_step(state, fast.place_batch(b))
        deltas.append(tg.params_to_numpy(
            tdl.compute_delta(state.params, snap)))
    return {"base": base, "val": val, "deltas": deltas, "model": model,
            "jmodel": jmodel, "teng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _template(world):
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  world["base"])


def _flat(tree):
    return tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _assert_rel(ours: dict, theirs: dict, tol: float = 1e-6,
                scale_by: dict | None = None) -> float:
    """max over leaves of max|a - b| / max|s| (``s`` the leaf of
    ``scale_by``, else ``b``); asserted <= ``tol``."""
    assert set(ours) == set(theirs)
    worst = 0.0
    for k, b in theirs.items():
        a = np.asarray(ours[k], np.float64)
        b = np.asarray(b, np.float64)
        s = b if scale_by is None else np.asarray(scale_by[k], np.float64)
        scale = max(float(np.abs(s).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    assert worst <= tol, worst
    return worst


def _seed_root(world, root, deltas=None):
    jt = JFS(root)
    jt.publish_base(_jtree(world["base"]))
    for h, d in zip(IDS, deltas or world["deltas"]):
        jt.publish_delta(h, d)    # riderless: accepted every round


def _strategies(world, inner, state_dir):
    if inner == "weighted":
        ours_in, ref_in = tavg.WeightedAverage(uniform=True), JWA(uniform=True)
    else:
        ours_in = tavg.ParameterizedMerge(world["model"], meta_epochs=1)
        ref_in = JPM(world["jmodel"], meta_epochs=1)
    ours = tavg.OuterOptMerge(ours_in, outer_lr=0.7, momentum=0.9,
                              state_path=f"{state_dir}/port_v.msgpack")
    ref = JOuter(ref_in, outer_lr=0.7, momentum=0.9,
                 state_path=f"{state_dir}/jax_v.msgpack")
    return ours, ref


@pytest.mark.parametrize("inner", ["weighted", "parameterized"])
def test_outer_merge_two_rounds_match_jax(world, tmp_path, inner):
    root, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    _seed_root(world, root)
    shutil.copytree(root, jroot)
    chain_dir = str(tmp_path / "chain")
    ours, ref = _strategies(world, inner, str(tmp_path))
    val = world["val"]
    port = tavg.AveragerLoop(world["teng"], LocalFSTransport(root),
                             LocalChain(chain_dir, my_hotkey="hotkey_95"),
                             ours, val_batches=lambda: iter(val),
                             publish_policy="always")
    jloop = JLoop(world["jeng"], JFS(jroot),
                  JChain(chain_dir, my_hotkey="hotkey_95"), ref,
                  val_batches=lambda: iter(val), publish_policy="always")
    try:
        for loop in (port, jloop):
            loop.bootstrap()
            assert loop.run_round() and loop.run_round()
            assert loop.report.skipped_publishes == 0
    finally:
        port.close()
        jloop.close()
    template = _template(world)
    got = _flat(JFS(root).fetch_base(template)[0])
    want = _flat(JFS(jroot).fetch_base(template)[0])
    base = tdl.flatten_tree(world["base"])
    assert max(float(np.abs(got[k] - base[k]).max()) for k in base) > 1e-4
    _assert_rel(got, want)
    # the velocities, in memory and through each other's files
    v_ours = {k: v.numpy() for k, v in ours.velocity.items()}
    v_ref = _flat(ref.velocity)
    _assert_rel(v_ours, v_ref, scale_by=want)
    from_port_file = _flat(jser.load_file(ours.state_path, template))
    from_jax_file = tdl.flatten_tree(tser.load_file(ref.state_path,
                                                    template))
    for k in v_ours:
        np.testing.assert_array_equal(from_port_file[k], v_ours[k])
        np.testing.assert_array_equal(from_jax_file[k], v_ref[k])
    # the same tree gives the same bytes in both packages
    with open(ours.state_path, "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jser.to_msgpack(
        tdl.nest_tree({k: v_ours[k] for k in v_ours}))


def _velocity_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_declined_and_stood_down_rounds_keep_the_velocity(world, tmp_path):
    root = str(tmp_path / "artifacts")
    _seed_root(world, root)
    path = str(tmp_path / "state" / "velocity_hotkey_95.msgpack")
    val = world["val"]
    transport = LocalFSTransport(root)

    def loop_with(strategy, **kw):
        return tavg.AveragerLoop(
            world["teng"], transport,
            LocalChain(str(tmp_path / "chain"), my_hotkey="hotkey_95"),
            strategy, val_batches=lambda: iter(val), **kw)

    outer = tavg.OuterOptMerge(tavg.WeightedAverage(uniform=True),
                               state_path=path)
    loop = loop_with(outer, publish_policy="always")
    loop.bootstrap()
    assert loop.run_round()
    committed = {k: v.clone() for k, v in outer.velocity.items()}
    on_disk = _velocity_bytes(path)

    # a round the guard declines: a delta that wrecks the loss
    rng = np.random.default_rng(9)
    wreck = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * 5.0).astype(np.float32),
        world["base"])
    for h in IDS:
        JFS(root).publish_delta(h, wreck)
    guarded = loop_with(outer, publish_policy="improved")
    guarded.bootstrap()
    assert guarded.run_round()
    assert guarded.report.skipped_publishes == 1
    assert outer._pending_velocity is not None    # merged, not committed
    for k, v in committed.items():
        assert torch.equal(outer.velocity[k], v)
    assert _velocity_bytes(path) == on_disk

    # a round whose lease another holder took: it stands down
    _seed_root(world, root)
    rival = LeaseManager(transport, "hotkey_96")
    mine = LeaseManager(transport, "hotkey_95")
    assert mine.acquire() and rival.acquire()
    leased = loop_with(outer, publish_policy="always", lease=mine)
    leased.bootstrap()
    rev = transport.base_revision()
    assert leased.run_round()
    assert leased.report.skipped_publishes == 1
    assert transport.base_revision() == rev
    for k, v in committed.items():
        assert torch.equal(outer.velocity[k], v)
    assert _velocity_bytes(path) == on_disk

    # a restart restores the committed velocity from the file, and the
    # JAX strategy restores the same from it
    restarted = tavg.OuterOptMerge(tavg.WeightedAverage(uniform=True),
                                   state_path=path)
    base = tg.params_from_numpy(world["base"], device="cpu")
    restored = restarted._restore_velocity(base)
    jrestored = _flat(JOuter(JWA(), state_path=path)._restore_velocity(
        _jtree(world["base"])))
    for k, v in committed.items():
        assert torch.equal(restored[k], v)
        np.testing.assert_array_equal(jrestored[k], v.numpy())
    for lp in (loop, guarded, leased):
        lp.close()


@pytest.mark.parametrize("per_tensor", [True, False],
                         ids=["per_tensor", "scalar"])
def test_softmax_weights_false_matches_jax(world, per_tensor):
    val = world["val"]
    base = tg.params_from_numpy(world["base"], device="cpu")
    ours = tavg.ParameterizedMerge(world["model"], meta_epochs=2,
                                   per_tensor=per_tensor,
                                   softmax_weights=False)
    merged, w = ours.merge(world["teng"], base, world["deltas"], IDS,
                           val_batches=lambda: iter(val))
    ref = JPM(world["jmodel"], meta_epochs=2, per_tensor=per_tensor,
              softmax_weights=False)
    from distributedtraining_tpu import delta as jdl
    jmerged, jw = ref.merge(
        world["jeng"], _jtree(world["base"]),
        jdl.stack_deltas([_jtree(d) for d in world["deltas"]]), IDS,
        val_batches=lambda: iter(val))
    jw = _flat(jw) if per_tensor else {"w": np.asarray(jw)}
    ow = ({k: v.numpy() for k, v in w.items()} if per_tensor
          else {"w": w.numpy()})
    assert set(ow) == set(jw)
    for k in jw:
        np.testing.assert_allclose(ow[k], jw[k], rtol=0, atol=1e-5)
    # raw weights start at 1/M and move
    assert any(float(np.abs(v - 1.0 / 3.0).max()) > 1e-4
               for v in ow.values())
    jm = _flat(jmerged)
    for k in jm:
        np.testing.assert_allclose(merged[k].numpy(), jm[k], rtol=0,
                                   atol=1e-5)
    if per_tensor:
        assert ours.lineage_weights(w) is None
    else:
        np.testing.assert_allclose(
            ours.lineage_weights(w).numpy(),
            np.asarray(ref.lineage_weights(jnp.asarray(jw["w"]))),
            rtol=0, atol=1e-7)


def test_averager_cli_outer_momentum_writes_the_velocity(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    small = ["--batch-size", "2", "--eval-batches", "2",
             "--eval-seq-len", "32", "--work-dir", work]
    flags = ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--no-lineage", "--flight-events", "0", "--strategy",
             "weighted", "--outer-momentum", "0.9", "--hotkey", "hotkey_95"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    path = os.path.join(work, "averager_state",
                        "velocity_hotkey_95.msgpack")
    try:
        assert tcli.main(flags + small + ["--rounds", "1"]) == 1  # genesis
        assert not os.path.exists(path)
        assert tminer.main(
            ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--checkpoint-interval", "0", "--no-anomaly-trace",
             "--flight-events", "0", "--wire-v2", "--hotkey", "hotkey_3",
             "--max-steps", "3", "--seq-len", "32"] + small) == 0
        assert tcli.main(flags + small + [
            "--rounds", "1", "--publish-policy", "always"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    template = jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.float32),
        tg.init_params_numpy(TINY, 0))
    v = _flat(jser.load_file(path, template))
    assert max(float(np.abs(x).max()) for x in v.values()) > 0
