"""The port's local checkpoints (checkpoint.py, MinerLoop's save, restore
and resume) against the JAX package's, on the CPU.

- The store: numbered steps from ``next_step``, GC down to
  ``max_to_keep``, a save that crashes midway leaves no step a restore
  would read (and the next save clears the debris), a template whose
  shapes or dtypes differ gives None, as does an unreadable file;
  ``save_async`` supersedes a pending save and runs its precondition on
  the worker; a save taken while training goes on holds the state of its
  own step.
- A JAX miner and a port miner on one FakeClock schedule, each stopped
  (no flush) after a periodic checkpoint and started again on the same
  directory: both resume from their checkpoint and go on with equal
  losses (1e-5 relative) and equal push counts.
- A corrupt latest checkpoint falls back to the base pull in both.

f32 tiny GPT-2 on both sides, weights from numpy with a seed.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.checkpoint import CheckpointStore as JStore
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu_torch import serialization as ser
from distributedtraining_tpu_torch.checkpoint import CheckpointStore, Snapshot
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import InMemoryTransport

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32


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
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    return {"base": tg.init_params_numpy(TINY, 0),
            "train": [next(it) for _ in range(12)],
            "eng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _trained_state(world, steps=2):
    eng = world["eng"]
    state = eng.init_state(tg.params_from_numpy(world["base"], device="cpu"))
    for b in world["train"][:steps]:
        state, _ = eng.train_step(state, eng.place_batch(b))
    return state


def _copy(state):
    return ttrain._snapshot(state)


def _equal(a, b) -> bool:
    """Params, both moments, step and count equal to the bit."""
    trees = lambda s: (s.params, s.opt_state.mu, s.opt_state.nu)  # noqa
    return (int(a.step) == int(b.step)
            and a.opt_state.count == b.opt_state.count
            and all(torch.equal(x[k].detach().cpu(), y[k].detach().cpu())
                    for x, y in zip(trees(a), trees(b)) for k in x))


def _template(world, base=False):
    st = ttrain._abstract_state(world["eng"].model)
    return Snapshot(state=st, base_params=st.params if base else None,
                    base_revision=None)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def test_numbering_gc_meta_and_round_trip(world, tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"), max_to_keep=2)
    assert store.latest_step() is None and store.next_step() == 0
    assert store.restore(_template(world)) is None
    state = _trained_state(world)
    base = tg.params_from_numpy(world["base"], device="cpu")
    for i in range(4):
        store.save(store.next_step(), Snapshot(state, base, None, 10 + i))
    assert store.all_steps() == [2, 3] and store.next_step() == 4
    assert store.read_meta() == {"base_revision": None, "lifetime_steps": 13,
                                 "has_base": True}
    snap = store.restore(_template(world, base=True))
    assert _equal(snap.state, state) and snap.lifetime_steps == 13
    assert all(torch.equal(snap.base_params[k], base[k]) for k in base)
    # without a base: has_base False, and a template asking for one fails
    store.save(store.next_step(), Snapshot(state, None, "rev-7", 20))
    assert store.read_meta()["has_base"] is False
    assert store.restore(_template(world)).base_revision == "rev-7"
    assert store.restore(_template(world, base=True)) is None
    store.close()


def test_template_mismatch_and_corrupt_file_give_none(world, tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(0, Snapshot(_trained_state(world), None, "r", 1))
    other = dataclasses.replace(TINY, n_embd=TINY.n_embd * 2)
    wide = ttrain._abstract_state(tg.make_model(other)[0])
    assert store.restore(Snapshot(wide, None, None)) is None      # shapes
    half = ttrain._abstract_state(tg.make_model(TINY)[0])
    half.params["wte"] = half.params["wte"].to(torch.float64)
    assert store.restore(Snapshot(half, None, None)) is None      # a dtype
    assert store.restore(_template(world)) is not None
    path = os.path.join(store.directory, "0", "state.msgpack")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert store.restore(_template(world)) is None                # torn


def test_a_crash_mid_save_leaves_no_step(world, tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path / "ck"))
    state = _trained_state(world)
    store.save(0, Snapshot(state, None, "r", 1))

    def crash(tree, path):
        with open(path, "wb") as f:
            f.write(b"\x85partial")
        raise OSError("power lost")

    monkeypatch.setattr(ser, "save_file", crash)
    with pytest.raises(OSError):
        store.save(1, Snapshot(state, None, "r", 2))
    monkeypatch.undo()
    debris = [n for n in os.listdir(store.directory) if n.startswith(".")]
    assert debris and store.all_steps() == [0]
    assert store.read_meta()["lifetime_steps"] == 1
    assert store.restore(_template(world)) is not None
    store.save(store.next_step(), Snapshot(state, None, "r", 3))
    assert store.all_steps() == [0, 1]
    assert not [n for n in os.listdir(store.directory) if n.startswith(".")]


def test_save_async_supersedes_and_screens_on_the_worker(world, tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"), max_to_keep=10)
    state = _trained_state(world)
    gate, started = threading.Event(), threading.Event()
    seen = []

    def blocking():
        started.set()
        gate.wait(10)
        seen.append(threading.current_thread().name)
        return True

    store.save_async(Snapshot(state, None, "r", 1), precondition=blocking)
    assert started.wait(10)
    # the worker is busy: of the next two, the first is superseded
    store.save_async(Snapshot(state, None, "r", 2))
    store.save_async(Snapshot(state, None, "r", 3))
    gate.set()
    assert store.flush(10)
    assert store.all_steps() == [0, 1]
    assert store.read_meta()["lifetime_steps"] == 3
    assert seen and seen[0] != threading.current_thread().name
    store.save_async(Snapshot(state, None, "r", 4), precondition=lambda: False)
    assert store.flush(10) and store.all_steps() == [0, 1]
    store.close()


def test_async_save_holds_the_state_of_its_own_step(world, tmp_path):
    """MinerLoop hands the worker device copies: the save taken at step 2
    holds step 2's params and moments though training went on."""
    t = InMemoryTransport()
    t.publish_base(world["base"])
    store = CheckpointStore(str(tmp_path / "ck"))
    gate = threading.Event()
    loop = ttrain.MinerLoop(world["eng"], t, "m0", clock=FakeClock(),
                            send_interval=1e9, check_update_interval=1e9,
                            push_async=True, checkpoint_store=store,
                            checkpoint_interval=1e9)
    loop.bootstrap()
    loop.run(iter(world["train"][:2]))
    at_save = _copy(loop.state)
    real_save = store.save
    store.save = lambda *a: (gate.wait(10), real_save(*a))
    loop._save_checkpoint()
    loop.run(iter(world["train"][2:4]))     # trains while the save waits
    assert not _equal(loop.state, at_save)
    gate.set()
    assert store.flush(10)
    snap = store.restore(_template(world))
    assert _equal(snap.state, at_save) and snap.base_revision == \
        t.base_revision()
    loop.close()
    store.close()


# ---------------------------------------------------------------------------
# Resume, against the JAX miner
# ---------------------------------------------------------------------------

class _Losses:
    def __init__(self):
        self.losses = []

    def log(self, record, step=None):
        if "train_loss" in record:
            self.losses.append(record["train_loss"])


def _batches(loop, batches):
    for b in batches:
        loop.clock.sleep(1.0)
        yield b


def _miner(side, world, t, store, sink):
    kw = dict(send_interval=4.0, check_update_interval=1e9, metrics=sink,
              log_every=1, checkpoint_store=store, checkpoint_interval=3.0)
    if side == "port":
        return ttrain.MinerLoop(world["eng"], t, "m0", clock=FakeClock(),
                                **kw)
    return jtrain.MinerLoop(world["jeng"], t, "m0", clock=JFakeClock(), **kw)


def _stop_and_resume(side, world, tmp_path):
    """5 steps (a checkpoint at step 3, a push at step 4), stopped without
    a flush; a new process's loop on the same directory resumes and runs
    5 more, then flushes."""
    ck = str(tmp_path / f"ck-{side}")
    t = InMemoryTransport() if side == "port" else JMem()
    t.publish_base(world["base"] if side == "port" else
                   jax.tree_util.tree_map(jnp.asarray, world["base"]))
    mk_store = CheckpointStore if side == "port" else JStore
    first = _Losses()
    store = mk_store(ck)
    loop = _miner(side, world, t, store, first)
    loop.bootstrap()
    loop.run(_batches(loop, world["train"][:5]))
    pushes_first = loop.report.pushes
    loop._publisher.flush()
    if side == "port":
        loop.close()
    store.close()
    second = _Losses()
    store = mk_store(ck)
    loop = _miner(side, world, t, store, second)
    loop.bootstrap()
    resumed_at = (int(loop.state.step), loop.report.steps)
    loop.run(_batches(loop, world["train"][5:10]))
    loop.flush()
    if side == "port":
        loop.close()
    store.close()
    return {"first": first.losses, "second": second.losses,
            "resumed_at": resumed_at, "pushes": (pushes_first,
                                                 loop.report.pushes),
            "steps": loop.report.steps}


def test_stopped_miners_resume_like_jax(world, tmp_path):
    port = _stop_and_resume("port", world, tmp_path)
    ref = _stop_and_resume("jax", world, tmp_path)
    # the checkpoint at step 3: both resume there, 2 steps of work lost
    assert port["resumed_at"] == ref["resumed_at"] == (3, 3)
    assert port["pushes"] == ref["pushes"]
    assert port["pushes"][0] >= 1 and port["pushes"][1] >= 1
    assert port["steps"] == ref["steps"] == 8
    for a, b in ((port["first"], ref["first"]),
                 (port["second"], ref["second"])):
        assert len(a) == len(b) == 5
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_corrupt_checkpoint_falls_back_to_a_pull(world, tmp_path):
    for side in ("port", "jax"):
        ck = str(tmp_path / f"ck-{side}")
        t = InMemoryTransport() if side == "port" else JMem()
        t.publish_base(world["base"] if side == "port" else
                       jax.tree_util.tree_map(jnp.asarray, world["base"]))
        store = (CheckpointStore if side == "port" else JStore)(ck)
        loop = _miner(side, world, t, store, None)
        loop.bootstrap()
        loop.run(_batches(loop, world["train"][:4]))
        loop._save_checkpoint()
        if side == "port":
            loop.close()
        store.close()
        latest = max(int(n) for n in os.listdir(ck) if n.isdigit())
        for dirpath, _, files in os.walk(os.path.join(ck, str(latest))):
            for name in files:
                if not name.endswith(".json"):
                    with open(os.path.join(dirpath, name), "r+b") as f:
                        f.truncate(max(1, os.path.getsize(f.name) // 3))
        store = (CheckpointStore if side == "port" else JStore)(ck)
        loop = _miner(side, world, t, store, None)
        loop.bootstrap()
        assert loop._base_revision == t.base_revision()
        assert loop.report.steps == 0 and int(loop.state.step) == 0
        if side == "port":
            assert int(loop.state.opt_state.count) == 0
            loop.close()
        store.close()
