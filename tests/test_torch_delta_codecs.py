"""The miner's v1 compressed wire forms in the port (delta.py
quantize_delta and sparsify_delta, MinerLoop(delta_dtype="int8" |
"sparse8", delta_density=...), the miner's ``--delta-dtype``) against the
JAX package, on the CPU.

- The artifact bytes equal the JAX encoders' (jitted, as the JAX miner's
  push snapshot runs them) followed by the JAX msgpack codec, leaf cases
  included: random values, exact ties (``lax.top_k`` keeps the lower
  index first), a leaf of exactly ``SPARSE_DENSE_CUTOFF`` elements and
  one past it, k >= n (density 1) and an empty leaf (sparse8 only: the
  JAX int8 encoder takes no empty leaf).
- A port int8 and sparse8 miner's artifact: its bytes equal the JAX
  encoders' on the same delta, and JAX's ingest decodes it; a JAX int8
  and sparse8 miner's artifact decodes in the port's ingest to the JAX
  ingest's values, bit for bit.
- The CLI with ``--delta-dtype int8|sparse8`` under
  ``DT_FORCE_PLATFORM=cpu``.

f32 tiny GPT-2; weights and deltas from numpy with a seed.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.ingest import DeltaIngestor as JIngest
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
from distributedtraining_tpu_torch.engine.publish import host_materialize
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import LocalFSTransport

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
CUT = tdl.SPARSE_DENSE_CUTOFF


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
    jmodel, _ = jg.make_model(JTINY)
    return {"base": tg.init_params_numpy(TINY, 0),
            "train": [next(it) for _ in range(4)],
            "jeng": jtrain.TrainEngine(jmodel)}


def _case(name: str) -> dict:
    rng = np.random.default_rng(7)
    f = np.float32
    if name == "random":
        return {"a": {"kernel": rng.standard_normal((96, 80)).astype(f)},
                "b": {"bias": rng.standard_normal(80).astype(f)}}
    if name == "ties":
        # 50 distinct values, each 200 times: top-k must cut through ties
        vals = rng.standard_normal(50).astype(f)
        return {"t": {"kernel": np.tile(vals, 200).reshape(100, 100)},
                "z": {"kernel": np.zeros((80, 80), f)}}
    if name == "cutoff":
        return {"at": {"scale": rng.standard_normal(CUT).astype(f)},
                "past": {"scale": rng.standard_normal(CUT + 1).astype(f)}}
    if name == "empty":
        return {"e": {"bias": np.zeros((0,), f)},
                "x": {"kernel": rng.standard_normal((70, 70)).astype(f)}}
    raise KeyError(name)


def _jax_bytes(codec, tree, density):
    fn = (jdl.quantize_delta if codec == "int8" else
          (lambda t: jdl.sparsify_delta(t, density=density)))
    return jser.to_msgpack(jax.device_get(jax.jit(fn)(
        jax.tree_util.tree_map(jnp.asarray, tree))))


def _port_bytes(codec, tree, density):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in tdl.flatten_tree(tree).items()}
    enc = (tdl.quantize_delta(sd) if codec == "int8"
           else tdl.sparsify_delta(sd, density=density))
    return tser.to_msgpack(host_materialize(enc))


@pytest.mark.parametrize("codec,case,density", [
    ("int8", "random", None), ("int8", "ties", None),
    ("int8", "cutoff", None),
    ("sparse8", "random", 1 / 64), ("sparse8", "ties", 1 / 64),
    ("sparse8", "cutoff", 1 / 16), ("sparse8", "random", 1.0),
    ("sparse8", "empty", 1 / 64)])
def test_codec_bytes_equal_jax(codec, case, density):
    tree = _case(case)
    ours = _port_bytes(codec, tree, density)
    assert ours == _jax_bytes(codec, tree, density)
    if codec == "sparse8" and case == "ties":
        # the kept set cuts through a run of equal magnitudes
        leaves = jser.from_msgpack(ours)["leaves"]
        idx = np.asarray(leaves["t"]["kernel"]["idx"])
        assert len(idx) == tdl.sparse_k(10000, density) < 10000
    with pytest.raises(ValueError, match="non-float"):
        (tdl.quantize_delta if codec == "int8" else tdl.sparsify_delta)(
            {"i": torch.zeros(3, dtype=torch.int32)})


def _template(world):
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  world["base"])


def _batches(loop, batches):
    for b in batches:
        loop.clock.sleep(1.0)
        yield b


@pytest.mark.parametrize("codec", ["int8", "sparse8"])
def test_port_miner_artifact_is_the_jax_encoding(world, tmp_path, codec):
    root = str(tmp_path / "artifacts")
    t = LocalFSTransport(root)
    t.publish_base(world["base"])
    model, _ = tg.make_model(TINY)
    loop = ttrain.MinerLoop(
        ttrain.TrainEngine(model, optimizer=ttrain.default_optimizer(1e-2),
                           device="cpu"),
        t, "hotkey_1", clock=FakeClock(), send_interval=2.0,
        log_every=10**9, delta_dtype=codec, delta_density=1 / 16)
    loop.bootstrap()
    loop.run(_batches(loop, world["train"]), max_steps=4)
    loop._push_delta()          # a push of the final state, in line
    loop.flush()
    delta = tg.params_to_numpy(tdl.compute_delta(loop.state.params,
                                                 loop.base_params))
    loop.close()
    assert loop.report.pushes >= 2
    data = t.fetch_delta_bytes("hotkey_1")
    assert data == _jax_bytes(codec, delta, 1 / 16)
    staged = JIngest(JFS(root), _template(world), workers=1).stage(
        ["hotkey_1"])[0]
    assert staged.reason == "ok"
    enc = jax.device_get(jax.jit(
        jdl.quantize_delta if codec == "int8" else
        (lambda x: jdl.sparsify_delta(x, density=1 / 16)))(
            jax.tree_util.tree_map(jnp.asarray, delta)))
    want = (jdl.dequantize_delta(enc) if codec == "int8" else
            jdl.densify_sparse_delta(enc, _template(world)))
    got = tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, staged.delta))
    for k, v in tdl.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        want)).items():
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("codec", ["int8", "sparse8"])
def test_jax_miner_artifact_decodes_in_the_port(world, tmp_path, codec):
    root = str(tmp_path / "artifacts")
    jt = JFS(root)
    jt.publish_base(jax.tree_util.tree_map(jnp.asarray, world["base"]))
    loop = jtrain.MinerLoop(world["jeng"], jt, "hotkey_2",
                            clock=JFakeClock(), send_interval=2.0,
                            log_every=10**9, delta_dtype=codec,
                            delta_density=1 / 16)
    loop.bootstrap(jax.random.PRNGKey(0))
    loop.run(_batches(loop, world["train"]), max_steps=4)
    loop.flush()
    assert loop.report.pushes >= 1
    ours = DeltaIngestor(LocalFSTransport(root), _template(world),
                         workers=1).stage(["hotkey_2"])[0]
    ref = JIngest(jt, _template(world), workers=1).stage(["hotkey_2"])[0]
    assert ours.reason == ref.reason == "ok"
    got, want = tdl.flatten_tree(ours.delta), tdl.flatten_tree(
        jax.tree_util.tree_map(np.asarray, ref.delta))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert max(float(np.abs(v).max()) for v in want.values()) > 0


@pytest.mark.parametrize("codec", ["int8", "sparse8"])
def test_miner_cli_delta_dtype_on_cpu(world, tmp_path, monkeypatch, codec):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tminer.main(
            ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--checkpoint-interval", "0", "--no-anomaly-trace",
             "--flight-events", "0", "--hotkey", "hotkey_3",
             "--delta-dtype", codec, "--delta-density", "0.0625",
             "--max-steps", "3", "--seq-len", "32", "--batch-size", "2",
             "--work-dir", work]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    data = JFS(f"{work}/artifacts").fetch_delta_bytes("hotkey_3")
    raw = jser.from_msgpack(data)
    if codec == "int8":
        assert set(raw["wte"]) == {"q", "scale"}
    else:
        assert int(np.asarray(raw[tdl.SPARSE_FORMAT_KEY])) == 1
        assert len(raw["leaves"]["wte"]["idx"]) == tdl.sparse_k(
            int(np.prod(np.shape(world["base"]["wte"]))), 0.0625)
    staged = JIngest(JFS(f"{work}/artifacts"), _template(world),
                     workers=1).stage(["hotkey_3"])[0]
    assert staged.reason == "ok"
