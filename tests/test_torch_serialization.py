"""The msgpack codec of the PyTorch port
(distributedtraining_tpu_torch/serialization.py) against the JAX package's
``serialization`` (flax + msgpack), on the CPU.

The port carries its own pure-Python encoder and decoder (the card
machine has no flax, msgpack or ml_dtypes). For the same tree the bytes
must be equal, and each package must read the other's: the tiny GPT-2
tree, an f32 delta and a bf16 delta (bf16 leaves are torch tensors on the
port's side), plus flax's chunked form with the chunk limit lowered on
both sides.
"""

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.models import gpt2 as tg


@pytest.fixture(scope="module")
def trees():
    """(params, f32 delta, bf16 delta as the JAX package holds it, the
    same bf16 delta as the port holds it)."""
    cfg = tg.PRESETS["tiny"]
    base = tg.init_params_numpy(cfg, 0)
    trained = tg.init_params_numpy(cfg, 1)
    delta = jax.tree_util.tree_map(lambda a, b: (a - b) * 0.01, trained,
                                   base)
    jbf = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                 delta)
    tbf = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)).to(torch.bfloat16), delta)
    return base, delta, jbf, tbf


def _equal(a, b) -> bool:
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        x = x.float().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x, np.float32)
        y = y.float().numpy() if isinstance(y, torch.Tensor) else \
            np.asarray(y, np.float32)
        if x.shape != y.shape or not np.array_equal(x, y):
            return False
    return True


@pytest.mark.parametrize("which", ["params", "f32_delta", "bf16_delta"])
def test_bytes_equal_and_each_reads_the_other(trees, which):
    base, delta, jbf, tbf = trees
    jtree, ttree = {"params": (base, base), "f32_delta": (delta, delta),
                    "bf16_delta": (jbf, tbf)}[which]
    jbytes, tbytes = jser.to_msgpack(jtree), tser.to_msgpack(ttree)
    assert jbytes == tbytes
    ours = tser.from_msgpack(jbytes, base)
    assert _equal(ours, ttree)
    if which == "bf16_delta":
        assert ours["wte"].dtype == torch.bfloat16
    theirs = jser.from_msgpack(tbytes, jax.tree_util.tree_map(np.asarray,
                                                              base))
    assert _equal(theirs, jtree)


def test_scalars_and_int_leaves_encode_like_flax():
    tree = {"b": {"n": np.int32(7), "x": np.float32(-1.5)},
            "a": np.arange(40, dtype=np.int64) - 20,
            "e": np.zeros((0, 3), np.float32)}
    assert tser.to_msgpack(tree) == jser.to_msgpack(tree)
    back = tser.from_msgpack(jser.to_msgpack(tree), tree)
    assert np.array_equal(back["a"], tree["a"]) and back["b"]["n"] == 7


def test_chunked_leaves_round_trip_both_ways(trees, monkeypatch):
    base, _, jbf, tbf = trees
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 4096)
    for jtree, ttree in ((base, base), (jbf, tbf)):
        jbytes, tbytes = jser.to_msgpack(jtree), tser.to_msgpack(ttree)
        assert jbytes == tbytes
        raw = tser.from_msgpack(tbytes)     # no template: the raw tree
        assert _equal(raw, ttree)
        assert _equal(jser.from_msgpack(tbytes, jax.tree_util.tree_map(
            np.asarray, base)), jtree)


def test_payload_errors(trees):
    base, delta, _, _ = trees
    data = tser.to_msgpack(delta)
    wrong_keys = {k: v for k, v in base.items() if k != "wte"}
    wrong_keys["wtf"] = base["wte"]
    with pytest.raises(tser.PayloadError, match="structure"):
        tser.from_msgpack(tser.to_msgpack(wrong_keys), base)
    reshaped = dict(base, wpe=np.zeros((3, 3), np.float32))
    with pytest.raises(tser.PayloadError, match="shape"):
        tser.from_msgpack(tser.to_msgpack(reshaped), base)
    for bad in (data[:-7], b"\xc1" + data, data + b"\x00", b""):
        with pytest.raises(tser.PayloadError, match="malformed"):
            tser.from_msgpack(bad, base)
    with pytest.raises(tser.PayloadError, match="cap"):
        tser.from_msgpack(data, base, max_bytes=len(data) - 1)
    # the JAX package refuses what the port refuses
    with pytest.raises(jser.PayloadError):
        jser.from_msgpack(tser.to_msgpack(reshaped),
                          jax.tree_util.tree_map(np.asarray, base))


def test_save_and_load_file_atomically(tmp_path, trees):
    base, delta, _, _ = trees
    path = str(tmp_path / "deltas" / "m.msgpack")
    tser.save_file(delta, path)
    assert open(path, "rb").read() == jser.to_msgpack(delta)
    assert not list((tmp_path / "deltas").glob("*.tmp"))
    assert _equal(tser.load_file(path, base), delta)
    with pytest.raises(tser.PayloadError, match="cap"):
        tser.load_file(path, base, max_bytes=10)
    # a .safetensors path writes safetensors (JAX's bytes), never msgpack
    st = str(tmp_path / "m.safetensors")
    tser.save_file(delta, st)
    assert open(st, "rb").read() == jser.to_safetensors(delta)
    assert _equal(tser.load_file(st, base), delta)
