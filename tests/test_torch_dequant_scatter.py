"""The port's dequantize -> scatter-add (ops/dequant_scatter.py) and the
packed fold around it (delta.accumulate_delta, delta.aggregate_deltas)
against the JAX package, on the CPU.

- The plain version against the JAX Pallas kernel in interpret mode
  (``ops/dequant_scatter.py:_scatter_kernel``), int8 and f32 kept values,
  unique, random-duplicate and all-duplicate indices: ``array_equal``.
  The same two rounded operations run in the same order: ``val = f32(q) *
  sw``, then ``acc + val`` in j order.
- The plain version's duplicate order against an explicit serial loop
  (``index_add_`` on CPU tensors adds in index order).
- The fold on a mixed cohort (dense v1, packed int8, packed f32, a
  dense-form leaf, an empty leaf) against the JAX functions with the
  kernel interpreted (``use_interpret(True)``): within 1e-6.
- Packed entries pair with accumulator leaves by path, not by position.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.ops import dequant_scatter as jdsc
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.ops import dequant_scatter as tdsc


@pytest.fixture(autouse=True)
def _no_force_interpret():
    yield
    jdsc.use_interpret(False)


def _case(mode: str, qdtype, seed: int, n: int = 4096, k: int = 700):
    rng = np.random.default_rng(seed)
    acc = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if mode == "unique":
        idx = rng.choice(n, k, replace=False).astype(np.int32)
    elif mode == "dups":
        idx = rng.integers(0, n // 8, k).astype(np.int32)
    else:
        idx = np.full((k,), 11, np.int32)
    q = (rng.integers(-127, 128, k).astype(np.int8) if qdtype == "int8"
         else (rng.standard_normal(k) * 50.0).astype(np.float32))
    return acc, idx, q


@pytest.mark.parametrize("mode", ["unique", "dups", "alldup"])
@pytest.mark.parametrize("qdtype", ["int8", "float32"])
def test_plain_equals_jax_interpreted_kernel(mode, qdtype):
    acc, idx, q = _case(mode, qdtype, seed=len(mode) + len(qdtype))
    sw = tdsc.fold_weight(0.3718, 0.0171)
    ref = np.asarray(jdsc.dequant_scatter_add(
        jnp.asarray(acc), jnp.asarray(idx), jnp.asarray(q), sw,
        interpret=True))
    plain = tdsc.dequant_scatter_add_plain(
        torch.from_numpy(acc.copy()), torch.from_numpy(idx),
        torch.from_numpy(q), sw).numpy()
    np.testing.assert_array_equal(plain, ref)
    # the dispatch takes the plain version for a CPU accumulator, and
    # counts no kernel launch
    before = tdsc.launches
    out = tdsc.dequant_scatter_add(torch.from_numpy(acc.copy()),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(q), sw)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tdsc.launches == before


def test_plain_sums_duplicates_serially():
    """Values where the order of addition changes the f32 result: the
    plain version must equal the serial loop bit for bit."""
    acc = np.zeros((8,), np.float32)
    idx = np.asarray([1, 1, 1, 2, 1, 2], np.int32)
    q = np.asarray([1e8, 1.0, -1e8, 3.0, 1.0, 0.5], np.float32)
    sw = 1.0
    serial = acc.copy()
    for i, v in zip(idx, q * np.float32(sw)):
        serial[i] = np.float32(serial[i] + v)
    plain = tdsc.dequant_scatter_add_plain(
        torch.from_numpy(acc.copy()), torch.from_numpy(idx),
        torch.from_numpy(q), sw).numpy()
    np.testing.assert_array_equal(plain, serial)
    assert plain[1] == 1.0   # ((1e8 + 1) - 1e8) + 1 in f32


def test_fold_weight_is_one_f32_product():
    w, scale = 0.123456789, np.float32(0.000987654321)
    sw = tdsc.fold_weight(w, scale)
    ref = jnp.asarray(w, jnp.float32) * jnp.asarray(scale, jnp.float32)
    assert np.float32(sw) == np.float32(ref)
    assert sw == float(np.float32(w) * scale)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    acc = torch.zeros(16)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    q = torch.tensor([3, 4], dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tdsc.dequant_scatter_kernel(acc, idx, q, 1.0)
    with pytest.raises(ValueError, match="int32"):
        tdsc.dequant_scatter_add(acc, idx.long(), q, 1.0)
    with pytest.raises(ValueError, match="float32"):
        tdsc.dequant_scatter_add(acc.double(), idx, q, 1.0)
    with pytest.raises(ValueError, match="shapes"):
        tdsc.dequant_scatter_add(acc, idx, q[:1], 1.0)


# ---------------------------------------------------------------------------
# The packed fold against the JAX package
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((96, 64)) * scale).astype(np.float32),
            "b": (rng.standard_normal((32,)) * scale).astype(np.float32),
            "empty": np.zeros((0,), np.float32)}


def _template():
    return {"w": np.zeros((96, 64), np.float32),
            "b": np.zeros((32,), np.float32),
            "empty": np.zeros((0,), np.float32)}


def _jpacked(d, **kw):
    packed, _ = jdl.pack_delta_v2(jax.tree_util.tree_map(jnp.asarray, d),
                                  **kw)
    return jax.tree_util.tree_map(np.asarray, packed)


def _state(tree):
    return {k: torch.from_numpy(np.array(v))
            for k, v in tdl.flatten_tree(tree).items()}


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_accumulate_matches_jax_kernel_path(quant):
    rng = np.random.default_rng(5)
    d = _tree(rng)
    packed = _jpacked(d, density=1.0 / 16.0, quant=quant)
    assert packed["leaves"]["w"]["idx"].shape[0] > 0      # indexed form
    assert packed["leaves"]["b"]["idx"].shape[0] == 0     # dense form
    start = _tree(rng)
    jdsc.use_interpret(True)
    ref = jdl.accumulate_delta(jax.tree_util.tree_map(jnp.asarray, start),
                               packed, 0.7)
    jdsc.use_interpret(False)
    acc = _state(start)
    out = tdl.accumulate_delta(acc, packed, 0.7)
    assert out is acc      # in place
    for k in ("w", "b", "empty"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)
    # and against the densify spelling of the same fold
    dense = tdl.densify_packed_v2(packed, _template())
    again = tdl.accumulate_delta(_state(start), dense, 0.7)
    for k in ("w", "b"):
        np.testing.assert_allclose(again[k].numpy(), out[k].numpy(),
                                   atol=1e-6)


def test_aggregate_mixed_cohort_matches_jax():
    """Dense v1, packed int8 and packed f32 contributions folded by
    aggregate_deltas, against the JAX fold with the kernel interpreted."""
    rng = np.random.default_rng(6)
    deltas = [_tree(rng, 1e-2),
              _jpacked(_tree(rng, 1e-2), density=1.0 / 8.0, quant="int8"),
              _jpacked(_tree(rng, 1e-2), density=1.0 / 8.0, quant="none")]
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    jdsc.use_interpret(True)
    ref = jdl.aggregate_deltas(_template(), deltas, jnp.asarray(w))
    jdsc.use_interpret(False)
    out = tdl.aggregate_deltas(_state(_template()), deltas, w)
    for k in ("w", "b", "empty"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)


def test_hostile_duplicates_admitted_and_summed_like_jax():
    template = {"w": np.zeros((8192,), np.float32)}
    packed = {jdl.WIRE_V2_KEY: np.int32(jdl.WIRE_V2_FORMAT),
              "leaves": {"w": {"idx": np.asarray([5, 5, 5, 9], np.int32),
                               "q": np.asarray([10, 20, -5, 7], np.int8),
                               "scale": np.asarray(0.5, np.float32)}}}
    assert tdl.packed_matches(packed, template)
    assert jdl.packed_matches(packed, template)
    jdsc.use_interpret(True)
    ref = jdl.accumulate_delta({"w": jnp.zeros((8192,), jnp.float32)},
                               packed, 1.0)
    jdsc.use_interpret(False)
    out = tdl.accumulate_delta({"w": torch.zeros(8192)}, packed, 1.0)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))
    assert float(out["w"][5]) == (10 + 20 - 5) * 0.5


def test_entries_pair_with_leaves_by_path():
    """Keys whose component order and flat-string order differ ("a" <
    "a-b" per component, "a-b.x" < "a.x" as strings): the fold must pair
    each entry with the leaf of its path."""
    template = {"a": {"x": np.zeros((6000,), np.float32)},
                "a-b": {"x": np.zeros((5000,), np.float32)}}
    rng = np.random.default_rng(7)
    d = {"a": {"x": rng.standard_normal(6000).astype(np.float32)},
         "a-b": {"x": rng.standard_normal(5000).astype(np.float32)}}
    packed = _jpacked(d, density=0.1)
    acc = {"a-b.x": torch.zeros(5000), "a.x": torch.zeros(6000)}
    assert list(acc) != [".".join(p) for p, _ in
                         tdl._walk_state_dict(template)]
    out = tdl.accumulate_delta(acc, packed, 1.0)
    dense = tdl.densify_packed_v2(packed, template)
    np.testing.assert_allclose(out["a.x"].numpy(), dense["a"]["x"],
                               atol=1e-6)
    np.testing.assert_allclose(out["a-b.x"].numpy(), dense["a-b"]["x"],
                               atol=1e-6)
    with pytest.raises(ValueError, match="paths"):
        tdl.accumulate_delta({"a.x": torch.zeros(6000)}, packed, 1.0)


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["unique", "dups", "alldup"])
def test_card_check_rejects_planted_wrong_results(mode):
    """The scatter phase's limit (bit-exact) passes the plain result and
    fails both planted wrong ones (an entry dropped, a value negated)."""
    smoke = _chip_smoke()
    acc0, idx, q = smoke._scatter_case(5000, 900, mode, True, 3)
    sw = tdsc.fold_weight(0.37, 0.0123)
    ref = tdsc.dequant_scatter_add_plain(acc0.clone(), idx, q, sw)
    assert smoke._scatter_check(mode, ref.clone(), ref) == 0.0
    planted = smoke._scatter_planted(acc0, idx, q, sw)
    assert sorted(planted) == ["dropped", "negated"]
    for bad in planted.values():
        with pytest.raises(smoke.SmokeFailure, match=mode):
            smoke._scatter_check(mode, bad, ref)
