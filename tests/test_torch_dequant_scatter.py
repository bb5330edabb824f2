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


# ---------------------------------------------------------------------------
# The contribution-level fold: one table, one staged buffer
# ---------------------------------------------------------------------------

def _tiny_contribution(quant):
    """A tiny GPT-2's packed contribution (JAX pack_delta_v2, density
    1/16) whose wte entry is made hostile: every other index repeats its
    neighbour, so that leaf carries duplicates and the others do not."""
    from distributedtraining_tpu_torch.models import gpt2
    tree = gpt2.init_params_numpy(gpt2.PRESETS["tiny"], 3)
    rng = np.random.default_rng(11)
    d = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        tree)
    packed = _jpacked(d, density=1.0 / 16.0, quant=quant)
    wte = dict(packed["leaves"]["wte"])
    idx = np.array(wte["idx"])
    idx[1::2] = idx[0::2][:idx[1::2].size]
    packed["leaves"]["wte"] = dict(wte, idx=idx)
    start = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape)).astype(np.float32), tree)
    return packed, start


def _jax_fold(start, packed, w):
    """The JAX package's kernel-backed fold of one contribution
    (``delta._accum_packed_kernel``, the Pallas kernel interpreted), as
    ``{state-dict key: array}``."""
    leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(jnp.asarray, start))
    entries = jax.tree_util.tree_leaves(packed["leaves"],
                                        is_leaf=jdl.is_packed_entry)
    jdsc.use_interpret(True)
    out = jdl._accum_packed_kernel(leaves, entries, jnp.float32(w))
    jdsc.use_interpret(False)
    paths = [".".join(str(getattr(k, "key", k)) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(start)[0]]
    return {k: np.asarray(v) for k, v in zip(paths, out)}


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_contribution_fold_equals_jax_kernel_fold(quant):
    """The contribution-level plain path, fed through the concatenated
    idx/q buffer and the table the kernel reads, is array_equal to the
    JAX kernel fold on every leaf (indexed, dense-form, and the hostile
    leaf with duplicates); accumulate_delta takes the same path."""
    packed, start = _tiny_contribution(quant)
    w = 0.37
    ref = _jax_fold(start, packed, w)
    indexed = []
    acc = _state(start)
    for key, e in tdl._packed_entries(packed["leaves"]):
        if e["idx"].shape[0]:
            indexed.append((acc[key].view(-1), e["idx"], e["q"],
                            tdsc.fold_weight(w, e["scale"])))
    assert len(indexed) >= 3
    wte_idx = np.asarray(packed["leaves"]["wte"]["idx"])
    assert np.unique(wte_idx).size < wte_idx.size      # the hostile leaf
    c = tdsc.stage_contribution(indexed)
    assert c.table.size == len(indexed) and c.idx.dtype == torch.int32
    before = tdsc.launches
    tdsc.dequant_scatter_contribution(c)
    assert tdsc.launches == before
    for key, e in tdl._packed_entries(packed["leaves"]):
        if e["idx"].shape[0]:
            np.testing.assert_array_equal(acc[key].numpy(), ref[key])
    out = tdl.accumulate_delta(_state(start), packed, w)
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), ref[key])
    assert tdsc.launches == before


@pytest.mark.parametrize("seed", range(4))
def test_table_layout_covers_every_entry_once(seed):
    """Every entry of every leaf belongs to exactly one block of the
    grid; no two leaves' idx, q or bitmap ranges overlap; offsets keep
    the kernel's vector loads aligned."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 60))
    ns = rng.integers(1, 3_000_000, m)
    ks = np.minimum(ns, rng.integers(1, 5000, m))
    ks[0] = ns[0] = 1
    if m > 2:
        ks[1] = ns[1] = 1024 * 3
        ks[2] = 1025
        ns[2] = max(ns[2], 1025)
    sizes = rng.choice([1, 4], m)
    table, blocks, n_idx, n_q = tdsc.contribution_layout(ns, ks, sizes)
    assert (table["n"] == ns).all() and (table["k"] == ks).all()
    assert (table["e0"] % 4 == 0).all() and (table["qb"] % 16 == 0).all()
    covered = [np.zeros(k, np.int64) for k in ks]
    for b in blocks:
        k = ks[b["leaf"]]
        assert 0 <= b["j0"] < k and b["j0"] % 1024 == 0
        covered[b["leaf"]][b["j0"]:b["j0"] + 1024] += 1
    assert all((c == 1).all() for c in covered)
    for lo, size, total in ((table["e0"], ks, n_idx),
                            (table["qb"], ks * sizes, n_q),
                            (table["w0"] * 32, ns, None)):
        order = np.argsort(lo)
        ends = lo[order] + np.asarray(size)[order]
        assert (ends[:-1] <= lo[order][1:]).all()
        if total is not None:
            assert ends[-1] <= total
    assert tdsc.bitmap_words(table) == int((table["w0"]
                                            + -(-ns // 32)).max())


def test_contribution_kernel_refuses_cpu_and_mixed_devices():
    acc = torch.zeros(4096)
    idx = np.asarray([1, 2, 3], np.int32)
    q = np.asarray([3, 4, 5], np.int8)
    c = tdsc.stage_contribution([(acc, idx, q, 0.5)])
    with pytest.raises(ValueError, match="one CUDA device"):
        tdsc.dequant_scatter_contribution_kernel(c)
    mixed = c._replace(accs=[torch.zeros(4096, device="meta")])
    with pytest.raises(ValueError, match="one CUDA device"):
        tdsc.dequant_scatter_contribution(mixed)
    with pytest.raises(ValueError, match="more than one device"):
        tdsc.stage_contribution([(acc, idx, q, 0.5),
                                 (torch.zeros(8, device="meta"), idx, q,
                                  0.5)])
    assert not acc.any()


def test_stage_contribution_places_leaves_and_extras():
    """The staged buffer holds each leaf's idx and q where the table says
    and the extra arrays (dense-form q) after them, with their dtypes."""
    rng = np.random.default_rng(2)
    leaves = [(torch.zeros(100), rng.choice(100, 7, replace=False)
               .astype(np.int32), rng.integers(-9, 9, 7).astype(np.int8),
               0.25),
              (torch.zeros(50), np.asarray([3, 3, 49], np.int32),
               np.asarray([1.5, -2.0, 4.0], np.float32), 2.0)]
    extra = [np.arange(5, dtype=np.int8), np.ones(3, np.float32)]
    c = tdsc.stage_contribution(leaves, extra)
    for i, (_, idx, q, _) in enumerate(leaves):
        ci, cq = tdsc._leaf_views(c, i)
        np.testing.assert_array_equal(ci.numpy(), idx)
        np.testing.assert_array_equal(cq.numpy(), q)
    for got, want in zip(c.extra, extra):
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    tdsc.dequant_scatter_contribution(c)
    assert float(leaves[1][0][3]) == (1.5 - 2.0) * 2.0
