"""GPT-2 in the PyTorch port (distributedtraining_tpu_torch/models/gpt2.py,
ops/attention.py, ops/embed.py) against the JAX package, on the CPU.

The weights travel as the JAX package's unrolled numpy tree through
``params_from_numpy``; the same inputs, made with numpy from a seed, go
through both forwards. f32 logits agree to 1e-5 (summation order differs
between the two frameworks' CPU kernels); a bf16 forward agrees loosely
(5e-2), which catches a misplaced cast without pinning rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.ops import attention as jatt
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.ops import attention as tatt
from distributedtraining_tpu_torch.ops import flash_attention
from distributedtraining_tpu_torch.ops.embed import embed_lookup

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside timing-sensitive JAX
    tests; these tiny shapes need no intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharpened_tree(cfg, seed):
    """The JAX init distributions with dense kernels and positions scaled
    x10, so logits and generations depend on the context (at the init
    scale a random GPT-2 mostly repeats its last token)."""
    tree = tg.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


@pytest.fixture(scope="module")
def world():
    tree = sharpened_tree(TINY, 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel, _ = jg.make_model(JTINY)
    net = tg.bind(TINY, tg.params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY.vocab_size, (2, 24))
    return tree, jmodel, jparams, net, ids


def _apply(jmodel, params, ids, **kw):
    """The JAX forward, jitted (one XLA compile instead of one per eager
    op); ``sow_kv`` returns the intermediates too."""
    if kw.pop("sow_kv", False):
        fn = lambda p, i, k: jmodel.apply(  # noqa: E731
            {"params": p}, i, sow_kv=True, mutable=["intermediates"], **k)
    else:
        fn = lambda p, i, k: jmodel.apply({"params": p}, i, **k)  # noqa
    return jax.jit(fn)(params, jnp.asarray(ids),
                       {k: jnp.asarray(v) if isinstance(v, np.ndarray)
                        else v for k, v in kw.items()})


def _close(ours, ref, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def test_params_round_trip_on_the_jax_tree():
    """params_from_numpy / params_to_numpy keep every name, shape, dtype
    and value of the JAX package's own init tree, and the state binds
    to the port's module with strict names."""
    jmodel, _ = jg.make_model(JTINY)
    jtree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jmodel.init_params(key))(jax.random.PRNGKey(0)))
    state = tg.params_from_numpy(jtree, device="cpu")
    back = tg.params_to_numpy(state)
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    assert state["h_0.c_attn.kernel"].shape == (TINY.n_embd,
                                                3 * TINY.n_embd)
    assert state["wte"].shape == (TINY.padded_vocab, TINY.n_embd)
    net = tg.bind(TINY, state)
    assert net.h_1.mlp_proj.kernel.data_ptr() == \
        state["h_1.mlp_proj.kernel"].data_ptr()     # bound, not copied


def test_numpy_init_has_the_jax_tree_layout():
    jmodel, _ = jg.make_model(JTINY)
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0)))
    ours = tg.init_params_numpy(TINY, 0)
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_o]
    for (_, a), (_, b) in zip(flat_j, flat_o):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_scan_layout_is_refused():
    """Where JAX refuses the scan layout, the port does: generation (the
    KV-cache hooks) needs the unrolled blocks. The layout itself loads
    under the scan model's names (``h.block.*``, ``[L, ...]``)."""
    cfg = dataclasses.replace(TINY, scan_blocks=True)
    state = tg.params_from_numpy(tg.init_params_numpy(cfg, 0), device="cpu")
    assert state["h.block.c_attn.kernel"].shape[0] == cfg.n_layer
    model = tg.bind(cfg, state)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="unrolled"):
        model(ids, sow_kv=True)


# ---------------------------------------------------------------------------
# Forward parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["no_mask", "padding_mask",
                                     "position_ids"])
def test_logits_match_jax(world, variant):
    tree, _, jparams, _, ids = world
    kw_j, kw_t = {}, {}
    impl = "flash"
    if variant == "no_mask":
        impl = "dense"        # unmasked flash is the training kernel
    elif variant == "padding_mask":
        amask = np.ones(ids.shape, np.int32)
        amask[1, 17:] = 0
        kw_j["attention_mask"] = amask
        kw_t["attention_mask"] = torch.from_numpy(amask)
    else:
        impl = "dense"
        pos = np.random.default_rng(2).integers(0, TINY.n_positions,
                                                ids.shape)
        kw_j["position_ids"] = pos
        kw_t["position_ids"] = torch.from_numpy(pos)
    jmodel, _ = jg.make_model(dataclasses.replace(JTINY,
                                                  attention_impl=impl))
    net = tg.bind(dataclasses.replace(TINY, attention_impl=impl),
                  tg.params_from_numpy(tree, device="cpu"))
    ref = _apply(jmodel, jparams, ids, **kw_j)
    ours = net(torch.from_numpy(ids), **kw_t)
    assert ours.shape == ref.shape == (2, 24, TINY.padded_vocab)
    _close(ours, ref, 1e-5)


def test_sown_kv_match_jax(world):
    _, jmodel, jparams, net, ids = world
    amask = np.ones(ids.shape, np.int32)
    _, muts = _apply(jmodel, jparams, ids, attention_mask=amask,
                     sow_kv=True)
    _, kvs = net(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(amask), sow_kv=True)
    assert len(kvs) == TINY.n_layer
    for i, (k, v) in enumerate(kvs):
        jk, jv = muts["intermediates"][f"h_{i}"]["kv_cache"][0]
        _close(k, jk, 1e-5)
        _close(v, jv, 1e-5)


def test_paged_decode_forward_matches_jax(world):
    """One decode step through the paged hooks (the plain paged version
    on the CPU) vs the JAX package's kv_pages forward: logits and sown
    (k, v)."""
    _, jmodel, jparams, net, _ = world
    L, P, MP, B = TINY.n_layer, 8, 3, 3
    H, D = TINY.n_head, TINY.head_dim
    pool = 1 + B * MP
    rng = np.random.default_rng(3)
    kp = rng.standard_normal((L, pool, P, H, D)).astype(np.float32)
    vp = rng.standard_normal((L, pool, P, H, D)).astype(np.float32)
    tables = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    lens = np.asarray([5, 17, 0], np.int32)
    toks = np.asarray([[3], [7], [11]], np.int64)
    ref, muts = _apply(
        jmodel, jparams, toks, position_ids=lens[:, None],
        kv_pages=tuple((jnp.asarray(kp[i]), jnp.asarray(vp[i]))
                       for i in range(L)),
        page_tables=tables, kv_lens=lens, sow_kv=True)
    lens_t = torch.from_numpy(lens)
    ours, kvs = net(torch.from_numpy(toks),
                    position_ids=lens_t[:, None].long(),
                    kv_pages=[(torch.from_numpy(kp[i]),
                               torch.from_numpy(vp[i])) for i in range(L)],
                    page_tables=torch.from_numpy(tables), kv_lens=lens_t,
                    sow_kv=True)
    _close(ours, ref, 1e-5)
    for i, (k, v) in enumerate(kvs):
        jk, jv = muts["intermediates"][f"h_{i}"]["kv_cache"][0]
        _close(k, jk, 1e-5)
        _close(v, jv, 1e-5)


def test_bf16_forward_close_to_jax():
    """At the served compute dtype (bf16 activations, f32 weights) the
    two forwards round at the same points; 5e-2 catches a misplaced
    cast."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    tree = tg.init_params_numpy(cfg, 4)
    jmodel, _ = jg.make_model(dataclasses.replace(JTINY, dtype="bfloat16"))
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    amask = np.ones(ids.shape, np.int32)
    ref = _apply(jmodel, jax.tree_util.tree_map(jnp.asarray, tree), ids,
                 attention_mask=amask)
    ours = tg.bind(cfg, tg.params_from_numpy(tree, device="cpu"))(
        torch.from_numpy(ids), attention_mask=torch.from_numpy(amask))
    assert ours.dtype == torch.float32
    _close(ours, ref, 5e-2)


# ---------------------------------------------------------------------------
# Attention and embedding ops
# ---------------------------------------------------------------------------

def _qkv(B, T, H, D, seed, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, H, D)).astype(np.float32))


def test_flash_with_padding_mask_at_long_t_is_blockwise():
    """Prefill at T >= BLOCKWISE_FALLBACK_LEN (a prompt over 512 tokens
    at page size 16) takes the blockwise path in both packages; a query
    row whose keys are all padded emits exact zeros in both."""
    T = tatt.BLOCKWISE_FALLBACK_LEN
    q, k, v = _qkv(1, T, 2, 16, 6)
    amask = np.ones((1, T), np.int32)
    amask[0, 700:] = 0
    amask[0, 0] = 0
    ref = jax.jit(lambda *a: jatt.causal_attention(
        *a[:3], attention_mask=a[3], impl="flash"))(q, k, v, amask)
    ours = tatt.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 attention_mask=torch.from_numpy(amask),
                                 impl="flash")
    _close(ours, ref, 1e-5)
    assert float(ours[0, 0].abs().max()) == 0.0


def test_blockwise_with_segments_matches_jax():
    q, k, v = _qkv(2, 40, 2, 8, 7)
    seg = np.repeat(np.arange(4), 10)[None].repeat(2, 0).astype(np.int32)
    ref = jax.jit(lambda *a: jatt.blockwise_attention(
        *a[:3], segment_ids=a[3], block_q=16, block_kv=8))(q, k, v, seg)
    ours = tatt.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    segment_ids=torch.from_numpy(seg),
                                    block_q=16, block_kv=8)
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("Tq", [1, 3])
def test_cached_attention_matches_jax(Tq):
    S = 24
    q, k, v = _qkv(3, Tq, 2, 16, 8, Tk=S + Tq)
    lens = np.asarray([0, 7, S], np.int32)
    ref = jax.jit(jatt.cached_attention)(q, k, v, lens)
    ours = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    _close(ours, ref, 1e-6)


def test_dot_product_attention_matches_jax():
    q, k, v = _qkv(2, 12, 2, 16, 9)
    amask = np.ones((2, 12), np.int32)
    amask[1, 9:] = 0
    jmask = jatt.combine_masks(jatt.make_causal_mask(12),
                               jnp.asarray(amask), None)
    tmask = tatt.combine_masks(tatt.make_causal_mask(12),
                               torch.from_numpy(amask), None)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    ref = jax.jit(jatt.dot_product_attention)(q, k, v, jmask)
    ours = tatt.dot_product_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), tmask)
    _close(ours, ref, 1e-6)


def test_embed_lookup_clips_like_jax_take():
    table = np.random.default_rng(10).standard_normal((5, 3)).astype(
        np.float32)
    ids = np.asarray([[0, 4, 7, -2]])
    ref = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0,
                   mode="clip")
    ours = embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_unported_attention_paths_raise():
    """Ring attention without an sp mesh is dense attention, as in JAX
    (the ring itself: tests/test_torch_sp.py); an unknown impl raises;
    unmasked flash on the CPU runs the flash kernels' plain version (the
    JAX package's dense result) and launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 8, 11))
    ring = tatt.causal_attention(q, k, v, impl="ring")
    np.testing.assert_array_equal(
        ring.numpy(), tatt.causal_attention(q, k, v, impl="dense").numpy())
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.causal_attention(q, k, v, impl="paged")
    before = dict(flash_attention.launches)
    out = tatt.causal_attention(q, k, v, impl="flash")
    assert flash_attention.launches == before
    ref = jax.jit(lambda *a: jatt.causal_attention(*a, impl="dense"))(
        *(x.numpy() for x in (q, k, v)))
    _close(out, ref, 1e-5)
