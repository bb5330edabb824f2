"""The Llama family of the PyTorch port (distributedtraining_tpu_torch/
models/llama.py, the family dispatch of models/__init__.py) against the
JAX package's ``models/llama.py``, on the CPU.

The weights travel as the JAX package's unrolled numpy tree through
``params_from_numpy``; the same inputs, made with numpy from a seed, go
through both forwards (the JAX side jitted, as its engines run it). f32
logits, hidden states and sown keys/values agree to 1e-5 (summation
order); RoPE to 1e-6 at positions up to 8191 (the frequencies are the
compiled program's correctly rounded values, so only cos/sin ulps
differ); RMSNorm to 1e-6. The full presets are compared by name, shape
and dtype only: the port's structure lives on the meta device and JAX's
is ``jax.eval_shape``'s, so nothing of 8B is allocated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.models import llama as tl

TINY = dataclasses.replace(tl.PRESETS["tiny-llama"], dtype="float32")
JTINY = dataclasses.replace(jl.PRESETS["tiny-llama"], dtype="float32")
# the same widths with as many kv heads as query heads (no GQA broadcast)
MHA = dataclasses.replace(TINY, n_kv_head=TINY.n_head)
JMHA = dataclasses.replace(JTINY, n_kv_head=JTINY.n_head)
DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside timing-sensitive JAX
    tests; these tiny shapes need no intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharpened_tree(cfg, seed):
    """The JAX init distributions with the dense kernels scaled x10, so
    attention and the logits depend on the context (at the init scale a
    random Llama's attention is near uniform)."""
    tree = tl.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("layer_"):
            for name in DENSE:
                block[name]["kernel"] *= 10.0
    return tree


def _packed_inputs(vocab, seed=1):
    """Two rows of 24 ids: one packed with two documents (segment ids 1
    and 2, positions restarting at each), one whole."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (2, 24))
    seg = np.array([[1] * 10 + [2] * 14, [1] * 24], np.int32)
    pos = np.array([list(range(10)) + list(range(14)), list(range(24))],
                   np.int32)
    return ids, seg, pos


def _close(ours, ref, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,jcfg", [(TINY, JTINY), (MHA, JMHA)],
                         ids=["gqa", "mha"])
def test_forward_matches_jax(cfg, jcfg):
    """Logits and the final hidden states on packed rows (segment ids and
    per-row positions) and on an unpacked batch (default positions), in
    f32, within 1e-5 of the JAX forward."""
    tree = sharpened_tree(cfg, 0)
    jmodel, _ = jl.make_model(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    net = models.bind(cfg, models.params_from_numpy(tree, device="cpu"))
    ids, seg, pos = _packed_inputs(cfg.vocab_size)
    with torch.no_grad():
        logits = net(torch.from_numpy(ids),
                     segment_ids=torch.from_numpy(seg),
                     position_ids=torch.from_numpy(pos).long())
        hidden = net(torch.from_numpy(ids),
                     segment_ids=torch.from_numpy(seg),
                     position_ids=torch.from_numpy(pos).long(),
                     return_hidden=True)
        plain = net(torch.from_numpy(ids))
    assert logits.shape == (2, 24, cfg.padded_vocab)
    assert hidden.shape == (2, 24, cfg.n_embd)
    fwd = jax.jit(lambda p, i, s, q: jmodel.apply(
        {"params": p}, i, segment_ids=s, position_ids=q))
    hid = jax.jit(lambda p, i, s, q: jmodel.apply(
        {"params": p}, i, segment_ids=s, position_ids=q,
        return_hidden=True))
    _close(logits, fwd(jparams, ids, seg, pos), 1e-5)
    _close(hidden, hid(jparams, ids, seg, pos), 1e-5)
    _close(plain, jax.jit(lambda p, i: jmodel.apply({"params": p}, i))(
        jparams, ids), 1e-5)
    # the logits depend on the context: the packed row's second document
    # is not the unpacked row's tail
    assert float((logits[0, 10:] - plain[0, 10:]).abs().max()) > 1e-2


def test_sown_kv_matches_jax():
    """``sow_kv`` gives each layer's post-RoPE, pre-broadcast (k, v) with
    n_kv_head heads: JAX's ``intermediates/layer_i/kv_cache``."""
    tree = sharpened_tree(TINY, 1)
    jmodel, _ = jl.make_model(JTINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    net = models.bind(TINY, models.params_from_numpy(tree, device="cpu"))
    ids, _, _ = _packed_inputs(TINY.vocab_size, seed=2)
    with torch.no_grad():
        logits, kvs = net(torch.from_numpy(ids), sow_kv=True)
    jlogits, inter = jax.jit(lambda p, i: jmodel.apply(
        {"params": p}, i, sow_kv=True, mutable=["intermediates"]))(
        jparams, ids)
    _close(logits, jlogits, 1e-5)
    assert len(kvs) == TINY.n_layer
    for i, (k, v) in enumerate(kvs):
        (jk, jv), = inter["intermediates"][f"layer_{i}"]["kv_cache"]
        assert k.shape == (2, 24, TINY.n_kv_head, TINY.head_dim)
        _close(k, jk, 1e-5)
        _close(v, jv, 1e-5)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rotary_embedding_matches_jax(theta):
    """RoPE at both presets' bases over positions 0..8191 (Llama-3-8B's
    whole context) at D 128: within 1e-6 of JAX's jitted function (the
    frequencies bit-equal, cos/sin within an ulp)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8192, 2, 128)).astype(np.float32)
    pos = np.arange(8192)[None]
    ref = jax.jit(lambda a, p: jl.rotary_embedding(a, p, theta))(x, pos)
    out = tl.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
    _close(out, ref, 1e-6)
    # bf16 in, bf16 out, from the same f32 math
    xb = torch.from_numpy(x[:, :64]).bfloat16()
    outb = tl.rotary_embedding(xb, torch.from_numpy(pos[:, :64]), theta)
    assert outb.dtype == torch.bfloat16
    refb = jax.jit(lambda a, p: jl.rotary_embedding(a, p, theta))(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), pos[:, :64])
    _close(outb.float(), np.asarray(refb.astype(jnp.float32)), 1e-2)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    ref = jl.RMSNorm(1e-5, "float32").apply({"params": {"scale": scale}}, x)
    norm = tl.RMSNorm(64, TINY)
    norm.load_state_dict({"scale": torch.from_numpy(scale)}, assign=True)
    _close(norm(torch.from_numpy(x)), ref, 1e-6)


# ---------------------------------------------------------------------------
# Trees and presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["llama2-7b", "llama3-8b", "tiny-llama"])
def test_preset_structure_matches_jax_init(preset):
    """Every parameter's name, shape and dtype, against ``jax.eval_shape``
    of the JAX init: the port's model on the meta device (no storage),
    the state dict keys the JAX paths joined with ``.``."""
    jmodel, _ = jl.make_model(preset)
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0)))
    want = {".".join(str(k.key) for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    model, cfg = models.make_model(preset)
    assert models.family(preset) is tl and cfg == tl.PRESETS[preset]
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert all(v.device.type == "meta" for v in model.state_dict().values())
    assert got == want
    if preset == "llama3-8b":
        assert sum(int(np.prod(s)) for s, _ in got.values()) == 8030261248


def test_numpy_init_has_the_jax_tree_layout():
    jmodel, _ = jl.make_model(JTINY)
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0)))
    ours = models.init_params_numpy(TINY, 0)
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_o]
    for (_, a), (_, b) in zip(flat_j, flat_o):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert np.all(ours["final_norm"]["scale"] == 1.0)
    assert abs(float(ours["lm_head"].std()) - 0.02) < 2e-3


def test_params_round_trip_bit_equal_on_the_jax_tree():
    """JAX's own init tree through ``params_from_numpy`` and back: every
    name, shape, dtype and bit kept; the state binds without a copy."""
    jmodel, _ = jl.make_model(JTINY)
    jtree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jmodel.init_params(key))(jax.random.PRNGKey(0)))
    state = models.params_from_numpy(jtree, device="cpu")
    back = models.params_to_numpy(state)
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path
    assert state["layer_0.wk.kernel"].shape == (
        TINY.n_embd, TINY.n_kv_head * TINY.head_dim)
    assert state["lm_head"].shape == (TINY.padded_vocab, TINY.n_embd)
    net = models.bind(TINY, state)
    assert net.layer_1.w_down.kernel.data_ptr() == \
        state["layer_1.w_down.kernel"].data_ptr()
    # JAX's scan layout (layers/block, [L, ...] leaves) maps onto the
    # scan model's own names
    stacked = jl.stack_blocks(jtree, TINY.n_layer)
    sstate = models.params_from_numpy(stacked, device="cpu")
    smodel, _ = models.make_model(dataclasses.replace(TINY,
                                                      scan_blocks=True))
    assert set(sstate) == set(smodel.state_dict())
    assert sstate["layers.block.wk.kernel"].shape == (
        TINY.n_layer, TINY.n_embd, TINY.n_kv_head * TINY.head_dim)
    assert torch.equal(sstate["layers.block.wk.kernel"][1],
                       state["layer_1.wk.kernel"])


def test_family_dispatch_and_draft_compat():
    """One place picks the family, from a preset name, a config or a
    model; the drafter family's rule (equal real vocabularies) lets a
    GPT-2 drafter draft for a Llama target, as JAX's hooks do."""
    assert models.family("gpt2-124m") is tg
    assert models.family(TINY) is tl
    assert models.family(models.make_model("tiny")[0]) is tg
    with pytest.raises(KeyError, match="tiny-llama"):
        models.family("llama-70b")
    gpt_drafter = dataclasses.replace(tg.PRESETS["tiny"])
    assert models.draft_compat(gpt_drafter, TINY) is None
    assert models.draft_compat(TINY, gpt_drafter) is None
    other = dataclasses.replace(TINY, vocab_size=256)
    assert models.draft_compat(other, TINY) == jl.draft_compat(
        dataclasses.replace(JTINY, vocab_size=256), JTINY)


# ---------------------------------------------------------------------------
# The train engine on a Llama
# ---------------------------------------------------------------------------

def _word_batches(n, B=4, T=64, seed=3):
    docs = tds.text_corpus(split="train", n_docs=96, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T,
                            repeat=True, shuffle=True, seed=seed)
    return [next(it) for _ in range(n)]


def _assert_trees_close(ours: dict, ref, atol, what):
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, ref))[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_o, flat_r):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_engine_on_a_llama_matches_jax(fused):
    """``TrainEngine`` built on tiny-llama (f32, packed batches): one
    step's loss and gradients within 1e-5 of JAX's, then three AdamW
    steps' losses within 1e-5 and parameters within 1e-5; the fused CE
    takes the untied ``lm_head``. The wire template is JAX's
    ``host_param_template`` layout, and evaluate agrees."""
    tree = models.init_params_numpy(TINY, 0)
    batches = _word_batches(4)
    jmodel, _ = jl.make_model(JTINY)
    model, _ = models.make_model(TINY)
    jeng = jtrain.TrainEngine(jmodel, fused_loss=fused)
    eng = ttrain.TrainEngine(model, fused_loss=fused, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss_fn = jtrain._fused_lm_loss if fused else jtrain._default_lm_loss
    loss_fn = ttrain._fused_lm_loss if fused else ttrain._default_lm_loss
    jl_, jt, jgrads = jax.jit(lambda p, b: jtrain.accumulated_grads(
        lambda pp, bb: jloss_fn(jmodel, pp, bb), p, b, 1))(
        jparams, batches[0])
    state = eng.init_state(models.params_from_numpy(tree, device="cpu"))
    loss, tokens, grads = ttrain.accumulated_grads(
        lambda p, b: loss_fn(model, p, b), state.params,
        eng.place_batch(batches[0]), 1)
    np.testing.assert_allclose(float(loss), float(jl_), rtol=1e-5)
    assert float(tokens) == float(jt)
    _assert_trees_close(models.params_to_numpy(grads), jgrads, 1e-5, "grad")
    jstate = jeng.init_state(params=jparams)
    for batch in batches[1:]:
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, eng.place_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(models.params_to_numpy(state.params), jstate.params,
                        1e-5, "param")
    ours = eng.evaluate(state.params, [eng.place_batch(batches[0])])
    ref = jeng.evaluate(jstate.params, [batches[0]])
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    template = ttrain._wire_template(model)
    flat_t = jax.tree_util.tree_flatten_with_path(template)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0))))[0]
    assert [(p, a.shape, str(a.dtype)) for p, a in flat_t] == \
        [(p, a.shape, str(a.dtype)) for p, a in flat_j]


def test_train_engine_reads_a_missing_dropout_as_zero_and_refuses_a_mesh():
    """A Llama config has no ``dropout`` field (JAX's has none either):
    the engine builds. On a world-1 mesh (item 2(b)) it builds with every
    parameter's JAX spec and no tp route, and its step's loss and
    parameters are the one-device engine's; a mesh whose axis does not
    divide a parameter is refused, as JAX's placement refuses it."""
    import socket

    from distributedtraining_tpu_torch.parallel import multihost
    from distributedtraining_tpu_torch.parallel.mesh import Mesh, MeshConfig
    model, _ = models.make_model(TINY)
    assert not hasattr(TINY, "dropout")
    one = ttrain.TrainEngine(model, device="cpu")
    tree = models.init_params_numpy(TINY, 0)
    batch = _word_batches(1)[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        eng = ttrain.TrainEngine(model, mesh=Mesh(MeshConfig()),
                                 device="cpu")
        assert eng.tp_route is None
        assert set(eng.specs) == set(model.state_dict())
        assert eng.specs["lm_head"] == ("tp", "fsdp")
        params = models.params_from_numpy(tree, device="cpu")
        s1, m1 = one.train_step(one.init_state(params), one.place_batch(batch))
        sm, mm = eng.train_step(eng.init_state(params), eng.place_batch(batch))
        np.testing.assert_allclose(float(mm["loss"]), float(m1["loss"]),
                                   rtol=1e-6)
        assert float(mm["tokens"]) == float(m1["tokens"])
        for k, v in s1.params.items():
            np.testing.assert_allclose(sm.params[k].detach().numpy(),
                                       v.detach().numpy(), atol=1e-7,
                                       err_msg=k)
    finally:
        multihost.shutdown()
    bad = Mesh.__new__(Mesh)      # a shape and coordinates, no world
    bad.shape = {"dp": 1, "fsdp": 3, "sp": 1, "tp": 1}
    bad.coords = {"dp": 0, "fsdp": 0, "sp": 0, "tp": 0}
    with pytest.raises(ValueError, match=r"not divisible by \('fsdp',\) = 3"):
        ttrain.TrainEngine(model, mesh=bad, device="cpu")
