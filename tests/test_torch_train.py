"""The training slice of the PyTorch port (distributedtraining_tpu_torch/
data, ops/losses.py, engine/train.py, delta.py, the GPT-2 training
forward) against the JAX package, on the CPU.

Both sides get the same packed batches and the same weights (made with
numpy from a seed, carried across with ``params_from_numpy``); the tiny
preset runs in f32. The JAX package's flash attention declines on the CPU
and runs dense there, which is the oracle; the port runs its flash
attention's plain versions (the formulas of its CUDA kernels).
Tolerances: 1e-5 on one step's loss (relative) and gradients (absolute),
1e-4 absolute on a 20-step AdamW loss trajectory, where summation-order
differences compound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedtraining_tpu import delta as jdelta
from distributedtraining_tpu.data import datasets as jds
from distributedtraining_tpu.data import packing as jpack
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.ops import losses as jlosses
from distributedtraining_tpu_torch import delta as tdelta
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.data import packing as tpack
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.ops import flash_attention as tfa
from distributedtraining_tpu_torch.ops import losses as tlosses

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 4, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _word_batches(n, *, split="train", seed=3):
    docs = tds.text_corpus(split=split, n_docs=96, seed=0)
    tok = tds.WordTokenizer(tds.text_corpus(n_docs=96, seed=0),
                            vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T,
                            repeat=True, shuffle=split == "train",
                            seed=seed)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    """Weights, 21 shuffled packed training batches, 2 held-out ones."""
    tree = tg.init_params_numpy(TINY, 0)
    return tree, _word_batches(21), _word_batches(2, split="test")


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nested(state):
    return tg.params_to_numpy(state)


def _assert_trees_close(ours: dict, ref, atol, what):
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, ref))[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_o, flat_r):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokenizer", ["word", "byte"])
def test_packed_batches_equal_jax(tokenizer):
    docs = tds.text_corpus(n_docs=80, seed=1)
    assert docs == jds.text_corpus(n_docs=80, seed=1, source="synthetic")
    if tokenizer == "word":
        tok_t = tds.WordTokenizer(docs, vocab_size=300)
        tok_j = jds.WordTokenizer(docs, vocab_size=300)
        assert tok_t.encode(docs[0]) == tok_j.encode(docs[0])
    else:
        tok_t, tok_j = tds.ByteTokenizer(), jds.ByteTokenizer()
    seed = tds.shuffle_seed_for("hotkey_3")
    assert seed == jds.shuffle_seed_for("hotkey_3")
    kw = dict(batch_size=3, seq_len=48, repeat=True, shuffle=True,
              seed=seed, max_vocab=257)
    it_t = tds.batch_iterator(docs, tok_t, **kw)
    it_j = jds.batch_iterator(docs, tok_j, **kw)
    for _ in range(40):               # past the first epoch's end
        bt, bj = next(it_t), next(it_j)
        assert bt.keys() == bj.keys()
        for key in bj:
            assert bt[key].dtype == bj[key].dtype, key
            np.testing.assert_array_equal(bt[key], bj[key], err_msg=key)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_pack_documents_tail_handling_equals_jax(drop_remainder):
    rng = np.random.default_rng(4)
    docs = [list(rng.integers(1, 50, int(n))) for n in
            (1, 5, 16, 17, 3, 40, 2, 7)]
    ours = list(tpack.pack_documents(docs, 16,
                                     drop_remainder=drop_remainder))
    ref = list(jpack.pack_documents(docs, 16,
                                    drop_remainder=drop_remainder,
                                    native=False))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---------------------------------------------------------------------------
# Model and losses
# ---------------------------------------------------------------------------

def test_training_forward_matches_jax(world):
    """Packed segments and per-row position ids through the flash path
    (the port) vs the JAX forward (flash declines on the CPU and runs
    dense): logits, and the final hidden states of ``return_hidden``."""
    tree, batches, _ = world
    b = batches[0]
    jmodel, _ = jg.make_model(JTINY)
    net = tg.bind(TINY, tg.params_from_numpy(tree, device="cpu"))
    kw = {"segment_ids": b["segment_ids"], "position_ids": b["position_ids"]}
    fwd = jax.jit(lambda p, i, k, h: jmodel.apply({"params": p}, i,
                                                  return_hidden=h, **k),
                  static_argnums=3)
    for hidden in (False, True):
        ref = fwd(_jparams(tree), b["input_ids"], kw, hidden)
        ours = net(torch.from_numpy(b["input_ids"]), return_hidden=hidden,
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-5)


def test_bound_serving_model_records_no_graph(world):
    """Bound (serving) parameters never take gradients, so a forward
    keeps no autograd graph."""
    tree, batches, _ = world
    net = tg.bind(TINY, tg.params_from_numpy(tree, device="cpu"))
    assert not any(p.requires_grad for p in net.parameters())
    out = net(torch.from_numpy(batches[0]["input_ids"]))
    assert not out.requires_grad and out.grad_fn is None


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 33)).astype(np.float32) * 3
    ids = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        ref = jlosses.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                                     None if m is None else jnp.asarray(m))
        ours = tlosses.causal_lm_loss(torch.from_numpy(logits),
                                      torch.from_numpy(ids),
                                      None if m is None
                                      else torch.from_numpy(m))
        np.testing.assert_allclose([float(x) for x in ours],
                                   [float(x) for x in ref], rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.perplexity(torch.tensor(2.5))),
        float(jlosses.perplexity(jnp.float32(2.5))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _engines(tree):
    jmodel, _ = jg.make_model(JTINY)
    model, _ = tg.make_model(TINY)
    return (jtrain.TrainEngine(jmodel),
            ttrain.TrainEngine(model, device="cpu"), jmodel, model)


def test_one_step_loss_tokens_and_grads_match_jax(world):
    tree, batches, _ = world
    jeng, eng, jmodel, model = _engines(tree)
    batch = batches[0]
    jl, jt, jgrads = jax.jit(lambda p, b: jtrain.accumulated_grads(
        lambda pp, bb: jtrain._default_lm_loss(jmodel, pp, bb), p, b, 1))(
        _jparams(tree), batch)
    state = eng.init_state(tg.params_from_numpy(tree, device="cpu"))
    placed = eng.place_batch(batch)
    loss, tokens, grads = ttrain.accumulated_grads(
        lambda p, b: ttrain._default_lm_loss(model, p, b), state.params,
        placed, 1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(tokens) == float(jt)
    _assert_trees_close(_nested(grads), jgrads, 1e-5, "grad")
    # the engines' own steps report the same loss and count
    jstate = jeng.init_state(params=_jparams(tree))
    _, jm = jeng.train_step(jstate, batch)
    state, m = eng.train_step(state, placed)
    assert state.step == 1 and state.opt_state.count == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["tokens"]) == float(jm["tokens"])


def test_twenty_adamw_steps_track_optax_and_carry_state(world):
    """20 steps of the default optimizer (optax.adamw(5e-4,
    weight_decay=0.01) on the JAX side): the loss trajectories agree
    within 1e-4 per step and the parameters at the end within 1e-4. Then
    the JAX state at step 20 (params and optax's count/mu/nu) is carried
    into the port, and one more step on each side agrees to 1e-5."""
    tree, batches, _ = world
    jeng, eng, _, _ = _engines(tree)
    jstate = jeng.init_state(params=_jparams(tree))
    state = eng.init_state(tg.params_from_numpy(tree, device="cpu"))
    j_losses, losses = [], []
    for batch in batches[:20]:
        jstate, jm = jeng.train_step(jstate, batch)
        state, m = eng.train_step(state, eng.place_batch(batch))
        j_losses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0] - 0.5
    _assert_trees_close(_nested(state.params), jstate.params, 1e-4,
                        "param")

    adam = jstate.opt_state[0]
    carried = {"count": np.asarray(adam.count),
               "mu": jax.tree_util.tree_map(np.asarray, adam.mu),
               "nu": jax.tree_util.tree_map(np.asarray, adam.nu)}
    jtree = jax.tree_util.tree_map(np.asarray, jstate.params)
    state2 = eng.init_state(tg.params_from_numpy(jtree, device="cpu"))
    state2.opt_state = ttrain.opt_state_from_numpy(carried, device="cpu")
    assert state2.opt_state.count == 20
    back = ttrain.opt_state_to_numpy(state2.opt_state)
    assert back["count"] == carried["count"]
    for key in ("mu", "nu"):
        _assert_trees_close(back[key], carried[key], 0.0, key)
    jstate, jm = jeng.train_step(jstate, batches[20])
    state2, m = eng.train_step(state2, eng.place_batch(batches[20]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_trees_close(_nested(state2.params), jstate.params, 1e-5,
                        "carried param")


@pytest.mark.parametrize("clip", [1e-3, 1e3])
def test_grad_clip_matches_optax_chain(clip):
    """``grad_clip`` is optax.chain(clip_by_global_norm, adamw): both when
    the clip fires and when it does not, over three steps."""
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for k, v in params.items()} for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(5e-4, weight_decay=0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = ttrain.default_optimizer(grad_clip=clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update_({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7)


def test_accumulation_equals_the_full_batch(world):
    tree, batches, _ = world
    _, eng, _, model = _engines(tree)
    state = eng.init_state(tg.params_from_numpy(tree, device="cpu"))
    batch = eng.place_batch(batches[1])
    loss_fn = lambda p, b: ttrain._default_lm_loss(model, p, b)  # noqa
    l1, t1, g1 = ttrain.accumulated_grads(loss_fn, state.params, batch, 1)
    l2, t2, g2 = ttrain.accumulated_grads(loss_fn, state.params, batch, 2)
    assert float(t1) == float(t2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    acc_eng = ttrain.TrainEngine(model, accum_steps=2, device="cpu")
    acc_state, m = acc_eng.train_step(
        acc_eng.init_state(tg.params_from_numpy(tree, device="cpu")), batch)
    np.testing.assert_allclose(float(m["loss"]), float(l1), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        ttrain.accumulated_grads(loss_fn, state.params, batch, 3)


# ---------------------------------------------------------------------------
# Eval and delta
# ---------------------------------------------------------------------------

def test_evaluate_equals_jax(world):
    tree, _, held_out = world
    jeng, eng, _, _ = _engines(tree)
    ref = jeng.evaluate(_jparams(tree), held_out)
    before = dict(tfa.launches)
    ours = eng.evaluate(tg.params_from_numpy(tree, device="cpu"), held_out)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert tfa.launches == before            # the CPU runs no kernel
    assert np.isnan(eng.evaluate(tg.params_from_numpy(tree, device="cpu"),
                                 [])[0])


def test_delta_algebra_equals_jax(world):
    tree = world[0]
    rng = np.random.default_rng(12)
    trained = jax.tree_util.tree_map(
        lambda a: a + rng.standard_normal(a.shape).astype(a.dtype) * 1e-3,
        tree)
    t_tr = tg.params_from_numpy(trained, device="cpu")
    t_base = tg.params_from_numpy(tree, device="cpu")
    for wire in (None, "bfloat16"):
        ref = jdelta.compute_delta(_jparams(trained), _jparams(tree),
                                   wire_dtype=wire)
        ours = tdelta.compute_delta(t_tr, t_base, wire_dtype=wire)
        if wire:
            assert all(v.dtype == torch.bfloat16 for v in ours.values())
            ours = {k: v.float() for k, v in ours.items()}
            ref = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                         ref)
        _assert_trees_close(_nested(ours), ref, 0.0, f"delta {wire}")
        applied = tdelta.apply_delta(t_base, tdelta.compute_delta(
            t_tr, t_base, wire_dtype=wire))
        japplied = jdelta.apply_delta(_jparams(tree), jdelta.compute_delta(
            _jparams(trained), _jparams(tree), wire_dtype=wire))
        _assert_trees_close(_nested(applied), japplied, 0.0,
                            f"applied {wire}")
    assert bool(tdelta.tree_finite(t_tr)) is True
    assert bool(jdelta.tree_finite(_jparams(trained))) is True
    for bad in (np.nan, np.inf):
        poisoned = dict(t_tr)
        poisoned["h_1.c_fc.bias"] = poisoned["h_1.c_fc.bias"].clone()
        poisoned["h_1.c_fc.bias"][3] = bad
        jpois = tg.params_to_numpy(poisoned)
        assert bool(tdelta.tree_finite(poisoned)) is False
        assert bool(jdelta.tree_finite(_jparams(jpois))) is False
    with pytest.raises(ValueError, match="keys"):
        tdelta.tree_sub(t_tr, {k: v for k, v in t_base.items()
                               if k != "wte"})


# ---------------------------------------------------------------------------
# What the slice refuses
# ---------------------------------------------------------------------------

def test_unported_training_options_raise():
    model, _ = tg.make_model(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.TrainEngine(model)             # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.opt_state_from_numpy({"count": 0, "mu": {}, "nu": {}})
    with pytest.raises(NotImplementedError, match="parallel"):
        ttrain.TrainEngine(model, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="next slice"):
        ttrain.TrainEngine(model, fused_loss=True, device="cpu")
    for cfg in (dataclasses.replace(TINY, dropout=0.1),
                dataclasses.replace(TINY, remat=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.TrainEngine(tg.make_model(cfg)[0], device="cpu")
    with pytest.raises(NotImplementedError, match="mu_dtype"):
        ttrain.default_optimizer(mu_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="next slice"):
        tlosses.fused_linear_cross_entropy()
    with pytest.raises(NotImplementedError, match="wikitext"):
        tds.text_corpus(source="wikitext")
