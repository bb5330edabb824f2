"""The port's meta-learned merge (engine/average.py ParameterizedMerge,
delta.py weighted_merge / per_tensor_weighted_merge, the averager's
default ``--strategy parameterized``) against the JAX package, on the CPU.

- ``ParameterizedMerge.merge`` on 3 dense deltas that differ between
  miners in every tensor, 2 epochs on 2 batches, per-tensor and scalar
  logits, adam and sgd: the first meta-gradient against ``jax.grad`` of
  the JAX loss, the learned logits within 1e-5 and the merged tree
  within 1e-5 of the JAX strategy's. The smallest |g| of the first step
  is reported (Adam's first step moves a logit by about lr * sign(g), so
  a gradient at rounding level could flip it).
- An ``AveragerLoop`` round with the parameterized strategy against the
  JAX loop on a copy of one LocalFS root holding dense and packed
  submissions: the packed one reaches the strategy dense, and the
  published bases agree within 1e-5.
- The list merges against the JAX stacked ones, and the CLI's default
  strategy on the CPU.

f32 tiny GPT-2 on both sides; weights from numpy with a seed.
"""

import dataclasses
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import \
    ParameterizedMerge as JPM
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.ops.losses import causal_lm_loss as jloss
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import averager as tcli
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.utils import obs

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
        # two steps on the miner's own batches (decoupled weight decay
        # moves every coordinate), so the deltas differ in every tensor
        state = fast.init_state(tg.params_from_numpy(base, device="cpu"))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        for b in train[2 * i:2 * i + 2]:
            state, _ = fast.train_step(state, fast.place_batch(b))
        deltas.append(tg.params_to_numpy(
            tdl.compute_delta(state.params, snap)))
    return {"base": base, "val": val, "train": train, "deltas": deltas,
            "model": model, "jmodel": jmodel,
            "teng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree):
    return tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


_GRADS: dict = {}


def _first_grads(world, per_tensor):
    """The meta-gradient at w = 0 on the first batch, from both packages:
    the port's autograd through its mixture, and ``jax.grad`` of the JAX
    strategy's loss (model.apply + causal_lm_loss on the JAX merge).
    Memoized: it does not depend on the optimizer."""
    if per_tensor not in _GRADS:
        _GRADS[per_tensor] = _compute_first_grads(world, per_tensor)
    return _GRADS[per_tensor]


def _compute_first_grads(world, per_tensor):
    base = tg.params_from_numpy(world["base"], device="cpu")
    placed = [tdl.place_delta(d, base) for d in world["deltas"]]
    strat = tavg.ParameterizedMerge(world["model"], per_tensor=per_tensor)
    names = list(base) if per_tensor else ["w"]
    leaves = {k: torch.zeros(3, requires_grad=True) for k in names}
    batch = world["teng"].place_batch(world["val"][0])
    loss, _ = ttrain._default_lm_loss(
        world["model"],
        strat._mixture(leaves if per_tensor else leaves["w"], base, placed),
        batch)
    g = dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))

    jbase = _jtree(world["base"])
    stacked = jdl.stack_deltas([_jtree(d) for d in world["deltas"]])
    jb = {k: jnp.asarray(v) for k, v in world["val"][0].items()}

    def jl(w):
        if per_tensor:
            params = jdl.per_tensor_weighted_merge(
                jbase, stacked, jax.tree_util.tree_map(jax.nn.softmax, w))
        else:
            params = jdl.weighted_merge(jbase, stacked, jax.nn.softmax(w))
        logits = world["jmodel"].apply(
            {"params": params}, jb["input_ids"],
            attention_mask=jb.get("attention_mask"),
            segment_ids=jb.get("segment_ids"),
            position_ids=jb.get("position_ids"))
        return jloss(logits, jb["input_ids"], jb.get("loss_mask"))[0]

    w0 = (jax.tree_util.tree_map(lambda _: jnp.zeros(3), jbase)
          if per_tensor else jnp.zeros(3))
    jg_ = jax.grad(jl)(w0)
    jflat = _flat(jg_) if per_tensor else {"w": np.asarray(jg_)}
    return {k: v.numpy() for k, v in g.items()}, jflat


@pytest.mark.parametrize("per_tensor", [True, False],
                         ids=["per_tensor", "scalar"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_parameterized_merge_matches_jax(world, per_tensor, opt):
    ours_g, jax_g = _first_grads(world, per_tensor)
    scale = max(float(np.abs(v).max()) for v in jax_g.values())
    for k in jax_g:
        np.testing.assert_allclose(ours_g[k], jax_g[k], rtol=0,
                                   atol=1e-4 * scale)
    min_g = min(float(np.abs(v).min()) for v in ours_g.values())
    print(f"smallest |g| of the first meta-step ({opt}, "
          f"per_tensor={per_tensor}): {min_g:.3e} (max {scale:.3e})")
    assert min_g > 0   # no gradient vanishes by construction

    val = world["val"]
    base = tg.params_from_numpy(world["base"], device="cpu")
    ours = tavg.ParameterizedMerge(world["model"], meta_epochs=2,
                                   per_tensor=per_tensor,
                                   meta_optimizer=opt)
    merged, w = ours.merge(world["teng"], base, world["deltas"], IDS,
                           val_batches=lambda: iter(val))
    ref = JPM(world["jmodel"], meta_epochs=2, per_tensor=per_tensor,
              meta_optimizer=opt)
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
    assert any(float(np.abs(v).max()) > 1e-4 for v in ow.values())
    jm = _flat(jmerged)
    for k in jm:
        np.testing.assert_allclose(merged[k].numpy(), jm[k], rtol=0,
                                   atol=1e-5)
        assert not merged[k].requires_grad
    # no graph outlives the merge
    assert all(v.grad_fn is None and not v.requires_grad
               for v in (w.values() if per_tensor else [w]))
    assert len(ours.last_epoch_losses) == 2
    if not per_tensor:
        np.testing.assert_allclose(
            ours.lineage_weights(w).numpy(),
            np.asarray(ref.lineage_weights(jnp.asarray(jw["w"]))),
            rtol=0, atol=1e-7)
    else:
        assert ours.lineage_weights(w) is None


@pytest.mark.parametrize("per_tensor", [True, False],
                         ids=["per_tensor", "scalar"])
def test_list_merges_match_the_jax_stacked_merges(world, per_tensor):
    base = tg.params_from_numpy(world["base"], device="cpu")
    placed = [tdl.place_delta(d, base) for d in world["deltas"]]
    rng = np.random.default_rng(3)
    stacked = jdl.stack_deltas([_jtree(d) for d in world["deltas"]])
    if per_tensor:
        w = {k: rng.random(3).astype(np.float32) for k in base}
        got = tdl.per_tensor_weighted_merge(
            base, placed, {k: torch.from_numpy(v) for k, v in w.items()})
        want = _flat(jdl.per_tensor_weighted_merge(
            _jtree(world["base"]), stacked, _jtree(tdl.nest_tree(w))))
    else:
        w = rng.random(3).astype(np.float32)
        got = tdl.weighted_merge(base, placed, torch.from_numpy(w))
        want = _flat(jdl.weighted_merge(_jtree(world["base"]), stacked,
                                        jnp.asarray(w)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        tdl.weighted_merge(base, placed, torch.ones(2))


def test_averager_round_parameterized_matches_jax(world, tmp_path):
    """One AveragerLoop round with the parameterized strategy in both
    packages, on copies of one root with two dense submissions and one
    packed (int8 wire-v2): the published bases within 1e-5."""
    root = str(tmp_path / "artifacts")
    jt = JFS(root)
    rev = jt.publish_base(_jtree(world["base"]))
    for h, d in zip(IDS[:2], world["deltas"][:2]):
        jt.publish_delta(h, d)
        jt.publish_delta_meta(h, {"base_revision": rev})
    packed, _ = tdl.pack_delta_v2(
        tg.params_from_numpy(world["deltas"][2], device="cpu"),
        density=1.0 / 16.0, quant="int8")
    from distributedtraining_tpu_torch.engine.publish import DeltaPublisher
    pub = DeltaPublisher(LocalFSTransport(root), IDS[2],
                         report=ttrain.MinerReport(),
                         wire_spec={"format": 2, "density": 1.0 / 16.0,
                                    "quant": "int8"})
    assert pub.publish_now(packed, None, rev, f"{IDS[2]}-000001")
    pub.close()
    jroot = str(tmp_path / "jax_copy")
    shutil.copytree(root, jroot)
    chain_dir = str(tmp_path / "chain")
    val = world["val"]
    obs.configure()
    try:
        port = tavg.AveragerLoop(
            world["teng"], LocalFSTransport(root),
            LocalChain(chain_dir, my_hotkey="hotkey_95"),
            tavg.ParameterizedMerge(world["model"], meta_epochs=1),
            val_batches=lambda: iter(val), publish_policy="always")
        port.bootstrap()
        assert port.run_round()
        snap = obs.flush()
    finally:
        obs.reset()
        port.close()
    ref = JLoop(world["jeng"], JFS(jroot),
                JChain(chain_dir, my_hotkey="hotkey_95"),
                JPM(world["jmodel"], meta_epochs=1),
                val_batches=lambda: iter(val), publish_policy="always")
    ref.bootstrap()
    assert ref.run_round()
    ref.close()
    assert port.report.last_accepted == ref.report.last_accepted == 3
    # the packed submission reached the strategy dense
    assert snap["delta.densify_fallbacks"] == 1
    template = jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.float32), world["base"])
    ours = _flat(JFS(root).fetch_base(template)[0])
    theirs = _flat(JFS(jroot).fetch_base(template)[0])
    base = tdl.flatten_tree(world["base"])
    moved = max(float(np.abs(ours[k] - base[k]).max()) for k in base)
    assert moved > 1e-4
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-5)


def test_averager_cli_default_strategy_publishes(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    small = ["--batch-size", "2", "--eval-batches", "2",
             "--eval-seq-len", "32", "--work-dir", work]
    flags = ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--no-lineage", "--flight-events", "0"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(flags + small + ["--rounds", "1"]) == 1  # genesis
        t = LocalFSTransport(f"{work}/artifacts")
        rev0 = t.base_revision()
        assert tminer.main(
            ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--checkpoint-interval", "0", "--no-anomaly-trace",
             "--flight-events", "0", "--wire-v2", "--hotkey", "hotkey_3",
             "--max-steps", "3", "--seq-len", "32"] + small) == 0
        assert tcli.main(flags + small + [
            "--rounds", "1", "--publish-policy", "always", "--meta-epochs",
            "2", "--hotkey", "hotkey_95"]) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    assert t.base_revision() not in (None, rev0)


def test_parameterized_merge_rejects_a_bad_optimizer(world):
    with pytest.raises(ValueError, match="meta_optimizer"):
        tavg.ParameterizedMerge(world["model"], meta_optimizer="lion")
