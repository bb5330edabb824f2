"""The port's LoRA training roles (engine/lora_train.py, the LoRA staging
of engine/ingest.py, the ``lora_cfg`` planes of the validator and the
averager, the ``--lora-rank`` CLIs) against the JAX package, on the CPU.

- ``LoRAEngine``: three AdamW steps of both families, fused and unfused,
  from the same numpy adapters: losses within 1e-5 relative and adapters
  within 1e-5 of the largest value of each leaf, and ``accum_steps=2``
  equal to the full batch (JAX ``tests/test_lora_round.py:147``); the
  three-argument eval.
- ``LoRAMinerLoop``: a base pull resets the adapters and the optimizer
  (and the guard), the guard evaluates base + adapters and reverts, a
  checkpoint round-trips, and ``wire_v2`` is refused as JAX refuses it.
- A mixed round both ways on one LocalFS root: a port LoRA miner's bytes
  densified by JAX's ``densify_delta_bytes`` and the port's, a JAX LoRA
  miner's by both, each within 1e-6 of the other; then the port's and
  JAX's ``Validator`` and ``AveragerLoop`` with ``lora_cfg`` on the same
  submissions (a LoRA miner of each package and a dense one): the same
  reasons, scores within 4 ulps of the loss, merged bases within 1e-6;
  and both packages' sub-averagers with ``lora_cfg`` on that slice.
- A mesh: world-2 gloo LoRA engines (fsdp 2, tp 2 on the head-split and
  the gathered-attention routes, both families, one with remat) against
  world 1: losses within 1e-5, adapters and moments within 5e-5.
- The CLIs: ``--lora-rank 4`` on the miner, the validator and the
  averager of one work dir.

f32 tiny presets; weights, adapters and batches made with numpy from a
seed.
"""

import dataclasses
import json
import logging
import os
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import lora_train as jlt
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.scheduler import FakeClock as JClock
from distributedtraining_tpu.engine.validate import Validator as JValidator
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu.models import lora as jlora
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.checkpoint import CheckpointStore
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import ingest as tingest
from distributedtraining_tpu_torch.engine import lora_train as tlt
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine import validate as tval
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.engine.train import _wire_template
from distributedtraining_tpu_torch.models import lora as tlora
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from test_torch_lora import _flat, _jpairs, _numpy_adapters
from test_torch_parallel import _run_world

RANK, ALPHA = 4, 8.0
CFG = tlora.LoRAConfig(rank=RANK, alpha=ALPHA)
JCFG = jlora.LoRAConfig(rank=RANK, alpha=ALPHA)
FAMILIES = {"gpt2": ("tiny", jg), "llama": ("tiny-llama", jl)}
B, T = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, **overrides):
    preset, jfam = FAMILIES[family]
    kw = {"dtype": "float32", **overrides}
    return (dataclasses.replace(models.family(preset).PRESETS[preset], **kw),
            dataclasses.replace(jfam.PRESETS[preset], **kw), jfam)


def _batches(n, vocab, *, split="train", seed=3, bs=B):
    docs = tds.text_corpus(split=split, n_docs=96, seed=0)
    tok = tds.WordTokenizer(tds.text_corpus(n_docs=96, seed=0),
                            vocab_size=vocab)
    it = tds.batch_iterator(docs, tok, batch_size=bs, seq_len=T,
                            repeat=True, shuffle=split == "train", seed=seed)
    return [next(it) for _ in range(n)]


def _ref_adapters(jparams):
    return _flat(fser.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def _assert_adapters_close(ours, ref, rtol, what):
    assert set(ours) == set(ref), what
    for k, r in ref.items():
        o = ours[k].detach().cpu().numpy()
        scale = float(np.max(np.abs(r))) or 1.0
        np.testing.assert_allclose(o, r, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lora_engine_matches_jax(family, fused):
    """Three AdamW steps of the adapters on a frozen base: each loss
    within 1e-5 of JAX's ``LoRAEngine`` and the adapters after them
    within 1e-5 (relative to each leaf's largest value); the eval step
    agrees, and the base is untouched."""
    cfg, jcfg, jfam = _cfgs(family)
    tree = models.init_params_numpy(cfg, 0)
    np_ad = _numpy_adapters(tree, 5)
    batches = _batches(4, cfg.vocab_size)
    jeng = jlt.LoRAEngine(jfam.make_model(jcfg)[0], JCFG, fused_loss=fused)
    eng = tlt.LoRAEngine(models.make_model(cfg)[0], CFG, fused_loss=fused,
                         device="cpu")
    jbase = jax.tree_util.tree_map(jnp.asarray, tree)
    base = eng.place_base(models.params_from_numpy(tree, device="cpu"))
    before = {k: v.clone() for k, v in base.items()}
    js = jeng.init_state_from(_jpairs(np_ad))
    st = eng.init_state_from(tlora.adapters_from_numpy(np_ad, device="cpu"))
    for b in batches[:3]:
        js, jm = jeng.train_step(js, jbase, b)
        st, m = eng.train_step(st, base, eng.place_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["tokens"]) == float(jm["tokens"])
    assert st.step == 3 and st.opt_state.count == 3
    _assert_adapters_close(st.params, _ref_adapters(js.params), 1e-5,
                           "adapters")
    jl_, jc = jeng.eval_step(js.params, jbase, batches[3])
    l, c = eng.eval_step(st.params, base, eng.place_batch(batches[3]))
    np.testing.assert_allclose(float(l), float(jl_), rtol=1e-5)
    assert float(c) == float(jc)
    for k, v in base.items():
        assert torch.equal(v, before[k]) and not v.requires_grad, k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lora_accumulation_equals_the_full_batch(family):
    """``accum_steps=2`` takes the same step as the full batch (JAX
    ``tests/test_lora_round.py:147``), and the adapters' gradients only:
    the base's head takes none."""
    cfg, _, _ = _cfgs(family)
    tree = models.init_params_numpy(cfg, 0)
    np_ad = _numpy_adapters(tree, 6)
    batch = _batches(1, cfg.vocab_size)[0]
    model = models.make_model(cfg)[0]
    runs = []
    for accum in (1, 2):
        eng = tlt.LoRAEngine(model, CFG, accum_steps=accum, fused_loss=True,
                             device="cpu")
        base = eng.place_base(models.params_from_numpy(tree, device="cpu"))
        st = eng.init_state_from(tlora.adapters_from_numpy(np_ad,
                                                           device="cpu"))
        st, m = eng.train_step(st, base, eng.place_batch(batch))
        runs.append((float(m["loss"]), st.params))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   runs[1][1][k].detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The miner's loop
# ---------------------------------------------------------------------------

def _port_miner(transport, hotkey, *, lr=1e-2, family="gpt2", **kw):
    cfg, _, _ = _cfgs(family)
    eng = tlt.LoRAEngine(models.make_model(cfg)[0], CFG,
                         optimizer=ttrain.default_optimizer(lr),
                         device="cpu")
    return tlt.LoRAMinerLoop(eng, transport, hotkey, clock=FakeClock(),
                             send_interval=1e9, check_update_interval=1e9,
                             **kw)


def test_lora_miner_refuses_wire_v2_as_jax_does():
    cfg, jcfg, jfam = _cfgs("gpt2")
    with pytest.raises(ValueError) as ours:
        _port_miner(InMemoryTransport(), "m", wire_v2=True)
    with pytest.raises(ValueError) as theirs:
        jlt.LoRAMinerLoop(jlt.LoRAEngine(jfam.make_model(jcfg)[0], JCFG),
                          None, "m", wire_v2=True)
    assert str(ours.value) == str(theirs.value)


def test_lora_miner_pull_guard_and_checkpoint(tmp_path):
    """A new base resets the adapters (b = 0 again) and the optimizer,
    counts a pull and drops the guard's best; the guard scores base +
    adapters as the engine's eval does and reverts a candidate worse by
    more than the margin; a checkpoint restores the adapters, moments,
    step and base revision; the push is the adapter tree, its bytes
    JAX's encoding."""
    cfg, _, _ = _cfgs("gpt2")
    train = _batches(6, cfg.vocab_size, bs=2)
    val = _batches(1, cfg.vocab_size, split="test", bs=2)
    t = InMemoryTransport()
    store = CheckpointStore(str(tmp_path / "ckpt"))
    miner = _port_miner(t, "m1", val_batches=lambda: iter(val),
                        val_guard_interval=1e9, checkpoint_store=store,
                        checkpoint_interval=1e9)
    t.publish_base(models.init_params_numpy(cfg, 1))
    miner.bootstrap(seed=3)
    assert miner._base_revision == t.base_revision()
    zero = {k: v.clone() for k, v in miner.state.params.items()}
    assert not any(v.any() for k, v in zero.items() if k.endswith(".b"))
    miner.run(iter(train[:3]))
    assert miner.report.steps == 3 and miner.state.opt_state.count == 3
    # the guard: base + adapters, through the three-argument eval
    guard = miner._guard_eval()
    want = miner.engine.evaluate_adapters(miner.state.params,
                                          miner.base_params, val)[0]
    assert guard == want
    full = tlora.apply_lora(miner.base_params, miner.state.params, CFG)
    assert guard == pytest.approx(miner.engine.evaluate(full, val)[0],
                                  rel=1e-6)
    miner._val_guard()
    assert miner._best_val == guard
    best = {k: v.detach().clone() for k, v in miner.state.params.items()}
    miner.run(iter(train[3:5]))
    with torch.no_grad():       # a worse candidate (a random base's loss
        for k, v in miner.state.params.items():    # stays near log V)
            if k.endswith(".b"):
                v.add_(torch.randn_like(v) * 10)
    miner.val_guard_margin, miner.val_guard_patience = 0.01, 1
    miner._val_guard()
    assert miner.report.val_reverts == 1
    for k, v in best.items():
        assert torch.equal(miner.state.params[k].detach(), v), k
    # the checkpoint round trip
    miner._save_checkpoint()
    store.flush()
    again = _port_miner(t, "m1", checkpoint_store=store)
    again.bootstrap(seed=3)
    assert again.state.step == miner.state.step
    assert again.state.opt_state.count == miner.state.opt_state.count
    assert again._base_revision == miner._base_revision
    for k, v in miner.state.params.items():
        assert torch.equal(again.state.params[k].detach(), v.detach()), k
        assert again.state.params[k].requires_grad
        assert torch.equal(again.state.opt_state.nu[k],
                           miner.state.opt_state.nu[k]), k
    # the push: the adapter tree, as JAX encodes it
    miner.flush()
    data = t.fetch_delta_bytes("m1")
    np_ad = tlora.adapters_to_numpy(miner.state.params, miner.base_params)
    from distributedtraining_tpu import serialization as jser
    assert data == jser.to_msgpack(_jpairs(np_ad))
    # a pull: new adapters (b = 0), a fresh optimizer, the guard reset
    t.publish_base(models.init_params_numpy(cfg, 2))
    miner._check_pull()
    assert miner.report.base_pulls == 1 and miner._best_val is None
    assert miner.state.step == 0 and miner.state.opt_state.count == 0
    for k, v in miner.state.params.items():
        assert torch.equal(v.detach(), zero[k]), k
    miner.close()
    again.close()
    store.close()


# ---------------------------------------------------------------------------
# Mixed rounds on one root
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A LocalFS root with a JAX base, a port LoRA miner (hotkey_1), a
    JAX LoRA miner (hotkey_2), a dense JAX delta (hotkey_3) and a hostile
    adapter payload of the wrong rank (hotkey_4)."""
    cfg, jcfg, jfam = _cfgs("gpt2")
    root = str(tmp_path_factory.mktemp("lora") / "artifacts")
    base = models.init_params_numpy(cfg, 0)
    jt = JFS(root)
    rev = jt.publish_base(jax.tree_util.tree_map(jnp.asarray, base))
    train = _batches(6, cfg.vocab_size, bs=2)
    val = _batches(2, cfg.vocab_size, split="test", bs=2)
    port = _port_miner(LocalFSTransport(root), "hotkey_1")
    port.bootstrap()
    port.run(iter(train[:3]))
    port.flush()
    port.close()
    # JAX's LocalFS publish streams the tree (to_msgpack_file), which
    # cannot encode an adapter tree's None leaves (ROADMAP §3): the JAX
    # miner publishes to memory and its bytes are copied to the root
    jmem = JMem()
    jmem.publish_base(jax.tree_util.tree_map(jnp.asarray, base))
    jeng = jlt.LoRAEngine(jfam.make_model(jcfg)[0], JCFG,
                          optimizer=jtrain.default_optimizer(1e-2))
    jminer = jlt.LoRAMinerLoop(jeng, jmem, "hotkey_2", clock=JClock(),
                               send_interval=1e9, check_update_interval=1e9)
    jminer.bootstrap()
    jminer.run(iter(train[3:6]))
    jminer.flush()
    assert jminer.report.pushes == 1
    jt.publish_raw("hotkey_2", jmem.fetch_delta_bytes("hotkey_2"))
    jt.publish_delta_meta("hotkey_2", {"base_revision": rev})
    rng = np.random.default_rng(9)
    dense = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * 1e-3
                   ).astype(np.float32), base)
    jt.publish_delta("hotkey_3", dense)
    jt.publish_delta_meta("hotkey_3", {"base_revision": rev})
    wrong = jlora.init_lora(jax.random.PRNGKey(1), base,
                            jlora.LoRAConfig(rank=RANK * 2, alpha=ALPHA))
    from distributedtraining_tpu import serialization as jser
    jt.publish_raw("hotkey_4", jser.to_msgpack(wrong))
    return {"root": root, "base": base, "rev": rev, "val": val, "cfg": cfg,
            "jcfg": jcfg, "jfam": jfam, "dense": dense}


def test_mixed_round_densify_both_ways(fleet):
    """A port LoRA miner's pushed bytes and a JAX LoRA miner's, each
    densified by both packages' ``densify_delta_bytes``: the same dense
    delta within 1e-6, nonzero on the adapted kernels alone; the wrong
    rank reads as None on both sides; ``fetch_delta_any`` gives the same
    delta, and None without ``lora_cfg``."""
    root = fleet["root"]
    host = _wire_template(models.make_model(fleet["cfg"])[0])
    jhost = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   fleet["base"])
    targets = set(tlora.targets(fleet["base"], CFG))
    for h in ("hotkey_1", "hotkey_2"):
        data = LocalFSTransport(root).fetch_delta_bytes(h)
        ours = tdl.flatten_tree(tingest.densify_delta_bytes(
            data, host, CFG))
        theirs = tdl.flatten_tree(jax.tree_util.tree_map(
            np.asarray, jlt.densify_delta_bytes(data, jhost, JCFG)))
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{h} {k}")
            assert bool(np.any(v)) == (k in targets), (h, k)
        # without lora_cfg neither package reads adapters
        assert tingest.densify_delta_bytes(data, host) is None
        assert jlt.densify_delta_bytes(data, jhost) is None
        # fetch_delta_any: the transport's bytes through the same densify
        t = LocalFSTransport(root)
        any_ = tlt.fetch_delta_any(t, h, host, CFG)
        for k, v in tdl.flatten_tree(any_).items():
            np.testing.assert_array_equal(v, ours[k])
        assert tlt.fetch_delta_any(t, h, host) is None
    bad = LocalFSTransport(root).fetch_delta_bytes("hotkey_4")
    assert tingest.densify_delta_bytes(bad, host, CFG) is None
    assert jlt.densify_delta_bytes(bad, jhost, JCFG) is None


def test_lora_validator_round_matches_jax(fleet, tmp_path):
    """The port's ``Validator(lora_cfg=...)`` and JAX's score the same
    fleet: the same reasons, losses within 1e-5 relative, scores within
    4 ulps of the larger loss; both LoRA miners score > 0."""
    out = {}
    for side in ("port", "jax"):
        chain_dir = str(tmp_path / side)
        if side == "port":
            v = tval.Validator(
                ttrain.TrainEngine(models.make_model(fleet["cfg"])[0],
                                   device="cpu"),
                LocalFSTransport(fleet["root"]),
                LocalChain(chain_dir, my_hotkey="hotkey_91"),
                eval_batches=lambda: iter(fleet["val"]), lora_cfg=CFG)
        else:
            v = JValidator(
                jtrain.TrainEngine(fleet["jfam"].make_model(
                    fleet["jcfg"])[0]),
                JFS(fleet["root"]), JChain(chain_dir, my_hotkey="hotkey_91"),
                eval_batches=lambda: iter(fleet["val"]), lora_cfg=JCFG)
        v.bootstrap()
        out[side] = (v.base_loss, {s.hotkey: s
                                   for s in v.validate_and_score()})
        v.close()
    (pb, ours), (jb, theirs) = out["port"], out["jax"]
    assert pb == pytest.approx(jb, rel=1e-5)
    assert set(ours) == set(theirs)
    for h, s in theirs.items():
        assert ours[h].reason == s.reason, h
        if s.loss is None:
            assert ours[h].loss is None
            continue
        assert ours[h].loss == pytest.approx(s.loss, rel=1e-5), h
        ulp = float(np.spacing(np.float32(max(s.loss, jb))))
        assert abs(ours[h].score - s.score) <= max(1e-6, 4 * ulp), h
    assert ours["hotkey_1"].score > 0 and ours["hotkey_2"].score > 0
    assert ours["hotkey_4"].reason == "no_delta"


def test_lora_averager_round_matches_jax(fleet, tmp_path):
    """The port's ``AveragerLoop(lora_cfg=...)`` and JAX's merge the same
    fleet (two LoRA miners and a dense one) on copies of the root: the
    same cohort and published bases within 1e-6 of each other."""
    roots = {}
    for side in ("port", "jax"):
        roots[side] = str(tmp_path / side / "artifacts")
        shutil.copytree(fleet["root"], roots[side])
    chain_dir = str(tmp_path / "chain")
    JChain(chain_dir, my_hotkey="hotkey_91").set_weights(
        {"hotkey_1": 0.5, "hotkey_2": 0.3, "hotkey_3": 0.2})
    port = tavg.AveragerLoop(
        ttrain.TrainEngine(models.make_model(fleet["cfg"])[0],
                           device="cpu"),
        LocalFSTransport(roots["port"]),
        LocalChain(chain_dir, my_hotkey="hotkey_95"), tavg.WeightedAverage(),
        val_batches=lambda: iter(fleet["val"]), publish_policy="always",
        lora_cfg=CFG)
    ref = JLoop(jtrain.TrainEngine(fleet["jfam"].make_model(
                    fleet["jcfg"])[0]),
                JFS(roots["jax"]), JChain(chain_dir, my_hotkey="hotkey_95"),
                JWA(), val_batches=lambda: iter(fleet["val"]),
                publish_policy="always", lora_cfg=JCFG)
    for loop in (port, ref):
        loop.bootstrap()
        assert loop.run_round()
    assert port.report.last_accepted == ref.report.last_accepted == 3
    tmpl = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                  fleet["base"])
    ours, theirs = (tdl.flatten_tree(jax.tree_util.tree_map(
        np.asarray, JFS(roots[s]).fetch_base(tmpl)[0]))
        for s in ("port", "jax"))
    moved = 0
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
        moved += int(not np.array_equal(v, tdl.flatten_tree(
            fleet["base"])[k]))
    assert moved > 0
    port.close()
    ref.close()


def test_lora_sub_averager_matches_jax(fleet, tmp_path):
    """``SubAverager(lora_cfg=...)`` of both packages folds the same slice
    (two LoRA miners and a dense one) on copies of the root: the
    published partial aggregates within 1e-6 of each other."""
    from distributedtraining_tpu.engine import hier_average as jhier
    from distributedtraining_tpu_torch.engine import hier_average as thier
    from distributedtraining_tpu_torch.transport import base as tbase
    assigned = ["hotkey_1", "hotkey_2", "hotkey_3"]
    weights = {"hotkey_1": 0.5, "hotkey_2": 0.3, "hotkey_3": 0.2}
    jhost = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   fleet["base"])
    roots, out = {}, {}
    for side in ("port", "jax"):
        roots[side] = str(tmp_path / side / "artifacts")
        shutil.copytree(fleet["root"], roots[side])
    port = thier.SubAverager(
        LocalFSTransport(roots["port"]), "n0",
        _wire_template(models.make_model(fleet["cfg"])[0]), assigned,
        consensus=weights, device="cpu", lora_cfg=CFG)
    ref = jhier.SubAverager(JFS(roots["jax"]), "n0", jhost, assigned,
                            consensus=weights, lora_cfg=JCFG)
    for side, sub in (("port", port), ("jax", ref)):
        assert sub.run_round()
        data = LocalFSTransport(roots[side]).fetch_delta_bytes(
            tbase.agg_id("n0"))
        out[side] = tdl.flatten_tree(tingest.densify_delta_bytes(
            data, jhost))
    assert port.report.last_accepted == 3
    for k, v in out["jax"].items():
        np.testing.assert_allclose(out["port"][k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    port.close()


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

MESH_STEPS, MB, MESH_LR = 3, 4, 1e-4
# name -> (family, mesh, fused, overrides): dp 2; fsdp 2; sp 2 on the
# gathered route (GPT-2) and on the ring (a Llama); tp 2 splitting heads
# (GPT-2's fused c_attn, a Llama's GQA wq/wk/wv/wo, with remat); tp 2 on
# GPT-2 with one head (the gathered-attention route)
MESH_ENGINES = {
    "gpt2-dp2-fused": ("gpt2", {"dp": 2}, True, {}),
    "gpt2-sp2-gathered-unfused": ("gpt2", {"sp": 2}, False, {}),
    "llama-sp2-ring-fused": ("llama", {"sp": 2}, True,
                             {"attention_impl": "ring"}),
    "gpt2-fsdp2-fused": ("gpt2", {"fsdp": 2}, True, {}),
    "gpt2-tp2-unfused": ("gpt2", {"tp": 2}, False, {}),
    "gpt2-tp2-gathered-fused": ("gpt2", {"tp": 2}, True, {"n_head": 1}),
    "llama-fsdp2-unfused": ("llama", {"fsdp": 2}, False, {}),
    "llama-tp2-fused-remat": ("llama", {"tp": 2}, True, {"remat": True}),
}


def test_lora_engine_on_a_world_of_two_matches_world_one(tmp_path):
    """World-2 gloo LoRA engines (one process a rank, the base sharded,
    the adapters replicated) against the port's world-1 engine on the
    same global batches, three AdamW steps with a binding clip: losses
    within 1e-5 relative, and adapters and Adam's first moment within
    5e-5 of each leaf's largest value, on every rank (splitting the rows
    alone, ``accum_steps=2`` on one process, moves a tiny-llama moment
    by 1.6e-5 of its leaf's largest value: f32 summation order); the tp
    2 routes are the ones named, and the ring passes blocks on the sp 2
    ring engine alone. ``fetch_delta_any_broadcast`` gives
    every rank the coordinator's artifact densified."""
    inputs, args = {}, {"rank": RANK, "alpha": ALPHA, "lr": MESH_LR,
                        "grad_clip": 0.05, "engines": {}}
    refs = {}
    for name, (family, mesh, fused, over) in MESH_ENGINES.items():
        preset = FAMILIES[family][0]
        cfg, _, _ = _cfgs(family, **over)
        tree = models.init_params_numpy(cfg, 0)
        np_ad = _numpy_adapters(tree, 11)
        ids = np.stack([b["input_ids"] for b in _batches(
            MESH_STEPS, cfg.vocab_size, bs=MB)])
        inputs.update({f"{name}/p/{k}": v
                       for k, v in tdl.flatten_tree(tree).items()})
        ad = tlora.adapters_from_numpy(np_ad, device="cpu")
        inputs.update({f"{name}/a/{k}": v.numpy() for k, v in ad.items()})
        inputs[f"{name}/ids"] = ids
        args["engines"][name] = {
            "preset": preset, "overrides": {"dtype": "float32", **over},
            "mesh": {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, **mesh},
            "fused": fused}
        eng = tlt.LoRAEngine(models.make_model(cfg)[0], CFG,
                             optimizer=ttrain.default_optimizer(
                                 MESH_LR, grad_clip=0.05),
                             fused_loss=fused, device="cpu")
        base = eng.place_base(models.params_from_numpy(tree, device="cpu"))
        st = eng.init_state_from(ad)
        losses = []
        for step_ids in ids:
            st, m = eng.train_step(st, base, eng.place_batch(
                {"input_ids": step_ids}))
            losses.append(float(m["loss"]))
        refs[name] = (np.array(losses), st.params, st.opt_state.mu)
    # the pod's fetch (fetch_delta_any_broadcast): a LoRA artifact the
    # coordinator alone can read, densified on every rank
    cfg, _, _ = _cfgs("gpt2")
    tree = models.init_params_numpy(cfg, 0)
    np_ad = _numpy_adapters(tree, 12)
    from distributedtraining_tpu_torch import serialization as tser
    inputs["bcast/bytes"] = np.frombuffer(tser.to_msgpack(np_ad), np.uint8)
    flat = tdl.flatten_tree(tree)
    inputs["bcast/template"] = np.array(json.dumps(
        {k: list(np.shape(v)) for k, v in flat.items()}))
    want = tdl.flatten_tree(tlora.densify_adapters(tree, np_ad, CFG))
    outs = _run_world(tmp_path, "lora", {"dp": 2}, inputs, args)
    for r, out in enumerate(outs):
        for k, v in want.items():
            np.testing.assert_array_equal(out[f"bcast/{k}"], v,
                                          err_msg=f"{k} {r}")
    for r, out in enumerate(outs):
        for name, (losses, params, mu) in refs.items():
            np.testing.assert_allclose(out[f"{name}/losses"], losses,
                                       rtol=1e-5, err_msg=f"{name} {r}")
            for tag, tree in (("ad", params), ("mu", mu)):
                for k, v in tree.items():
                    ref = v.detach().numpy()
                    scale = float(np.max(np.abs(ref)))
                    np.testing.assert_allclose(
                        out[f"{name}/{tag}/{k}"], ref, rtol=0,
                        atol=5e-5 * scale, err_msg=f"{name} {tag} {k} {r}")
            route = out[f"{name}/route"]
            want = ("gathered_attn" if "tp2-gathered" in name
                    else "head_split" if "tp2" in name else "none")
            assert str(route) == want, name
            # the ring passes blocks on the ring route alone; the other
            # sp engine takes the gathered route
            passes = int(out[f"{name}/ring_passes"])
            assert (passes > 0) == ("ring" in name), (name, passes)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_lora_cli_round_on_cpu(tmp_path, monkeypatch):
    """``--lora-rank 4`` on the miner (fused and not), the validator and
    the averager of one work dir: the miners publish adapter trees, the
    validator scores them above 0, and the averager merges them into a
    new base."""
    from distributedtraining_tpu_torch.neurons import averager as tacli
    from distributedtraining_tpu_torch.neurons import miner as tminer
    from distributedtraining_tpu_torch.neurons import validator as tvcli
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    common = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
              "--flight-events", "0", "--work-dir", work, "--batch-size",
              "2", "--seq-len", "32", "--lora-rank", "4"]
    evals = ["--eval-batches", "2", "--eval-seq-len", "32"]
    averager = common + evals + ["--hotkey", "hotkey_95", "--rounds", "1",
                                 "--publish-policy", "always"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        # genesis: no miner yet, so no merge (exit 1), but a base
        assert tacli.main(averager) == 1
        t = LocalFSTransport(os.path.join(work, "artifacts"))
        rev0 = t.base_revision()
        for hk, extra in (("hotkey_1", ["--fused-loss"]), ("hotkey_2", [])):
            assert tminer.main(common + [
                "--hotkey", hk, "--max-steps", "3", "--learning-rate",
                "1e-2", "--checkpoint-interval", "0", "--no-anomaly-trace",
                *extra]) == 0
        assert tvcli.main(common + evals + ["--hotkey", "hotkey_91",
                                            "--rounds", "1"]) == 0
        assert tacli.main(averager) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    host = _wire_template(models.make_model("tiny")[0])
    adapters = tlt.adapter_template(host, CFG)
    from distributedtraining_tpu_torch import serialization as tser
    for hk in ("hotkey_1", "hotkey_2"):
        tree = tser.validated_load(t.fetch_delta_bytes(hk), adapters)
        assert tree["wte"] is None and tree["h_0"]["c_fc"]["kernel"] is None
    weights = JChain(os.path.join(work, "chain")).get_weights("hotkey_91")
    assert weights.get("hotkey_1", 0) > 0 and weights.get("hotkey_2", 0) > 0
    assert t.base_revision() not in (None, rev0)
