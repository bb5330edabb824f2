"""The port's scan block layout (``--scan-blocks``: models/gpt2.py and
models/llama.py ``BlockScan``, ``stack_blocks`` / ``unstack_blocks``,
engine/train.py ``wire_out`` / ``wire_in``) against the JAX package's
and against the port's own unrolled layout, on the CPU.

The stacked layout stores each block leaf once as ``[L, ...]`` and runs
block ``i`` on the slices ``[i]``: the same products on the same
values, so on the CPU its logits, losses and parameters are bit-equal
to the unrolled run's (no gradient clip: the clip's sum of squares
would add the leaves in another order). Artifacts travel unrolled, so
scan and unrolled roles (of either package) share one fleet.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu.models import lora as jlora
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.models import llama as tl
from distributedtraining_tpu_torch.models import lora as tlora
from test_torch_parallel import _flat, _run_world
from test_torch_sp import _nest

jtu = jax.tree_util
FAMILIES = {"gpt2": (tg, jg, "tiny"), "llama": (tl, jl, "tiny-llama")}


def _cfgs(family, **kw):
    tmod, jmod, preset = FAMILIES[family]
    return (dataclasses.replace(tmod.PRESETS[preset], dtype="float32", **kw),
            dataclasses.replace(jmod.PRESETS[preset], dtype="float32", **kw))


def _jax_tree(family):
    _, jmod, _ = FAMILIES[family]
    _, jcfg = _cfgs(family)
    jmodel, _ = jmod.make_model(jcfg)
    return jtu.tree_map(np.asarray, jax.jit(jmodel.init_params)(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stack_unstack_equal_jax_and_keep_numpy(family):
    tmod, jmod, _ = FAMILIES[family]
    tcfg, _ = _cfgs(family)
    tree = _jax_tree(family)
    want = jmod.stack_blocks(tree, tcfg.n_layer)
    got = tmod.stack_blocks(tree, tcfg.n_layer)
    fw, fg = jtu.tree_flatten_with_path(want)[0], \
        jtu.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (p, a), (_, b) in zip(fw, fg):
        assert isinstance(b, np.ndarray), p
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
    back = tmod.unstack_blocks(got, tcfg.n_layer)
    jback = jmod.unstack_blocks(want, tcfg.n_layer)
    for (p, a), (_, b) in zip(jtu.tree_flatten_with_path(jback)[0],
                              jtu.tree_flatten_with_path(back)[0]):
        assert isinstance(b, np.ndarray) and np.array_equal(a, b), p
    # the state-dict spelling: the scan model's own names, in its order
    smodel, _ = models.make_model(dataclasses.replace(tcfg,
                                                      scan_blocks=True))
    flat = tmod.stack_blocks(_flat(tree), tcfg.n_layer)
    assert set(flat) == set(smodel.state_dict())
    assert all(isinstance(v, np.ndarray) for v in flat.values())
    for k, v in _flat(got).items():
        assert np.array_equal(flat[k], v), k
    assert set(tmod.unstack_blocks(flat, tcfg.n_layer)) == set(_flat(tree))
    # the init draw stacks the unrolled draw's values
    sinit = tmod.init_params_numpy(dataclasses.replace(tcfg,
                                                       scan_blocks=True), 4)
    uinit = tmod.stack_blocks(tmod.init_params_numpy(tcfg, 4), tcfg.n_layer)
    for k, v in _flat(uinit).items():
        assert np.array_equal(_flat(sinit)[k], v), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_scan_logits_match_jax_and_unrolled(family):
    tmod, jmod, _ = FAMILIES[family]
    tcfg, jcfg = _cfgs(family)
    tree = _jax_tree(family)
    ids = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16))
    jscan, _ = jmod.make_model(dataclasses.replace(jcfg, scan_blocks=True))
    want = np.asarray(jscan.apply(
        {"params": jmod.stack_blocks(tree, tcfg.n_layer)},
        jnp.asarray(ids, jnp.int32)))
    unrolled, _ = models.make_model(tcfg)
    scan, _ = models.make_model(dataclasses.replace(tcfg, scan_blocks=True))
    t_ids = torch.from_numpy(ids)
    u = torch.func.functional_call(
        unrolled, models.params_from_numpy(tree, device="cpu"), (t_ids,))
    s = torch.func.functional_call(scan, models.params_from_numpy(
        tmod.stack_blocks(tree, tcfg.n_layer), device="cpu"), (t_ids,))
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, u)
    with pytest.raises(ValueError, match="unrolled block layout"):
        torch.func.functional_call(scan, models.params_from_numpy(
            tmod.stack_blocks(tree, tcfg.n_layer), device="cpu"), (t_ids,),
            {"sow_kv": True})


def _batches(vocab, n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (4, 32)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("family,remat", [("gpt2", False), ("gpt2", True),
                                          ("llama", False)])
def test_scan_train_steps_equal_unrolled(family, remat, fused):
    """Three AdamW steps: losses, and params, mu and nu unstacked, equal
    the unrolled run's bit for bit."""
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    tmod, _, _ = FAMILIES[family]
    tcfg, _ = _cfgs(family, remat=remat)
    tree = tmod.init_params_numpy(tcfg, 0)
    runs = {}
    for scan in (False, True):
        cfg = dataclasses.replace(tcfg, scan_blocks=scan)
        model, _ = models.make_model(cfg)
        eng = TrainEngine(model, fused_loss=fused, device="cpu")
        state = eng.init_state(models.params_from_numpy(
            tmod.stack_blocks(tree, cfg.n_layer) if scan else tree,
            device="cpu"))
        losses = []
        for b in _batches(cfg.vocab_size, 3):
            state, m = eng.train_step(state, eng.place_batch(b))
            losses.append(float(m["loss"]))
        out = {"losses": losses}
        for name, t in (("p", state.params), ("mu", state.opt_state.mu),
                        ("nu", state.opt_state.nu)):
            t = {k: v.detach() for k, v in t.items()}
            out[name] = models.unstack_blocks(cfg, t) if scan else t
        runs[scan] = out
    assert runs[True]["losses"] == runs[False]["losses"]
    for name in ("p", "mu", "nu"):
        a, b = runs[False][name], runs[True][name]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_scan_specs_match_jax_logical_specs(devices, family):
    """Each stacked leaf's spec is JAX's scan model's logical spec under
    ``DEFAULT_RULES``: the layer axis replicated, the rest as unrolled."""
    import flax.linen as nn

    from distributedtraining_tpu.parallel import sharding as jsh
    from distributedtraining_tpu_torch.parallel import sharding as tsh
    tmod, jmod, _ = FAMILIES[family]
    tcfg, jcfg = _cfgs(family, scan_blocks=True)
    jmodel, _ = jmod.make_model(jcfg)
    logical = _flat(jsh.logical_param_specs(jmodel, seq_len=8))
    want = {k: tuple(nn.logical_to_mesh_axes(v, jsh.DEFAULT_RULES))
            for k, v in logical.items()}
    model, _ = models.make_model(tcfg)
    ours = tsh.param_specs(model.state_dict())
    assert set(ours) == set(want)
    for k, spec in want.items():
        assert ours[k] == spec + (None,) * (len(ours[k]) - len(spec)), k
    key = "h.block.c_attn.kernel" if family == "gpt2" \
        else "layers.block.wq.kernel"
    assert ours[key] == (None, "fsdp", "tp")


# ---------------------------------------------------------------------------
# A fleet of both layouts
# ---------------------------------------------------------------------------

def _docs_batches(vocab):
    from distributedtraining_tpu_torch.data.datasets import (
        ByteTokenizer, batch_iterator, text_corpus)
    docs = text_corpus(split="train", n_docs=32, source="synthetic")

    def batches(n=6):
        it = batch_iterator(docs, ByteTokenizer(), batch_size=4, seq_len=32,
                            repeat=True, max_vocab=vocab)
        return [next(it) for _ in range(n)]
    return batches


def _engines(cfg, lora_cfg=None):
    from distributedtraining_tpu_torch.engine.lora_train import LoRAEngine
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    out = {}
    for scan in (False, True):
        model, _ = models.make_model(dataclasses.replace(cfg,
                                                         scan_blocks=scan))
        out[scan] = (LoRAEngine(model, lora_cfg, device="cpu")
                     if lora_cfg else TrainEngine(model, device="cpu"))
    return out


def test_mixed_fleet_wire_layout(tmp_path):
    """JAX ``test_mixed_fleet_wire_layout`` spelled for the port: a scan
    miner's delta scores on an unrolled validator, an unrolled miner's
    merges on a scan averager, and both miners pull the merged base into
    their own layouts."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import (MinerLoop,
                                                            _wire_template)
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
    eng = _engines(cfg)
    batches = _docs_batches(cfg.vocab_size)
    transport = InMemoryTransport()
    transport.publish_base(tg.init_params_numpy(cfg, 0))
    miners = {}
    for hk, scan in (("hotkey_0", True), ("hotkey_1", False)):
        m = MinerLoop(eng[scan], transport, hk, send_interval=1e9,
                      check_update_interval=1e9)
        m.bootstrap()
        m.run(iter(batches(10)), max_steps=10)
        m.flush()
        miners[scan] = m
    assert "h.block.c_attn.kernel" in miners[True].state.params
    # the wire really is unrolled: a raw fetch on an unrolled template
    template = _wire_template(eng[False].model)
    assert _wire_template(eng[True].model).keys() == template.keys()
    wire = transport.fetch_delta("hotkey_0", template)
    assert wire is not None and "h_0" in wire
    chain = LocalChain(str(tmp_path), my_hotkey="hotkey_95",
                       epoch_length=0)
    v = Validator(eng[False], transport, chain,
                  eval_batches=lambda: iter(batches(2)))
    v.bootstrap()
    scores = {s.hotkey: s.score for s in v.validate_and_score()}
    assert scores.get("hotkey_0", 0) > 0 and scores.get("hotkey_1", 0) > 0
    # the scan validator scores the same
    vs = Validator(eng[True], transport, chain,
                   eval_batches=lambda: iter(batches(2)))
    vs.bootstrap()
    assert "h.block.c_attn.kernel" in vs.base_params
    scan_scores = {s.hotkey: s.score for s in vs.validate_and_score()}
    for hk in scores:
        assert scan_scores[hk] == pytest.approx(scores[hk], rel=1e-5,
                                                abs=1e-7)
    # a scan averager merges both and publishes unrolled; both pull back
    avg = AveragerLoop(eng[True], transport, chain, WeightedAverage(),
                       val_batches=lambda: iter(batches(2)))
    avg.bootstrap()
    assert avg.run_round() and avg.report.last_accepted == 2
    merged, rev = transport.fetch_base(template)
    assert "h_0" in merged
    for m in miners.values():
        m._check_pull()
        assert m._base_revision == rev == transport.base_revision()
    got = models.unstack_blocks(cfg, {k: v.detach() for k, v in
                                      miners[True].state.params.items()})
    for k, v in miners[False].state.params.items():
        assert torch.equal(got[k], v.detach()), k


def test_scan_averager_merges_what_an_unrolled_one_does(tmp_path):
    """One round's published bytes are equal from a scan averager and an
    unrolled one (weighted, over dense and packed submissions)."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.train import MinerLoop
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
    eng = _engines(cfg)
    batches = _docs_batches(cfg.vocab_size)
    published = {}
    for scan in (False, True):
        transport = InMemoryTransport()
        transport.publish_base(tg.init_params_numpy(cfg, 0))
        for hk, v2 in (("hotkey_0", False), ("hotkey_1", True)):
            m = MinerLoop(eng[False], transport, hk, send_interval=1e9,
                          check_update_interval=1e9, wire_v2=v2)
            m.bootstrap()
            m.run(iter(batches(4)), max_steps=4)
            m.flush()
        chain = LocalChain(str(tmp_path / f"c{scan}"), my_hotkey="hotkey_95",
                           epoch_length=0)
        avg = AveragerLoop(eng[scan], transport, chain, WeightedAverage(),
                           val_batches=lambda: iter(batches(2)),
                           publish_policy="always")
        avg.bootstrap()
        assert avg.run_round() and avg.report.last_accepted == 2
        published[scan] = transport.fetch_base_bytes()
    assert published[True] == published[False]


def test_mixed_fleet_lora_wire_layout(tmp_path):
    """JAX ``test_mixed_fleet_lora_wire_layout`` (and its reverse,
    ``test_scan_consumer_accepts_unrolled_lora``) spelled for the port: a
    scan LoRA miner's stacked factors travel per block and score and
    merge on unrolled roles; an unrolled LoRA miner's on scan roles."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import (AveragerLoop,
                                                              WeightedAverage)
    from distributedtraining_tpu_torch.engine.lora_train import LoRAMinerLoop
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.engine.validate import Validator
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
    lcfg = tlora.LoRAConfig(rank=2)
    full = _engines(cfg)
    leng = _engines(cfg, lcfg)
    batches = _docs_batches(cfg.vocab_size)
    wires = {}
    for miner_scan in (True, False):
        transport = InMemoryTransport()
        transport.publish_base(tg.init_params_numpy(cfg, 0))
        m = LoRAMinerLoop(leng[miner_scan], transport, "hotkey_0",
                          send_interval=1e9, check_update_interval=1e9)
        m.bootstrap()
        if miner_scan:
            a = m.state.params["h.block.c_attn.kernel.a"]
            assert a.shape == (cfg.n_layer, cfg.n_embd, 2)
        m.run(iter(batches(12)), max_steps=12)
        m.flush()
        template = tlora.adapter_template(_wire_template(full[False].model),
                                          lcfg)
        wire = transport.fetch_delta("hotkey_0", template)
        assert wire is not None and "h_0" in wire
        wires[miner_scan] = wire
        chain = LocalChain(str(tmp_path / f"c{miner_scan}"),
                           my_hotkey="hotkey_95", epoch_length=0)
        consumer = full[not miner_scan]
        v = Validator(consumer, transport, chain,
                      eval_batches=lambda: iter(batches(2)), lora_cfg=lcfg)
        v.bootstrap()
        scores = {s.hotkey: s.score for s in v.validate_and_score()}
        assert scores.get("hotkey_0", 0) > 0, scores
        avg = AveragerLoop(consumer, transport, chain, WeightedAverage(),
                           val_batches=lambda: iter(batches(2)),
                           lora_cfg=lcfg)
        avg.bootstrap()
        assert avg.run_round() and avg.report.last_accepted == 1
    # both travel as the per-block form (their values differ: as in JAX,
    # init_lora takes one key a leaf, and the layouts have other leaves)
    fa = jtu.tree_flatten_with_path(wires[True])[0]
    fb = jtu.tree_flatten_with_path(wires[False])[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert all(np.shape(x) == np.shape(y) for (_, x), (_, y) in zip(fa, fb))


def test_port_scan_miner_scored_by_jax_unrolled_validator(tmp_path):
    """Across packages: a port ``--scan-blocks`` miner's delta, on one
    LocalFS root, scored above 0 by JAX's unrolled validator."""
    from distributedtraining_tpu.chain import LocalChain as JChain
    from distributedtraining_tpu.data import ByteTokenizer as JByte
    from distributedtraining_tpu.data import batch_iterator as jbatches
    from distributedtraining_tpu.data import text_corpus as jcorpus
    from distributedtraining_tpu.engine import TrainEngine as JEngine
    from distributedtraining_tpu.engine import Validator as JValidator
    from distributedtraining_tpu.transport import LocalFSTransport as JFS
    from distributedtraining_tpu_torch.engine.train import MinerLoop
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    cfg, jcfg = _cfgs("gpt2")
    root = str(tmp_path / "artifacts")
    t = LocalFSTransport(root)
    t.publish_base(tg.init_params_numpy(cfg, 0))
    eng = _engines(cfg)[True]
    m = MinerLoop(eng, t, "hotkey_0", send_interval=1e9,
                  check_update_interval=1e9)
    m.bootstrap()
    m.run(iter(_docs_batches(cfg.vocab_size)(10)), max_steps=10)
    m.flush()
    docs = jcorpus(split="train", n_docs=32, source="synthetic")

    def jb(n=2):
        it = jbatches(docs, JByte(), batch_size=4, seq_len=32, repeat=True,
                      max_vocab=cfg.vocab_size)
        return [next(it) for _ in range(n)]

    jmodel, _ = jg.make_model(jcfg)
    v = JValidator(JEngine(jmodel, seq_len=32), JFS(root),
                   JChain(str(tmp_path / "chain"), my_hotkey="hotkey_95",
                          epoch_length=0),
                   eval_batches=lambda: iter(jb()))
    v.bootstrap()
    scores = {s.hotkey: s.score for s in v.validate_and_score()}
    assert scores.get("hotkey_0", 0) > 0, scores


# ---------------------------------------------------------------------------
# LoRA on the 3-D kernels, and the layout diagnosis
# ---------------------------------------------------------------------------

def test_lora_on_stacked_kernels_matches_jax():
    from distributedtraining_tpu.models.lora import LoRAPair
    cfg, jcfg = _cfgs("gpt2")
    tree = _jax_tree("gpt2")
    stacked = jg.stack_blocks(tree, cfg.n_layer)
    lcfg, jlcfg = tlora.LoRAConfig(rank=2), jlora.LoRAConfig(rank=2)
    jad = jlora.init_lora(jax.random.PRNGKey(1), stacked, jlcfg)
    ad = tlora.init_lora(1, stacked, lcfg)
    jflat = {".".join(jser.path_components(p)): leaf for p, leaf in
             jtu.tree_flatten_with_path(
                 jad, is_leaf=lambda x: isinstance(x, LoRAPair))[0]
             if isinstance(leaf, LoRAPair)}
    assert set(tlora.adapted_kernels(ad)) == set(jflat)
    for k, pair in jflat.items():
        a = np.asarray(pair.a)
        assert ad[k + ".a"].shape == a.shape == (cfg.n_layer, 64, 2)
        np.testing.assert_array_max_ulp(ad[k + ".a"].numpy(), a, maxulp=3)
    # the same (nonzero) adapters through both packages' algebra
    rng = np.random.default_rng(2)
    host = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
            for k, v in ad.items()}
    jhost = jtu.tree_map(lambda x: x, jad, is_leaf=lambda x: isinstance(
        x, LoRAPair))
    node = {}
    for k in jflat:
        node[k] = LoRAPair(a=jnp.asarray(host[k + ".a"]),
                           b=jnp.asarray(host[k + ".b"]))
    jhost = jtu.tree_map_with_path(
        lambda p, x: node.get(".".join(jser.path_components(p)), x),
        jad, is_leaf=lambda x: isinstance(x, LoRAPair) or x is None)
    base_state = models.params_from_numpy(stacked, device="cpu")
    tad = {k: torch.from_numpy(v) for k, v in host.items()}
    got = tlora.apply_lora(base_state, tad, lcfg)
    want = _flat(jtu.tree_map(np.asarray, jlora.apply_lora(
        jtu.tree_map(jnp.asarray, stacked), jhost, jlcfg)))
    dgot = tlora.lora_to_full_delta(base_state, tad, lcfg)
    dwant = _flat(jtu.tree_map(np.asarray, jlora.lora_to_full_delta(
        jtu.tree_map(jnp.asarray, stacked), jhost, jlcfg)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(dgot[k].numpy(), dwant[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # layer i of the stacked product is the unrolled kernel's own
    k = "h.block.c_attn.kernel"
    for i in range(cfg.n_layer):
        unrolled = torch.from_numpy(host[k + ".a"][i]) @ torch.from_numpy(
            host[k + ".b"][i]) * lcfg.scaling
        assert torch.equal(dgot[k][i], unrolled)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_layout_diagnosis_names_scan_blocks(family):
    tmod, _, _ = FAMILIES[family]
    tcfg, _ = _cfgs(family)
    tree = tmod.init_params_numpy(tcfg, 0)
    stacked = tmod.stack_blocks(tree, tcfg.n_layer)
    for payload, template in ((stacked, tree), (tree, stacked)):
        data = tser.to_msgpack(payload)
        with pytest.raises(tser.PayloadError, match="--scan-blocks") as e:
            tser.from_msgpack(data, template)
        if family == "gpt2":   # JAX's diagnosis knows GPT-2's names
            with pytest.raises(jser.PayloadError) as je:
                jser.from_msgpack(data, template)
            assert str(e.value).split(" [")[-1] == \
                str(je.value).split(" [")[-1]
    # any other mismatch keeps its plain message
    with pytest.raises(tser.PayloadError) as e:
        tser.from_msgpack(tser.to_msgpack({"x": np.zeros(2)}), tree)
    assert "scan-blocks" not in str(e.value)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

STEPS, LR = 3, 1e-3
MESH_ENGINES = {   # name -> (preset, mesh (dp, fsdp, sp, tp), fused)
    "gpt2-fsdp2": ("tiny", (1, 2, 1, 1), True),
    "gpt2-tp2": ("tiny", (1, 1, 1, 2), False),
    "gpt2-sp2": ("tiny", (1, 1, 2, 1), True),
    "llama-tp2": ("tiny-llama", (1, 1, 1, 2), True),
}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """Each preset's world of two gloo ranks: every engine of
    MESH_ENGINES in the scan layout and its unrolled twin."""
    from distributedtraining_tpu_torch.parallel import mesh as tmesh
    rng = np.random.default_rng(5)
    out = {}
    for preset in ("tiny", "tiny-llama"):
        cfg = dataclasses.replace(models.family(preset).PRESETS[preset],
                                  dtype="float32")
        ids = rng.integers(0, cfg.vocab_size, (STEPS, 4, 32)).astype(
            np.int32)
        tree = _flat(models.init_params_numpy(cfg, 0))
        args = {f"{name}/{'scan' if scan else 'unrolled'}": {
                    "mesh": dict(zip(tmesh.AXES, shape)), "preset": p,
                    "fused": fused, "packed": False, "lr": LR,
                    "grad_clip": None,
                    "overrides": {"dtype": "float32", "scan_blocks": scan}}
                for name, (p, shape, fused) in MESH_ENGINES.items()
                if p == preset for scan in (True, False)}
        ranks = _run_world(tmp_path_factory.mktemp(preset), "llama",
                           {"dp": 2}, {"input_ids": ids,
                                       **{f"p/{k}": v
                                          for k, v in tree.items()}},
                           {"engines": args})
        out[preset] = (ranks, tree, ids)
    return out


@pytest.mark.parametrize("name", list(MESH_ENGINES))
def test_scan_mesh_steps_match_world_1(mesh_world, name):
    """A scan engine's steps at fsdp2, tp2 and sp2 (two gloo ranks):
    losses within 1e-4 relative of the scan engine on one process, and
    losses, gathered params and the first loss's gradient bit-equal to
    the unrolled engine's on the same mesh (a layer's slice of a stacked
    shard is the unrolled layer's shard, gathered and summed alike)."""
    from distributedtraining_tpu_torch.engine.train import (
        TrainEngine, default_optimizer)
    preset, _, fused = MESH_ENGINES[name]
    ranks, tree, ids = mesh_world[preset]
    cfg = dataclasses.replace(models.family(preset).PRESETS[preset],
                              dtype="float32", scan_blocks=True)
    model, _ = models.make_model(cfg)
    eng = TrainEngine(model, fused_loss=fused, device="cpu",
                      optimizer=default_optimizer(LR))
    state = eng.init_state(models.stack_blocks(cfg, tree))
    losses = []
    for b in ids:
        state, m = eng.train_step(state, eng.place_batch({"input_ids": b}))
        losses.append(float(m["loss"]))
    scan, unrolled = f"{name}/scan", f"{name}/unrolled"
    for r in ranks:
        np.testing.assert_allclose(r[f"{scan}/losses"], losses, rtol=1e-4)
        assert np.array_equal(r[f"{scan}/losses"], r[f"{unrolled}/losses"])
        full = {k[len(f"{scan}/full/"):]: torch.from_numpy(v)
                for k, v in r.items() if k.startswith(f"{scan}/full/")}
        assert any(".block." in k for k in full)
        for k, v in models.unstack_blocks(cfg, full).items():
            assert np.array_equal(v.numpy(), r[f"{unrolled}/full/{k}"]), k
        for k in ("loss0", "grad0/wte", "eval0"):
            assert np.array_equal(r[f"{scan}/{k}"], r[f"{unrolled}/{k}"]), k


def test_scan_lora_mesh_matches_unrolled(tmp_path):
    """LoRA engines on the scan layout at fsdp2 and tp2 (two gloo ranks;
    each block adds its slice [i] of the stacked adapters' delta, cut to
    its piece of the kernel): the losses and the unstacked adapters
    against the unrolled twins on the same mesh."""
    import json

    from distributedtraining_tpu_torch import delta as tdl
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
    lcfg = tlora.LoRAConfig(rank=2, alpha=4.0)
    tree = models.init_params_numpy(cfg, 0)
    state = models.params_from_numpy(tree, device="cpu")
    ad = tlora.init_lora(3, state, lcfg)
    rng = np.random.default_rng(4)
    ad = {k: v + torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32) * 0.01) for k, v in ad.items()}
    ids = np.stack([b["input_ids"] for b in _batches(cfg.vocab_size, 3)])
    flat = tdl.flatten_tree(tree)
    inputs, engines = {}, {}
    for mesh in ({"fsdp": 2}, {"tp": 2}):
        for scan in (True, False):
            name = f"{'-'.join(mesh)}-{'scan' if scan else 'unrolled'}"
            p = models.stack_blocks(cfg, flat) if scan else flat
            a = models.stack_blocks(cfg, ad) if scan else ad
            inputs.update({f"{name}/p/{k}": np.asarray(v)
                           for k, v in p.items()})
            inputs.update({f"{name}/a/{k}": v.numpy() for k, v in a.items()})
            inputs[f"{name}/ids"] = ids
            engines[name] = {
                "preset": "tiny",
                "overrides": {"dtype": "float32", "scan_blocks": scan},
                "mesh": {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, **mesh},
                "fused": True}
    np_ad = tlora.adapters_to_numpy(ad, tree)
    inputs["bcast/bytes"] = np.frombuffer(tser.to_msgpack(np_ad), np.uint8)
    inputs["bcast/template"] = np.array(json.dumps(
        {k: list(np.shape(v)) for k, v in flat.items()}))
    outs = _run_world(tmp_path, "lora", {"dp": 2}, inputs,
                      {"engines": engines, "rank": 2, "alpha": 4.0,
                       "lr": 1e-3, "grad_clip": None})
    for out in outs:
        for mesh in ("fsdp", "tp"):
            s, u = f"{mesh}-scan", f"{mesh}-unrolled"
            np.testing.assert_allclose(out[f"{s}/losses"],
                                       out[f"{u}/losses"], rtol=1e-6)
            got = models.unstack_blocks(cfg, {
                k[len(f"{s}/ad/"):]: v for k, v in out.items()
                if k.startswith(f"{s}/ad/")})
            assert any(".block." in k for k in out if k.startswith(s))
            for k, v in got.items():
                ref = out[f"{u}/ad/{k}"]
                np.testing.assert_allclose(
                    v, ref, rtol=0, atol=1e-6 * float(np.abs(ref).max()),
                    err_msg=f"{mesh} {k}")
