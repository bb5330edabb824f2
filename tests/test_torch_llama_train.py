"""The Llama family on the PyTorch port's training roles (the miner, the
validator and the averager, one device and a mesh) against the JAX
package on the CPU.

JAX runs on the 8 host devices of tests/conftest.py; the port runs one
process per device over gloo (tests/torch_parallel_worker.py, case
"llama"). One world of 4 and one of 2 serve every mesh case: fsdp 2 x
tp 2 splits the heads (tp divides the 2 kv heads), tp 4 keeps the
attention on gathered parameters (it does not) and splits the MLP, and
sp 2 takes the gathered flash route on packed rows and the ring on
unpacked ones. tiny-llama widened to E 128 (4 query over 2 kv heads of
D 32), f32, B 4, T 16, three AdamW steps with a binding clip, fused and
unfused, held to JAX's ``TrainEngine(mesh=...)`` on the same mesh:
losses 1e-5 relative, parameters, Adam's mu and the gathered tree 1e-5
a shard element, block routes exact. The specs are held to JAX's
``logical_param_specs`` under ``DEFAULT_RULES`` exactly, by shape only
for llama3-8b (nothing of 8B is allocated). The mixed CLI rounds run
JAX's tiny-llama argv (tests/test_neurons.py) on one LocalFS root: a
port miner scored by JAX's validator and merged by JAX's averager, and
the reverse; each published base equals the pulled base plus the
decoded delta within 1e-6.
"""

import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu.ops import ring_attention as jring
from distributedtraining_tpu.parallel import MeshConfig as JMeshConfig
from distributedtraining_tpu.parallel import make_mesh
from distributedtraining_tpu.parallel import sharding as jsh
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch.models import llama as tl
from distributedtraining_tpu_torch.parallel import mesh as tmesh
from distributedtraining_tpu_torch.parallel import sharding as tsh
from test_torch_parallel import _flat, _iter_coords, _run_world
from test_torch_sp import _nest, _packed

STEPS, B, T = 3, 4, 16
LR, CLIP = 1e-4, 0.05
OVERRIDES = {"dtype": "float32", "n_embd": 128}
# (mesh shape, fused, packed, attention_impl, remat) of each engine, by
# world size
ENGINES = {
    4: {"fsdp2xtp2-fused-packed": ((1, 2, 1, 2), True, True, "flash",
                                   False),
        "fsdp2xtp2-fused-packed-remat": ((1, 2, 1, 2), True, True, "flash",
                                         True),
        "fsdp2xtp2-unfused": ((1, 2, 1, 2), False, False, "flash", False),
        "tp4-fused": ((1, 1, 1, 4), True, False, "flash", False),
        "tp4-unfused-packed": ((1, 1, 1, 4), False, True, "flash", False)},
    2: {"sp2-fused-packed": ((1, 1, 2, 1), True, True, "flash", False),
        "sp2-unfused-ring": ((1, 1, 2, 1), False, False, "ring", False),
        "sp2-fused-ring": ((1, 1, 2, 1), True, False, "ring", False)},
}
ROUTES = {"fsdp2xtp2": "head_split", "tp4": "gathered_attn", "sp2": None}
NAMES = [*ENGINES[4], *ENGINES[2]]


def _world_of(name):
    return 4 if name in ENGINES[4] else 2


def _cfg():
    return dataclasses.replace(tl.PRESETS["tiny-llama"], **OVERRIDES)


@pytest.fixture(scope="module")
def inputs():
    tree = _flat(tl.init_params_numpy(_cfg(), 0))
    rng = np.random.default_rng(11)
    ids = rng.integers(0, _cfg().vocab_size, (STEPS, B, T)).astype(np.int32)
    seg, pos, mask = _packed(rng, STEPS)
    return {"input_ids": ids, "segment_ids": seg, "position_ids": pos,
            "loss_mask": mask, **{f"p/{k}": v for k, v in tree.items()}}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Each world's ranks' outputs, by world size: every engine of that
    size in one process start."""
    out = {}
    for n, engines in ENGINES.items():
        args = {name: {"mesh": dict(zip(tmesh.AXES, shape)),
                       "preset": "tiny-llama", "fused": fused,
                       "packed": packed, "lr": LR, "grad_clip": CLIP,
                       "overrides": {**OVERRIDES, "attention_impl": impl,
                                     "remat": remat}}
                for name, (shape, fused, packed, impl, remat)
                in engines.items()}
        out[n] = _run_world(tmp_path_factory.mktemp(f"llama{n}"), "llama",
                            {"dp": n}, inputs, {"engines": args})
    return out


def _batch(inputs, i, packed):
    keys = ("input_ids", "segment_ids", "position_ids", "loss_mask") \
        if packed else ("input_ids",)
    return {k: jnp.asarray(inputs[k][i]) for k in keys}


@pytest.fixture(scope="module")
def jax_runs(devices, inputs):
    """JAX's engine on each mesh (a remat engine's reference is its
    twin's: remat changes no value), one loss of the first batch on one
    device, and the first step's gradient norm (the clip must bind)."""
    nested = _nest({k[2:]: v for k, v in inputs.items()
                    if k.startswith("p/")})
    jdense, _ = jl.make_model(dataclasses.replace(
        jl.PRESETS["tiny-llama"], **OVERRIDES, attention_impl="dense"))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain._default_lm_loss(jdense, p, b), has_aux=True))
    one_device, runs = {}, {}
    try:
        for n, engines in ENGINES.items():
            for name, (shape, fused, packed, impl, remat) in engines.items():
                if remat:
                    continue
                jmodel, _ = jl.make_model(dataclasses.replace(
                    jl.PRESETS["tiny-llama"], **OVERRIDES,
                    attention_impl=impl))
                jeng = jtrain.TrainEngine(
                    jmodel, mesh=make_mesh(JMeshConfig(*shape)), seq_len=T,
                    fused_loss="scan" if fused else False,
                    optimizer=jtrain.default_optimizer(LR, grad_clip=CLIP))
                state = jeng.init_state(params=jax.tree_util.tree_map(
                    jnp.asarray, nested))
                losses, tokens = [], []
                for i in range(STEPS):
                    state, m = jeng.train_step(state, jeng.place_batch(
                        _batch(inputs, i, packed)))
                    losses.append(float(m["loss"]))
                    tokens.append(float(m["tokens"]))
                if packed not in one_device:
                    (loss0, _), g0 = grad_fn(jax.tree_util.tree_map(
                        jnp.asarray, nested), _batch(inputs, 0, packed))
                    one_device[packed] = {
                        "loss0": float(loss0),
                        "norm0": float(jnp.sqrt(sum(
                            jnp.sum(x * x)
                            for x in jax.tree_util.tree_leaves(g0))))}
                runs[name] = {
                    "losses": losses, "tokens": tokens,
                    **one_device[packed],
                    "params": {k: np.asarray(v)
                               for k, v in _flat(state.params).items()},
                    "mu": {k: np.asarray(v) for k, v in _flat(
                        state.opt_state[1][0].mu).items()}}
    finally:
        jring.set_ring_mesh(None)
    return runs


# ---------------------------------------------------------------------------
# The specs and the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny-llama", "llama3-8b"])
def test_llama_param_specs_match_jax_logical_specs(devices, preset):
    """Every Llama parameter's spec is JAX's ``logical_param_specs``
    resolved by ``DEFAULT_RULES``, exactly, over the same names."""
    jmodel, _ = jl.make_model(preset)
    logical = _flat(jsh.logical_param_specs(jmodel, seq_len=8))
    want = {k: tuple(nn.logical_to_mesh_axes(v, jsh.DEFAULT_RULES))
            for k, v in logical.items()}
    model, _ = models.make_model(preset)
    ours = tsh.param_specs(model.state_dict())
    assert set(ours) == set(want)
    for k, spec in want.items():
        assert ours[k] == spec + (None,) * (len(ours[k]) - len(spec)), k
    assert ours["lm_head"] == ("tp", "fsdp")
    assert ours["layer_0.wq.kernel"] == ("fsdp", "tp")
    assert ours["layer_0.w_down.kernel"] == ("tp", "fsdp")


def test_tp_block_route_splits_heads_where_tp_divides_the_kv_heads():
    class _M:
        def __init__(self, tp):
            self.shape = {"dp": 1, "fsdp": 1, "sp": 1, "tp": tp}

        size = tmesh.Mesh.size

    cfg8b = tl.PRESETS["llama3-8b"]                 # 32 over 8 kv heads
    assert tsh.tp_block_route(cfg8b, _M(1)) is None
    assert tsh.tp_block_route(cfg8b, _M(8)) == "head_split"
    assert tsh.tp_block_route(cfg8b, _M(16)) == "gathered_attn"
    tiny = tl.PRESETS["tiny-llama"]                 # 4 over 2 kv heads
    assert tsh.tp_block_route(tiny, _M(2)) == "head_split"
    assert tsh.tp_block_route(tiny, _M(4)) == "gathered_attn"
    # a GPT-2 config has as many kv heads as heads
    from distributedtraining_tpu_torch.models import gpt2
    assert tsh.tp_block_route(gpt2.PRESETS["gpt2-1.5b"], _M(2)) == \
        "gathered_attn"
    assert tsh.tp_block_route(gpt2.PRESETS["gpt2-124m"], _M(4)) == \
        "head_split"


def test_llama_head_split_leaves_are_whole_heads():
    """On head_split a rank's tp chunks of wq, wk, wv are whole heads
    and its query heads read exactly its own kv heads; wo's chunk is the
    rows of those query heads."""
    cfg = _cfg()
    Hq, Hkv, D, E = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.n_embd
    tp, rep = 2, cfg.n_head // cfg.n_kv_head
    shape = {"dp": 1, "fsdp": 1, "sp": 1, "tp": tp}
    for t in range(tp):
        coords = {"dp": 0, "fsdp": 0, "sp": 0, "tp": t}
        q = tsh.shard_slices("layer_0.wq.kernel", (E, Hq * D),
                             tsh.param_spec("layer_0.wq.kernel"), shape,
                             coords)[1]
        k = tsh.shard_slices("layer_0.wk.kernel", (E, Hkv * D),
                             tsh.param_spec("layer_0.wk.kernel"), shape,
                             coords)[1]
        o = tsh.shard_slices("layer_0.wo.kernel", (Hq * D, E),
                             tsh.param_spec("layer_0.wo.kernel"), shape,
                             coords)[0]
        q_heads = range(q.start // D, q.stop // D)
        kv_heads = range(k.start // D, k.stop // D)
        assert q.start % D == 0 and k.start % D == 0 and o == q
        assert sorted({h // rep for h in q_heads}) == list(kv_heads)


# ---------------------------------------------------------------------------
# The mesh engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_llama_mesh_engine_matches_jax_engine(worlds, jax_runs, name):
    """Three AdamW steps with a binding --grad-clip: losses and tokens,
    each rank's parameter and mu shards and the gathered tree against
    JAX's TrainEngine on the same mesh; every block took the mesh's tp
    route."""
    n = _world_of(name)
    shape = ENGINES[n][name][0]
    ref = jax_runs[name.replace("-remat", "")]
    assert ref["norm0"] > CLIP
    route = ROUTES[name.split("-")[0]]
    L = _cfg().n_layer
    mesh_shape = dict(zip(tmesh.AXES, shape))
    specs = tsh.param_specs(ref["params"])
    for rank, coords in _iter_coords(tmesh.MeshConfig(*shape)):
        o = worlds[n][rank]
        np.testing.assert_allclose(o[f"{name}/losses"], ref["losses"],
                                   rtol=1e-5)
        assert list(o[f"{name}/tokens"]) == ref["tokens"]
        for r in ("head_split", "gathered_attn"):
            want = STEPS * L if r == route else 0
            assert int(o[f"{name}/routes/tp_{r}_blocks"]) == want, r
        for k, full in ref["params"].items():
            sl = tsh.shard_slices(k, full.shape, specs[k], mesh_shape,
                                  coords)
            np.testing.assert_allclose(o[f"{name}/p/{k}"], full[sl],
                                       atol=1e-5, err_msg=f"rank {rank} {k}")
            np.testing.assert_allclose(o[f"{name}/mu/{k}"],
                                       ref["mu"][k][sl], atol=1e-5,
                                       err_msg=f"rank {rank} mu {k}")
            np.testing.assert_allclose(o[f"{name}/full/{k}"], full,
                                       atol=1e-5,
                                       err_msg=f"rank {rank} gathered {k}")


@pytest.mark.parametrize("name", NAMES)
def test_llama_mesh_loss_and_evaluate_match_jax(worlds, jax_runs, name):
    """One loss of the first batch (the step's) and ``evaluate`` of its
    whole rows on every rank: JAX's loss on one device."""
    n = _world_of(name)
    ref = jax_runs[name.replace("-remat", "")]["loss0"]
    for o in worlds[n]:
        np.testing.assert_allclose(float(o[f"{name}/loss0"]), ref,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(o[f"{name}/eval0"]), ref,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLIs: a mixed round each way
# ---------------------------------------------------------------------------

def _argv(work, hk, extra):
    """JAX tests/test_neurons.py::test_llama_family_offline_round's
    argv."""
    return ["--backend", "local", "--work-dir", str(work),
            "--model", "tiny-llama", "--dataset", "synthetic",
            "--hotkey", hk, "--dp", "1",
            "--batch-size", "4", "--seq-len", "32", "--eval-seq-len", "32",
            "--eval-batches", "2", *extra]


MINER = ["--max-steps", "25", "--send-interval", "1e9",
         "--checkpoint-interval", "0", "--delta-dtype", "sparse8"]
VALIDATOR = ["--rounds", "1"]
AVERAGER = ["--rounds", "1", "--strategy", "weighted"]


def _round(work, miner, validator, averager):
    """A published base (each package draws its genesis from its own
    generator, so the round starts from one both pull), the miner, the
    validator, then the averager's merge; the base, the decoded delta
    and the published base, each flat and read by the port."""
    from distributedtraining_tpu_torch import delta as tdl
    from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    t = LocalFSTransport(str(work / "artifacts"))
    rev0 = t.publish_base(tl.init_params_numpy(tl.PRESETS["tiny-llama"], 5))
    template = _wire_template(models.make_model("tiny-llama")[0])
    base, _ = t.fetch_base(template)
    assert miner(_argv(work, "hotkey_0", MINER)) == 0
    staged = DeltaIngestor(t, template, workers=1).stage(["hotkey_0"])[0]
    assert staged.reason == "ok"
    assert validator(_argv(work, "hotkey_91", VALIDATOR)) == 0
    meta = json.loads((work / "chain" / "metagraph.json").read_text())
    weight = meta["weights"]["hotkey_91"].get("hotkey_0", 0)
    assert averager(_argv(work, "hotkey_99", AVERAGER)) == 0
    merged, rev1 = t.fetch_base(template)
    assert rev1 != rev0
    return (weight, _flat(base), tdl.flatten_tree(staged.delta),
            _flat(merged))


def _cli(module):
    import logging

    def run(argv):
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        try:
            return module.main(argv)
        finally:   # main's logging.basicConfig must not outlive the call
            root.handlers[:], root.level = handlers, level
    return run


@pytest.mark.parametrize("direction", ["port-miner", "jax-miner"])
def test_mixed_llama_round_on_one_root(tmp_path, monkeypatch, direction):
    """A port tiny-llama miner (sparse8) scored by JAX's validator and
    merged by JAX's averager, and a JAX miner by the port's: the
    validator weighs the other package's miner > 0, and the published
    base is the base plus its one weighted delta (weight 1) within
    1e-6."""
    from neurons import averager as javg
    from neurons import miner as jminer
    from neurons import validator as jval
    from distributedtraining_tpu_torch.neurons import averager as tavg
    from distributedtraining_tpu_torch.neurons import miner as tminer
    from distributedtraining_tpu_torch.neurons import validator as tval
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    if direction == "port-miner":
        roles = (_cli(tminer), _cli(jval), _cli(javg))
    else:
        roles = (_cli(jminer), _cli(tval), _cli(tavg))
    weight, base, delta, merged = _round(tmp_path, *roles)
    assert weight > 0
    assert set(merged) == set(base) == set(delta)
    assert any(np.any(delta[k] != 0) for k in delta)
    for k in base:
        np.testing.assert_allclose(merged[k], base[k] + delta[k], rtol=0,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The validator and the meta-learned merge on a Llama tree
# ---------------------------------------------------------------------------

TINY32 = dataclasses.replace(tl.PRESETS["tiny-llama"], dtype="float32")
JTINY32 = dataclasses.replace(jl.PRESETS["tiny-llama"], dtype="float32")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A tiny-llama (f32) base published by JAX's transport, two port
    miners' dense deltas (a few steps at lr 1e-2) and a packed one whose
    ``wte`` scale is 1e6 (the magnitude screen's verdict), and held-out
    batches."""
    import torch

    from distributedtraining_tpu.transport import LocalFSTransport as JFS
    from distributedtraining_tpu_torch import delta as tdl
    from distributedtraining_tpu_torch.data import datasets as tds
    from distributedtraining_tpu_torch.engine import train as ttrain
    from distributedtraining_tpu_torch.engine.publish import DeltaPublisher
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    torch.set_num_threads(1)
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY32.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=2, seq_len=32, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(4)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=2, seq_len=32))[:2]
    model, _ = models.make_model(TINY32)
    base = models.init_params_numpy(TINY32, 0)
    root = str(tmp_path_factory.mktemp("llama_fleet") / "artifacts")
    rev = JFS(root).publish_base(jax.tree_util.tree_map(jnp.asarray, base))
    t = LocalFSTransport(root)
    fast = ttrain.TrainEngine(model, optimizer=ttrain.default_optimizer(1e-2),
                              device="cpu")
    deltas = []
    for i, hotkey in enumerate(("hotkey_1", "hotkey_2")):
        state = fast.init_state(models.params_from_numpy(base, device="cpu"))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        for b in train[2 * i:2 * i + 2]:
            state, _ = fast.train_step(state, fast.place_batch(b))
        d = models.params_to_numpy(tdl.compute_delta(state.params, snap))
        deltas.append(d)
        t.publish_delta(hotkey, d)
        t.publish_delta_meta(hotkey, {"base_revision": rev})
    packed, _ = tdl.pack_delta_v2(
        models.params_from_numpy(deltas[0], device="cpu"), density=1 / 16,
        quant="int8")
    packed["leaves"]["wte"]["scale"] = torch.tensor(1e6)
    pub = DeltaPublisher(t, "hotkey_6", report=ttrain.MinerReport(),
                         wire_spec={"format": 2, "density": 1 / 16,
                                    "quant": "int8"})
    assert pub.publish_now(packed, None, rev, "hotkey_6-000001")
    pub.close()
    return {"base": base, "val": val, "root": root, "deltas": deltas,
            "model": model, "teng": ttrain.TrainEngine(model, device="cpu"),
            "jmodel": jl.make_model(JTINY32)[0]}


def test_llama_validator_round_matches_jax(fleet, tmp_path):
    """One round at cohort 8 of the port's Validator and of JAX's on one
    root: the base's loss and each miner's loss within 1e-5 relative,
    the scores within four ulps of the larger loss, the hostile refused
    with JAX's verdict, the consensus weights within 1e-6."""
    from distributedtraining_tpu.chain import LocalChain as JChain
    from distributedtraining_tpu.engine.validate import Validator as JVal
    from distributedtraining_tpu.transport import LocalFSTransport as JFS
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine import validate as tval
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    sides = {
        "port": tval.Validator(
            fleet["teng"], LocalFSTransport(fleet["root"]),
            LocalChain(str(tmp_path / "port"), my_hotkey="hotkey_91"),
            eval_batches=lambda: iter(fleet["val"]), cohort_size=8),
        "jax": JVal(
            jtrain.TrainEngine(fleet["jmodel"]), JFS(fleet["root"]),
            JChain(str(tmp_path / "jax"), my_hotkey="hotkey_91"),
            eval_batches=lambda: iter(fleet["val"]), cohort_size=8)}
    res = {}
    for side, v in sides.items():
        v.bootstrap()
        res[side] = {s.hotkey: s for s in v.validate_and_score()}
        v.close()
    pv, jv = sides["port"], sides["jax"]
    assert pv.base_loss == pytest.approx(jv.base_loss, rel=1e-5)
    ours, theirs = res["port"], res["jax"]
    assert set(ours) == set(theirs)
    for h, s in theirs.items():
        assert ours[h].reason == s.reason, h
        if s.loss is None:
            assert ours[h].loss is None and ours[h].score == 0.0
            continue
        assert ours[h].loss == pytest.approx(s.loss, rel=1e-5), h
        ulp = float(np.spacing(np.float32(max(s.loss, jv.base_loss))))
        assert abs(ours[h].score - s.score) <= max(1e-6, 4 * ulp), h
    assert ours["hotkey_6"].reason.startswith("magnitude_exceeded(")
    assert all(ours[h].score > 0 for h in ("hotkey_1", "hotkey_2"))
    pc = LocalChain(str(tmp_path / "port")).consensus_scores()
    jc = JChain(str(tmp_path / "jax")).consensus_scores()
    assert set(pc) == set(jc)
    for h in jc:
        assert abs(pc[h] - jc[h]) <= 1e-6, h


@pytest.mark.parametrize("per_tensor", [True, False],
                         ids=["per_tensor", "scalar"])
def test_llama_parameterized_merge_matches_jax(fleet, per_tensor):
    """``ParameterizedMerge`` (the averager's default strategy) on the two
    Llama deltas, 2 epochs on 2 batches: the learned logits and the
    merged tree within 1e-5 of JAX's strategy."""
    from distributedtraining_tpu import delta as jdl
    from distributedtraining_tpu.engine.average import \
        ParameterizedMerge as JPM
    from distributedtraining_tpu_torch import delta as tdl
    from distributedtraining_tpu_torch.engine import average as tavg
    ids = ["hotkey_1", "hotkey_2"]
    base = models.params_from_numpy(fleet["base"], device="cpu")
    ours = tavg.ParameterizedMerge(fleet["model"], meta_epochs=2,
                                   per_tensor=per_tensor)
    merged, w = ours.merge(fleet["teng"], base, fleet["deltas"], ids,
                           val_batches=lambda: iter(fleet["val"]))
    jtree = jax.tree_util.tree_map(jnp.asarray, fleet["base"])
    ref = JPM(fleet["jmodel"], meta_epochs=2, per_tensor=per_tensor)
    jmerged, jw = ref.merge(
        jtrain.TrainEngine(fleet["jmodel"]), jtree,
        jdl.stack_deltas([jax.tree_util.tree_map(jnp.asarray, d)
                          for d in fleet["deltas"]]), ids,
        val_batches=lambda: iter(fleet["val"]))
    flat = lambda x: tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, x))
    jw = flat(jw) if per_tensor else {"w": np.asarray(jw)}
    ow = ({k: v.numpy() for k, v in w.items()} if per_tensor
          else {"w": w.numpy()})
    assert set(ow) == set(jw)
    for k in jw:
        np.testing.assert_allclose(ow[k], jw[k], rtol=0, atol=1e-5)
    assert any(float(np.abs(v).max()) > 1e-4 for v in ow.values())
    jm = flat(jmerged)
    assert set(jm) == set(merged)
    for k in jm:
        np.testing.assert_allclose(merged[k].numpy(), jm[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_two_process_llama_miner_cli_at_tp2(tmp_path):
    """Two ranks of the port's miner CLI on ``--model tiny-llama --tp 2``
    (head_split: tp divides the 2 kv heads): each rank's shards after the
    pull are the base's slices, bit for bit; the coordinator alone
    publishes; the delta on the wire equals the gathered trained - base."""
    from distributedtraining_tpu_torch.engine.train import _wire_template
    from distributedtraining_tpu_torch import serialization as ser
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    work = tmp_path / "work"
    base = _flat(tl.init_params_numpy(tl.PRESETS["tiny-llama"], 5))
    LocalFSTransport(str(work / "artifacts")).publish_base(
        tl.init_params_numpy(tl.PRESETS["tiny-llama"], 5))
    io = tmp_path / "io"
    io.mkdir()
    argv = ["--work-dir", str(work), "--backend", "local", "--model",
            "tiny-llama", "--dataset", "synthetic", "--hotkey", "hotkey_0",
            "--batch-size", "4", "--seq-len", "32", "--fused-loss",
            "--send-interval", "0", "--check-update-interval", "0",
            "--dp", "0", "--tp", "2", "--max-steps", "3",
            "--checkpoint-interval", "0"]
    outs = _run_world(io, "miner", {"dp": 2}, {}, {"argv": argv})
    assert [int(o["rc"]) for o in outs] == [0, 0]
    assert int(outs[0]["pushes"]) >= 1 and int(outs[1]["pushes"]) == 0
    specs = tsh.param_specs(base)
    mesh_shape = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 2}
    for o in outs:
        coords = json.loads(str(o["coords"]))
        assert coords["tp"] in (0, 1)
        for k, v in base.items():
            sl = tsh.shard_slices(k, v.shape, specs[k], mesh_shape, coords)
            np.testing.assert_array_equal(o[f"boot/{k}"], v[sl], err_msg=k)
            np.testing.assert_array_equal(o[f"full/{k}"],
                                          outs[0][f"full/{k}"], err_msg=k)
    model, _ = models.make_model("tiny-llama")
    data = (work / "artifacts" / "deltas" / "hotkey_0.msgpack").read_bytes()
    delta = _flat(ser.from_msgpack(data, _wire_template(model)))
    assert set(delta) == set(base)
    for k, v in base.items():
        np.testing.assert_array_equal(np.asarray(delta[k]),
                                      outs[0][f"full/{k}"] - v, err_msg=k)
    assert any(np.abs(np.asarray(d)).max() > 0 for d in delta.values())


@pytest.mark.parametrize("mode", ["normal", "ties", "nan", "inf_and_zero",
                                  "signed_zero"])
def test_pack_top_k_order_is_the_stable_sort_prefix(mode):
    """``delta._top_k_order`` (the sparse8 and wire-v2 packs' selection
    without a full sort, whose buffers take ~24 bytes a value at the
    8B-width miner's 525M-value leaves) gives the first k indices of
    ``torch.sort(descending=True, stable=True)``: ties to the lower
    index, NaN first, at every k."""
    import torch

    from distributedtraining_tpu_torch import delta as tdl
    g = torch.Generator().manual_seed(len(mode))
    for n in (1, 2, 7, 64, 257, 1000):
        x = torch.randn(n, generator=g)
        if mode == "ties":
            x = torch.round(x * 3) / 3
        elif mode == "nan":
            x[torch.rand(n, generator=g) < 0.2] = float("nan")
        elif mode == "inf_and_zero":
            x[torch.rand(n, generator=g) < 0.2] = float("inf")
            x[torch.rand(n, generator=g) < 0.3] = 0.0
        elif mode == "signed_zero":
            x[::3] = -0.0
            x[1::3] = 0.0
        mags = x.abs()
        want = torch.sort(mags, descending=True, stable=True).indices
        for k in sorted({1, 2, n // 3, n // 2, n - 1, n} - {0}):
            np.testing.assert_array_equal(
                tdl._top_k_order(mags, k).numpy(), want[:k].numpy(),
                err_msg=f"n {n} k {k}")
