"""Sequence parallelism (``--sp``), remat, ``--mu-dtype`` and ``--dcn-dp``
of the PyTorch port against the JAX package on the CPU.

JAX runs on the 8 host devices of tests/conftest.py; the port runs one
process per device over gloo (tests/torch_parallel_worker.py, case
"sp"). One world of 2 and one of 4 serve every case: the ring attention
(``ops/ring_attention.py``) at sp 2 and 4 on B 2, T 64, H 4, D 16, held
to JAX's ``ring_attention`` and ``jax.vjp`` of it at JAX's own tolerance
(rtol 2e-4, atol 2e-5); and three AdamW steps (a binding clip) of the
engine on sp2, fsdp2 x sp2 and sp2 x tp2, fused and unfused, on packed
rows (the gathered route: segment ids, positions and a loss mask) and
with ``attention_impl="ring"`` on unpacked rows (each of the four
pairings on a mesh of sp with another axis), held to JAX's
``TrainEngine(mesh=...)`` on the same mesh: losses 1e-5 relative,
parameters and Adam's mu 1e-5 a shard element. The tiny preset, f32,
B 4, T 16. Remat and ``mu_dtype`` run in this process against JAX's
engines; the dcn_dp layout and auto pick are pure arithmetic, held
exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.ops import ring_attention as jring
from distributedtraining_tpu.parallel import MeshConfig as JMeshConfig
from distributedtraining_tpu.parallel import make_mesh
from distributedtraining_tpu.parallel import mesh as jmesh
from distributedtraining_tpu.parallel import multihost as jmh
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.parallel import mesh as tmesh
from distributedtraining_tpu_torch.parallel import multihost as tmh
from distributedtraining_tpu_torch.parallel import sharding as tsh
from test_torch_parallel import (_flat, _iter_coords, _miner_argv,
                                 _publish_tiny_base, _run_world)

STEPS, B, T = 3, 4, 16
LR, CLIP = 1e-3, 0.05
OVERRIDES = {"dtype": "float32"}
# (mesh shape, fused, packed, attention_impl, remat) of each engine
ENGINES = {
    2: {"sp2-fused-packed": ((1, 1, 2, 1), True, True, "flash", False)},
    4: {"fsdp2xsp2-fused-packed": ((1, 2, 2, 1), True, True, "flash",
                                   False),
        "fsdp2xsp2-fused-packed-remat": ((1, 2, 2, 1), True, True, "flash",
                                         True),
        "fsdp2xsp2-unfused-ring": ((1, 2, 2, 1), False, False, "ring",
                                   False),
        "sp2xtp2-unfused-packed": ((1, 1, 2, 2), False, True, "flash",
                                   False),
        "sp2xtp2-fused-ring": ((1, 1, 2, 2), True, False, "ring", False)},
}
RING = {2: {"sp2": {"sp": 2}}, 4: {"sp4": {"sp": 4}}}
RING_SHAPE = (2, 64, 4, 16)


def _packed(rng, steps):
    """Rows of two to four documents each: segment ids, positions that
    restart at each document and a loss mask that is 0 where the label
    token starts a document."""
    seg = np.zeros((steps, B, T), np.int32)
    for s in range(steps):
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, T), rng.integers(1, 4),
                                      replace=False))
            seg[s, b] = np.searchsorted(cuts, np.arange(T), side="right")
    start = np.concatenate([np.ones((steps, B, 1), bool),
                            seg[..., 1:] != seg[..., :-1]], axis=-1)
    pos = np.zeros_like(seg)
    for t in range(1, T):
        pos[..., t] = np.where(start[..., t], 0, pos[..., t - 1] + 1)
    return seg, pos, (~start).astype(np.float32)


def _inputs():
    cfg = dataclasses.replace(tg.PRESETS["tiny"], **OVERRIDES)
    tree = _flat(tg.init_params_numpy(cfg, 0))
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab_size, (STEPS, B, T)).astype(np.int32)
    seg, pos, mask = _packed(rng, STEPS)
    q, k, v, ct = (rng.standard_normal(RING_SHAPE, dtype=np.float32)
                   for _ in range(4))
    return {"input_ids": ids, "segment_ids": seg, "position_ids": pos,
            "loss_mask": mask, "q": q, "k": k, "v": v, "ct": ct,
            **{f"p/{k_}": v_ for k_, v_ in tree.items()}}


def _engine_args(n):
    return {name: {"mesh": dict(zip(tmesh.AXES, shape)), "fused": fused,
                   "packed": packed, "lr": LR, "grad_clip": CLIP,
                   "overrides": {**OVERRIDES, "attention_impl": impl,
                                 "remat": remat}}
            for name, (shape, fused, packed, impl, remat)
            in ENGINES[n].items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Each world's ranks' outputs, by world size."""
    out = {}
    for n in (2, 4):
        io = tmp_path_factory.mktemp(f"sp{n}")
        out[n] = _run_world(io, "sp", {"dp": n}, inputs,
                            {"ring": RING[n], "engines": _engine_args(n)})
    return out


def _batch(inputs, i, packed):
    keys = ("input_ids", "segment_ids", "position_ids", "loss_mask") \
        if packed else ("input_ids",)
    return {k: jnp.asarray(inputs[k][i]) for k in keys}


def _jax_cfg(impl="flash", remat=False):
    return dataclasses.replace(jg.PRESETS["tiny"], **OVERRIDES,
                               attention_impl=impl, remat=remat)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """JAX's engine on each mesh (remat changes no value, so the remat
    engine's reference is its twin's), and the gradient of one loss of
    the first batch on one device."""
    tree = {k[2:]: v for k, v in inputs.items() if k.startswith("p/")}
    nested = _nest(tree)
    jdense, _ = jg.make_model(_jax_cfg("dense"))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain._default_lm_loss(jdense, p, b), has_aux=True))
    one_device: dict = {}      # packed or not -> loss, count, wte grad
    runs = {}
    try:
        for n in (2, 4):
            for name, (shape, fused, packed, impl, remat) in \
                    ENGINES[n].items():
                if remat:
                    continue
                jmodel, _ = jg.make_model(_jax_cfg(impl))
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
                    (loss0, count0), g0 = grad_fn(
                        jax.tree_util.tree_map(jnp.asarray, nested),
                        _batch(inputs, 0, packed))
                    one_device[packed] = {"loss0": float(loss0),
                                          "count0": float(count0),
                                          "wte0": np.asarray(g0["wte"])}
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


def _nest(flat):
    tree: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# The ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_and_its_gradients_match_jax(devices, inputs, worlds,
                                                    sp):
    """Each rank's block of the output and of dq, dk, dv against JAX's
    ring on a MeshConfig(sp=sp) mesh (JAX's tolerance); sp - 1 passes of
    the stacked K/V forward and as many of their cotangents back."""
    mesh = make_mesh(JMeshConfig(sp=sp))
    q, k, v, ct = (jnp.asarray(inputs[x]) for x in ("q", "k", "v", "ct"))
    o, vjp = jax.vjp(lambda a, b, c: jring.ring_attention(
        a, b, c, mesh=mesh, axis="sp"), q, k, v)
    grads = dict(zip(("dq", "dk", "dv"), vjp(ct)))
    per = RING_SHAPE[1] // sp
    for rank, out in enumerate(worlds[sp]):
        sl = slice(rank * per, (rank + 1) * per)
        name = f"ring/sp{sp}"
        np.testing.assert_allclose(out[f"{name}/o"], np.asarray(o)[:, sl],
                                   rtol=2e-4, atol=2e-5)
        for g, ref in grads.items():
            np.testing.assert_allclose(out[f"{name}/{g}"],
                                       np.asarray(ref)[:, sl],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {rank} {g}")
        assert int(out[f"{name}/passes_fwd"]) == sp - 1
        assert int(out[f"{name}/passes_bwd"]) == sp - 1


def test_ring_attention_without_a_mesh_is_dense_attention(inputs):
    from distributedtraining_tpu_torch.ops import attention as tatt
    from distributedtraining_tpu_torch.ops.ring_attention import \
        ring_attention
    q = inputs["q"][:, :16]
    ours = ring_attention(*(torch.from_numpy(x.copy()) for x in (q, q, q)))
    ref = jring.ring_attention(jnp.asarray(q), jnp.asarray(q),
                               jnp.asarray(q))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    # "ring" on no sp mesh is the dense path, as in JAX
    dense = tatt.causal_attention(*(torch.from_numpy(x.copy())
                                    for x in (q, q, q)), impl="ring")
    np.testing.assert_array_equal(dense.numpy(), ours.numpy())


def test_positions_that_sp_does_not_divide_raise():
    class _M:
        shape = {"dp": 1, "fsdp": 1, "sp": 4, "tp": 1}
        coords = {"dp": 0, "fsdp": 0, "sp": 1, "tp": 0}
        size = tmesh.Mesh.size
        index = tmesh.Mesh.index

    with pytest.raises(ValueError, match="not divisible by sp = 4"):
        tsh.batch_rows({"input_ids": np.zeros((2, 18), np.int32)}, _M())


def test_batch_columns_shift_the_targets_on_the_whole_row():
    """The labels and the loss mask are shifted before the cut: an sp
    chunk's last position is labelled with the next chunk's first token;
    the segment ids stay whole."""
    class _M:
        shape = {"dp": 1, "fsdp": 1, "sp": 2, "tp": 1}
        size = tmesh.Mesh.size
        index = tmesh.Mesh.index

        def __init__(self, c):
            self.coords = {"dp": 0, "fsdp": 0, "sp": c, "tp": 0}

    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    seg = np.array([[0, 0, 0, 1, 1, 1, 1, 1]] * 2, np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[:, 3] = 0
    parts = [tsh.batch_rows({"input_ids": ids, "segment_ids": seg,
                             "loss_mask": mask}, _M(c)) for c in (0, 1)]
    np.testing.assert_array_equal(parts[0]["labels"], ids[:, 1:5])
    np.testing.assert_array_equal(parts[1]["labels"][:, :3], ids[:, 5:])
    np.testing.assert_array_equal(parts[1]["label_mask"][:, 3], [0, 0])
    np.testing.assert_array_equal(parts[0]["label_mask"][:, 2], [0, 0])
    for p in parts:
        np.testing.assert_array_equal(p["segment_ids"], seg)
    np.testing.assert_array_equal(parts[1]["input_ids"], ids[:, 4:])


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*ENGINES[2], *ENGINES[4]])
def test_sp_engine_matches_jax_engine(devices, worlds, jax_runs, name):
    """Three steps: losses and tokens, each rank's parameter and mu
    shards."""
    n = 2 if name in ENGINES[2] else 4
    shape = ENGINES[n][name][0]
    ref = jax_runs[name.replace("-remat", "")]
    mesh_shape = dict(zip(tmesh.AXES, shape))
    specs = tsh.param_specs(ref["params"])
    for rank, coords in _iter_coords(tmesh.MeshConfig(*shape)):
        o = worlds[n][rank]
        np.testing.assert_allclose(o[f"{name}/losses"], ref["losses"],
                                   rtol=1e-5)
        assert list(o[f"{name}/tokens"]) == ref["tokens"]
        for k, full in ref["params"].items():
            sl = tsh.shard_slices(k, full.shape, specs[k], mesh_shape,
                                  coords)
            np.testing.assert_allclose(o[f"{name}/p/{k}"], full[sl],
                                       atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
            np.testing.assert_allclose(o[f"{name}/mu/{k}"],
                                       ref["mu"][k][sl], atol=1e-5,
                                       err_msg=f"rank {rank} mu {k}")


def test_unfused_loss_counts_the_chunk_boundaries(worlds, jax_runs):
    """The unfused loss on an sp mesh: JAX's value and JAX's token count,
    B (T - 1) on unpacked rows (slicing each rank's chunk would drop one
    position a chunk and count B (T - sp))."""
    for n, name in ((4, "fsdp2xsp2-unfused-ring"),
                    (4, "sp2xtp2-unfused-packed")):
        ref = jax_runs[name]
        for o in worlds[n]:
            np.testing.assert_allclose(o[f"{name}/loss0"], ref["loss0"],
                                       rtol=1e-5)
            assert float(o[f"{name}/count0"]) == ref["count0"]
    assert jax_runs["fsdp2xsp2-unfused-ring"]["count0"] == B * (T - 1)


@pytest.mark.parametrize("name", [*ENGINES[2], *ENGINES[4]])
def test_evaluate_on_an_sp_mesh_matches_jax(worlds, jax_runs, name):
    """``TrainEngine.evaluate`` of whole rows on every rank of the mesh:
    JAX's mean loss of the first batch."""
    n = 2 if name in ENGINES[2] else 4
    ref = jax_runs[name.replace("-remat", "")]["loss0"]
    for o in worlds[n]:
        np.testing.assert_allclose(float(o[f"{name}/eval0"]), ref,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["fsdp2xsp2-fused-packed",
                                  "fsdp2xsp2-unfused-ring"])
def test_wte_gradient_at_fsdp2xsp2_matches_jax(worlds, jax_runs, name):
    """The embedding's gradient (the scatter-add of each rank's rows and
    positions, reduce-scattered over fsdp and summed over sp) against
    ``jax.grad`` on one device."""
    ref = jax_runs[name]["wte0"]
    shape = ENGINES[4][name][0]
    mesh_shape = dict(zip(tmesh.AXES, shape))
    for rank, coords in _iter_coords(tmesh.MeshConfig(*shape)):
        sl = tsh.shard_slices("wte", ref.shape, ("tp", "fsdp"), mesh_shape,
                              coords)
        np.testing.assert_allclose(worlds[4][rank][f"{name}/grad0/wte"],
                                   ref[sl], atol=1e-6, rtol=1e-5)


def test_remat_on_a_mesh_is_bit_equal_to_its_twin(worlds):
    for o in worlds[4]:
        a, b = "fsdp2xsp2-fused-packed", "fsdp2xsp2-fused-packed-remat"
        for k in (k for k in o if k.startswith(a + "/")):
            np.testing.assert_array_equal(o[k], o[b + k[len(a):]],
                                          err_msg=k)


# ---------------------------------------------------------------------------
# Remat and mu_dtype on one device
# ---------------------------------------------------------------------------

def _single_device_runs(inputs, *, remat=False, mu_dtype=None):
    """Three steps of the port's and of JAX's engine (unfused, packed)."""
    from distributedtraining_tpu_torch.engine import train as ttrain
    tree = {k[2:]: v for k, v in inputs.items() if k.startswith("p/")}
    cfg = dataclasses.replace(tg.PRESETS["tiny"], **OVERRIDES, remat=remat)
    eng = ttrain.TrainEngine(tg.make_model(cfg)[0], device="cpu",
                             optimizer=ttrain.default_optimizer(
                                 LR, grad_clip=CLIP, mu_dtype=mu_dtype))
    state = eng.init_state(tree)
    jeng = jtrain.TrainEngine(jg.make_model(_jax_cfg(remat=remat))[0],
                              seq_len=T, optimizer=jtrain.default_optimizer(
                                  LR, grad_clip=CLIP, mu_dtype=mu_dtype))
    jstate = jeng.init_state(params=jax.tree_util.tree_map(
        jnp.asarray, _nest(tree)))
    losses, jlosses = [], []
    for i in range(STEPS):
        b = {k: v[i] for k, v in inputs.items()
             if k in ("input_ids", "segment_ids", "position_ids",
                      "loss_mask")}
        state, m = eng.train_step(state, eng.place_batch(b))
        jstate, jm = jeng.train_step(jstate, {k: jnp.asarray(v)
                                              for k, v in b.items()})
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    adam = jstate.opt_state[1][0]
    return {"losses": losses, "jlosses": jlosses, "state": state,
            "jparams": {k: np.asarray(v)
                        for k, v in _flat(jstate.params).items()},
            "jmu": {k: np.asarray(v.astype(jnp.float32))
                    for k, v in _flat(adam.mu).items()},
            "jmu_dtype": {str(v.dtype) for v in _flat(adam.mu).values()}}


def test_remat_engine_matches_jax_remat_engine(inputs):
    r = _single_device_runs(inputs, remat=True)
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-5)
    for k, v in r["state"].params.items():
        np.testing.assert_allclose(v.detach().numpy(), r["jparams"][k],
                                   atol=1e-5, err_msg=k)


def test_bf16_mu_update_is_optax_bit_for_bit():
    """The optimizer alone on the same gradients: three steps of
    ``optax.chain(clip_by_global_norm, adamw(mu_dtype=bfloat16))``
    (a binding clip) and the port's AdamW. mu is bf16 and equal bit for
    bit (optax's order: b1 mu in bf16, added to (1 - b1) g in f32, the
    bias correction from the f32 moment, rounded last); the parameters
    within 1e-6."""
    import optax

    from distributedtraining_tpu_torch.engine import train as ttrain
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s, dtype=np.float32)
         for k, s in (("a", (64, 48)), ("b", (48,)))}
    gs = [{k: rng.standard_normal(v.shape, dtype=np.float32) * 1e-2
           for k, v in p.items()} for _ in range(STEPS)]
    tx = jtrain.default_optimizer(LR, grad_clip=CLIP, mu_dtype="bfloat16")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jst = tx.init(jp)
    opt = ttrain.default_optimizer(LR, grad_clip=CLIP, mu_dtype="bfloat16")
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    st = opt.init(tp)
    for g in gs:
        u, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst,
                           jp)
        jp = optax.apply_updates(jp, u)
        opt.update_({k: torch.from_numpy(v) for k, v in g.items()}, st, tp)
    jmu = jst[1][0].mu
    for k in p:
        assert st.mu[k].dtype == torch.bfloat16 and jmu[k].dtype == \
            jnp.bfloat16
        np.testing.assert_array_equal(st.mu[k].float().numpy(),
                                      np.asarray(jmu[k].astype(jnp.float32)))
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)


def test_bf16_mu_engine_matches_optax_engine(inputs):
    """Three engine steps with ``mu_dtype="bfloat16"`` against JAX's: every
    mu leaf bf16, within one bf16 ulp of the leaf's largest magnitude a
    step (the gradients agree only to summation order, so each step's
    rounding to bf16 may fall on the other side once; a near-zero
    element's own ulp is far below that noise); losses within 1e-5
    relative and parameters within 1e-5, as the f32 engines."""
    r = _single_device_runs(inputs, mu_dtype="bfloat16")
    assert r["jmu_dtype"] == {"bfloat16"}
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-5)
    for k, v in r["state"].opt_state.mu.items():
        assert v.dtype == torch.bfloat16, k
        ref = r["jmu"][k]
        ulp = float(np.spacing(np.abs(ref).max())) * 2.0 ** 16
        np.testing.assert_allclose(v.float().numpy(), ref, rtol=0,
                                   atol=STEPS * ulp, err_msg=k)
        assert r["state"].opt_state.nu[k].dtype == torch.float32
    for k, v in r["state"].params.items():
        np.testing.assert_allclose(v.detach().numpy(), r["jparams"][k],
                                   atol=1e-5, err_msg=k)


def test_bf16_mu_survives_numpy_and_a_checkpoint(inputs, tmp_path):
    from distributedtraining_tpu_torch.checkpoint import (CheckpointStore,
                                                          Snapshot)
    from distributedtraining_tpu_torch.engine import train as ttrain
    tree = {k[2:]: v for k, v in inputs.items() if k.startswith("p/")}
    cfg = dataclasses.replace(tg.PRESETS["tiny"], **OVERRIDES)
    eng = ttrain.TrainEngine(tg.make_model(cfg)[0], device="cpu",
                             optimizer=ttrain.default_optimizer(
                                 mu_dtype="bfloat16"))
    state = eng.init_state(tree)
    state, _ = eng.train_step(state, eng.place_batch(
        {"input_ids": inputs["input_ids"][0]}))
    back = ttrain.opt_state_from_numpy(
        ttrain.opt_state_to_numpy(state.opt_state), device="cpu")
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save(1, Snapshot(state, None, "r0", 1))
    got = store.restore(Snapshot(state, None, None))
    for opt in (back, got.state.opt_state):
        for k, v in state.opt_state.mu.items():
            assert opt.mu[k].dtype == torch.bfloat16
            assert torch.equal(opt.mu[k], v), k
    store.close()


# ---------------------------------------------------------------------------
# dcn_dp: the layout and the auto pick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    {"dp": 4, "fsdp": 2}, {"dp": 2, "sp": 2, "tp": 2},
    {"dp": 8}, {"dp": 2, "fsdp": 4}], ids=lambda s: json.dumps(s))
def test_dcn_dp_layout_matches_jax_pod_mesh(devices, spec):
    """Rank r sits where JAX's single-process pod_mesh(dcn_dp=2) puts
    device r: the outer dp groups are contiguous halves of the ranks."""
    jm = jmh.pod_mesh(**spec, dcn_dp=2)
    cfg = tmh.pod_mesh_config(8, **spec, dcn_dp=2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert tuple(jm.devices.shape) == cfg.shape
    for rank, coords in _iter_coords(cfg):
        assert ids[tuple(coords[a] for a in tmesh.AXES)] == rank
        assert (coords["dp"] >= cfg.dp // 2) == (rank >= 4)


def test_dcn_dp_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="not divisible by dcn_dp"):
        tmh.pod_mesh_config(6, dp=3, fsdp=2, dcn_dp=2)
    # two nodes of four ranks: one granule a node
    assert tmh.pod_mesh_config(8, dcn_dp=2, nodes=2, node=1, rank=5).dp == 8
    with pytest.raises(ValueError, match="one granule a node"):
        tmh.pod_mesh_config(8, dcn_dp=2, nodes=4, node=2, rank=5)
    with pytest.raises(ValueError, match="one granule a node"):
        tmh.pod_mesh_config(8, dcn_dp=2, nodes=2, node=0, rank=5)


@pytest.mark.parametrize("n", [2, 8, 16])
def test_dcn_dp_auto_pick_matches_jax(n):
    for params in (0, 124 * 10**6, 7 * 10**9):
        kw = dict(n_devices=n, auto=True, model_params=params, dcn_dp=2)
        assert dataclasses.astuple(tmesh.resolve_mesh_config(**kw)) == \
            dataclasses.astuple(jmesh.resolve_mesh_config(**kw))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,mesh", [
    (["--sp", "2", "--remat", "--mu-dtype", "bfloat16"],
     {"dp": 1, "fsdp": 1, "sp": 2, "tp": 1}),
    (["--dp", "2", "--dcn-dp", "2"], {"dp": 2, "fsdp": 1, "sp": 1, "tp": 1})],
    ids=["sp2-remat-bf16mu", "dp2-dcn2"])
def test_two_process_miner_cli(tmp_path, flags, mesh):
    """Two ranks of the port's miner CLI: rc 0, the coordinator alone
    publishes, both ranks end on the same parameters, the delta on the
    wire is finite and nonzero, and the ranks' coordinates are the
    mesh's."""
    from test_torch_parallel import _delta_on_the_wire
    work = tmp_path / "work"
    base = _publish_tiny_base(work)
    io = tmp_path / "io"
    io.mkdir()
    outs = _run_world(io, "miner", {"dp": 2}, {},
                      {"argv": _strip_mesh(_miner_argv(
                          work, ["--max-steps", "2",
                                 "--checkpoint-interval", "0"])) + flags})
    assert [int(o["rc"]) for o in outs] == [0, 0]
    assert int(outs[0]["pushes"]) >= 1 and int(outs[1]["pushes"]) == 0
    coords = [json.loads(str(o["coords"])) for o in outs]
    assert [tmesh.rank_coords(r, tmesh.MeshConfig(**mesh))
            for r in range(2)] == coords
    for k in base:
        np.testing.assert_array_equal(outs[0][f"full/{k}"],
                                      outs[1][f"full/{k}"], err_msg=k)
    delta = _delta_on_the_wire(work)
    assert all(np.isfinite(np.asarray(d)).all() for d in delta.values())
    assert any(np.abs(np.asarray(d)).max() > 0 for d in delta.values())


def test_validator_and_averager_clis_at_sp2(tmp_path):
    """The validator and the averager as two processes on an sp2 mesh
    (the cohort spread over sp, its merge axis, as JAX spreads it): each
    rank exits 0, one ``set_weights`` and one publish, the
    coordinator's."""
    from test_torch_mesh_roles import _CLI, _cli_root, _run_cli
    work = _cli_root(tmp_path)
    common = _CLI + ["--work-dir", str(work), "--sp", "2"]
    for role, extra, count in (
            ("validator", ["--hotkey", "hotkey_91"], "set_weights"),
            ("averager", ["--hotkey", "hotkey_95", "--publish-policy",
                          "always", "--strategy", "weighted"],
             "publish_base")):
        rcs, outs, res = _run_cli(tmp_path / role, role, common + extra)
        assert rcs == [0, 0], "\n".join(outs)
        assert [r["counts"].get(count, 0) for r in res] == [1, 0]


def _strip_mesh(argv):
    """``_miner_argv``'s flags without its mesh flags."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--dp", "--fsdp"):
            skip = True
            continue
        out.append(a)
    return out


def test_dropout_keeps_its_refusal():
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    cfg = dataclasses.replace(tg.PRESETS["tiny"], dropout=0.1)
    with pytest.raises(NotImplementedError, match="dropout.*slice 7"):
        TrainEngine(tg.make_model(cfg)[0], device="cpu")


@pytest.mark.parametrize("role,extra", [
    ("miner", ["--sp", "2"]), ("miner", ["--dcn-dp", "2"]),
    ("miner", ["--remat"]), ("miner", ["--no-remat"]),
    ("miner", ["--mu-dtype", "bfloat16"]), ("validator", ["--sp", "2"]),
    ("averager", ["--sp", "2"])])
def test_config_takes_the_last_mesh_flags(role, extra):
    from distributedtraining_tpu_torch.config import RunConfig
    RunConfig.from_args(role, extra).check_ported()
    if "--remat" in extra or "--no-remat" in extra:
        assert RunConfig.from_args(role, extra).remat is ("--remat" in extra)
        assert RunConfig.from_args(role, []).remat is None


def test_remat_flag_reaches_the_model(tmp_path, monkeypatch):
    """``--remat`` / ``--no-remat`` set the model's remat, and no flag
    keeps the preset's value (JAX ``neurons/common.py:300-301``)."""
    from distributedtraining_tpu_torch.config import RunConfig
    from distributedtraining_tpu_torch.neurons import common
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    base = ["--work-dir", str(tmp_path), "--backend", "local", "--model",
            "tiny", "--dataset", "synthetic", "--flight-events", "0"]
    for extra, want in (([], False), (["--remat"], True),
                        (["--no-remat"], False)):
        c = common.build(RunConfig.from_args("miner", base + extra))
        assert c.model_cfg.remat is want and c.engine.model.cfg.remat is want
