"""The tensor-parallel blocks of the PyTorch port (Megatron style: each tp
rank computes H/tp heads and 4E/tp MLP columns from its own storage
chunks; parallel/sharding.block_param, models/gpt2.Block's tp forward)
against the JAX package's TrainEngine on the same mesh, on the CPU.

JAX runs on the 8 host devices of tests/conftest.py; the port runs one
process per device over gloo (tests/torch_parallel_worker.py, case
"tp"). One world a mesh serves every case of that mesh: tp 2 and
fsdp 2 x tp 2 split the heads, tp 4 with n_head 2 keeps the attention on
gathered parameters (tp does not divide the heads) and splits the MLP.
Inputs are made with numpy from a seed; tiny preset widened to E 128,
f32, B 4, T 16. Tolerances: three AdamW steps with a binding clip, losses
1e-5 relative, parameters, Adam's mu and the gathered tree 1e-5 a shard
element; the c_attn head permutation, tp peers' gradients of the
replicated leaves and the collectives' counts exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.parallel import MeshConfig as JMeshConfig
from distributedtraining_tpu.parallel import make_mesh
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.parallel import mesh as tmesh
from distributedtraining_tpu_torch.parallel import sharding as tsh
from test_torch_parallel import _flat, _iter_coords, _run_world

STEPS, B, T = 3, 4, 16
LR, CLIP = 1e-3, 0.05
MESHES = {
    "tp2": ((1, 1, 1, 2), 4, "head_split"),
    "fsdp2xtp2": ((1, 2, 1, 2), 4, "head_split"),
    "tp4-gathered-attn": ((1, 1, 1, 4), 2, "gathered_attn"),
}
# replicated over tp: every spec without "tp"
REPLICATED = ("wpe", "ln_1", "ln_2", "ln_f", "c_proj.bias", "mlp_proj.bias")


def _overrides(n_head):
    return {"dtype": "float32", "n_embd": 128, "n_head": n_head}


def _qkv_cols(t, n, E):
    """The c_attn columns tp rank t of n computes: its q, k and v heads."""
    per = E // n
    return np.concatenate([j * E + np.arange(t * per, (t + 1) * per)
                           for j in range(3)])


def _jax_engine_run(shape, n_head, tree, ids):
    jcfg = dataclasses.replace(jg.PRESETS["tiny"], **_overrides(n_head))
    jmodel, _ = jg.make_model(jcfg)
    jeng = jtrain.TrainEngine(jmodel, mesh=make_mesh(JMeshConfig(*shape)),
                              seq_len=T, fused_loss="scan",
                              optimizer=jtrain.default_optimizer(
                                  LR, grad_clip=CLIP))
    state = jeng.init_state(params=jax.tree_util.tree_map(jnp.asarray,
                                                          tree))
    losses = []
    for i in range(STEPS):
        state, m = jeng.train_step(state, jeng.place_batch(
            {"input_ids": jnp.asarray(ids[i])}))
        losses.append(float(m["loss"]))
    g0 = jax.jit(jax.grad(lambda p: jtrain._fused_lm_loss(
        jmodel, p, {"input_ids": jnp.asarray(ids[0])}, impl="scan")[0]))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    norm0 = float(jnp.sqrt(sum(jnp.sum(x * x) for x in
                               jax.tree_util.tree_leaves(g0))))
    return {"losses": losses, "norm0": norm0,
            "params": {k: np.asarray(v)
                       for k, v in _flat(state.params).items()},
            "mu": {k: np.asarray(v)
                   for k, v in _flat(state.opt_state[1][0].mu).items()}}


@pytest.fixture(scope="module", params=list(MESHES))
def world(request, devices, tmp_path_factory):
    """One gloo world of the mesh running case "tp", and the JAX run it
    is held against."""
    name = request.param
    shape, n_head, route = MESHES[name]
    cfg = dataclasses.replace(tg.PRESETS["tiny"], **_overrides(n_head))
    tree = tg.init_params_numpy(cfg, 0)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (STEPS, B, T)).astype(np.int32)
    E = cfg.n_embd
    qkv = {"qkv/kernel": rng.standard_normal((E, 3 * E)).astype(np.float32),
           "qkv/bias": rng.standard_normal((3 * E,)).astype(np.float32)}
    mesh = dict(zip(tmesh.AXES, shape))
    outs = _run_world(tmp_path_factory.mktemp(name), "tp", mesh,
                      {"input_ids": ids, **qkv,
                       **{f"p/{k}": v for k, v in _flat(tree).items()}},
                      {"preset": "tiny", "fused": True, "accum": 1,
                       "lr": LR, "grad_clip": CLIP,
                       "overrides": _overrides(n_head)})
    return {"name": name, "shape": shape, "route": route, "cfg": cfg,
            "mesh": mesh, "outs": outs, "qkv": qkv,
            "jax": _jax_engine_run(shape, n_head, tree, ids)}


def test_tp_block_route_is_a_rule_of_shapes():
    class _M:
        def __init__(self, tp):
            self.shape = {"dp": 1, "fsdp": 2, "sp": 1, "tp": tp}

        size = tmesh.Mesh.size

    assert tsh.tp_block_route(12, _M(1)) is None
    assert tsh.tp_block_route(12, _M(2)) == "head_split"
    assert tsh.tp_block_route(12, _M(4)) == "head_split"
    assert tsh.tp_block_route(25, _M(2)) == "gathered_attn"   # gpt2-1.5b
    assert tsh.tp_block_route(2, _M(4)) == "gathered_attn"


def test_tp_engine_matches_jax_engine(world):
    """Three AdamW steps with a binding --grad-clip against JAX's
    TrainEngine on the same mesh, and every block took the mesh's
    route."""
    ref = world["jax"]
    assert ref["norm0"] > CLIP          # the clip binds
    specs = tsh.param_specs(ref["params"])
    L = world["cfg"].n_layer
    for rank, coords in _iter_coords(tmesh.MeshConfig(*world["shape"])):
        o = world["outs"][rank]
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        assert list(o["tokens"]) == [float(B * (T - 1))] * STEPS
        for route in ("head_split", "gathered_attn"):
            want = STEPS * L if route == world["route"] else 0
            assert int(o[f"routes/tp_{route}_blocks"]) == want, route
        for k, full in ref["params"].items():
            sl = tsh.shard_slices(k, full.shape, specs[k], world["mesh"],
                                  coords)
            np.testing.assert_allclose(o[f"p/{k}"], full[sl], atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
            np.testing.assert_allclose(o[f"mu/{k}"], ref["mu"][k][sl],
                                       atol=1e-5,
                                       err_msg=f"rank {rank} mu {k}")
            np.testing.assert_allclose(o[f"full/{k}"], full, atol=1e-5,
                                       err_msg=f"rank {rank} gathered {k}")


def test_c_attn_head_permutation_and_its_backward(world):
    """gather_heads against a numpy index map: each rank gets its heads'
    q, k and v columns of the whole leaf; the backward of a cotangent of
    (rank + 1) times the output gives each storage column the gradient
    of the one tp rank that computed it, summed over the peers of the
    axes the leaf is split on (the kernel's fsdp peers; the bias, split
    on tp alone, leaves the sum over fsdp to the engine)."""
    shape, mesh = world["shape"], world["mesh"]
    n = mesh["tp"]
    coords_of = dict(_iter_coords(tmesh.MeshConfig(*shape)))
    for name, spec in (("kernel", ("fsdp", "tp")), ("bias", ("tp",))):
        full = world["qkv"][f"qkv/{name}"]
        E = full.shape[-1] // 3
        split = tsh.spec_axes(spec)
        for rank, coords in coords_of.items():
            cols = _qkv_cols(coords["tp"], n, E)
            np.testing.assert_array_equal(
                world["outs"][rank][f"heads/{name}"], full[..., cols],
                err_msg=f"rank {rank} {name}")
            g_full = np.zeros_like(full)
            for r2, c2 in coords_of.items():
                if all(c2[a] == coords[a] for a in tmesh.AXES
                       if a not in split):
                    cols2 = _qkv_cols(c2["tp"], n, E)
                    g_full[..., cols2] += (r2 + 1) * full[..., cols2]
            sl = tsh.shard_slices(name, full.shape, spec, mesh, coords)
            np.testing.assert_allclose(
                world["outs"][rank][f"heads_grad/{name}"], g_full[sl],
                rtol=1e-6, err_msg=f"rank {rank} {name}")


def test_tp_replicated_leaves_get_bit_equal_gradients_on_tp_peers(world):
    """The LayerNorms, wpe and the two output biases are replicated over
    tp: copy_to's backward completes the residual's cotangent, so their
    raw gradients (before any sum) are bit-equal on tp peers."""
    outs = world["outs"]
    peers: dict = {}
    for rank, coords in _iter_coords(tmesh.MeshConfig(*world["shape"])):
        peers.setdefault((coords["dp"], coords["fsdp"]), []).append(rank)
    keys = [k for k in outs[0] if k.startswith("grad/")
            and any(r in k for r in REPLICATED)]
    assert len(keys) == 6 * world["cfg"].n_layer + 3
    for ranks in peers.values():
        assert len(ranks) == world["mesh"]["tp"]
        for k in keys:
            for r in ranks[1:]:
                np.testing.assert_array_equal(outs[r][k], outs[ranks[0]][k],
                                              err_msg=f"rank {r} {k}")
                assert np.any(outs[r][k] != 0), k


@pytest.mark.parametrize("world", ["tp2"], indirect=True)
def test_tp2_step_counts_are_exact(world):
    """One fused step at tp 2 (L blocks): tp all-gathers only wte (the
    embedding and the CE's head) and each block's c_attn kernel and bias
    (the kernel again in the backward); no gather of c_proj, c_fc or
    mlp_proj. Per block, two all-reduces of [B, T, E] forward (g) and two
    backward (f); each c_attn leaf reduce-scattered once."""
    cfg = world["cfg"]
    L, E, V, R, f32 = cfg.n_layer, cfg.n_embd, cfg.padded_vocab, B * T, 4
    qkv = 3 * E * E + 3 * E
    want = {
        "all_gather": (3 * L + 2, f32 * (2 * V * E + L * (qkv + 3 * E * E))),
        # 4L block activations, the CE's dh and its three scalars
        # (total, count) and the clip's sum of squares over tp
        "all_reduce": (4 * L + 4, f32 * ((4 * L + 1) * R * E + 3)),
        "reduce_scatter": (2 * L + 1, f32 * (L * qkv + V * E)),
    }
    for rank, o in enumerate(world["outs"]):
        got = {op: (int(o[f"coll/{op}/gloo/direct/calls"]),
                    int(o[f"coll/{op}/gloo/direct/bytes"])) for op in want}
        assert got == want, f"rank {rank}"
        assert {k[len("count/"):]: int(v) for k, v in o.items()
                if k.startswith("count/")} == {
            "tp_head_split_blocks": L, "tp_gathered_attn_blocks": 0,
            "saved_as_shard": L, "regathered": L}, f"rank {rank}"
