"""LoRA adapters of the PyTorch port (models/lora.py, the adapter wire
tree in serialization.py, the frozen head of ops/fused_ce.py) against
the JAX package's ``models/lora.py`` and ``serialization.py``, on the
CPU.

The tiny presets of both families in f32; adapters made with numpy from
a seed (or drawn by both packages from one key). Tolerances: 1e-6 on
``apply_lora`` and ``lora_to_full_delta`` of the same adapters, 3 ulps
on ``init_lora``'s normals (ROADMAP §3: the port's ``prng.normal``),
exact bytes for the adapter artifacts, and the accept/refuse verdict of
``validated_load`` equal to JAX's for each hostile payload.
"""

import copy
import dataclasses

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu.engine import lora_train as jlt
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu.models import lora as jlora
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.engine import lora_train as tlt
from distributedtraining_tpu_torch.engine.train import _wire_template
from distributedtraining_tpu_torch.models import lora as tlora
from distributedtraining_tpu_torch.ops import fused_ce as tfce

FAMILIES = {"gpt2": ("tiny", jg), "llama": ("tiny-llama", jl)}
RANK = 4
CFG = tlora.LoRAConfig(rank=RANK, alpha=8.0)
JCFG = jlora.LoRAConfig(rank=RANK, alpha=8.0)


def _tree(family):
    preset, _ = FAMILIES[family]
    cfg = dataclasses.replace(models.family(preset).PRESETS[preset],
                              dtype="float32")
    return cfg, models.init_params_numpy(cfg, 0)


def _numpy_adapters(tree, seed):
    """Adapters with both factors nonzero, as JAX's state-dict tree."""
    rng = np.random.default_rng(seed)
    shapes = tlora.targets(tree, CFG)
    flat = {}
    for k, (fan_in, fan_out) in shapes.items():
        flat[k + ".a"] = (rng.standard_normal((fan_in, RANK)) * 0.3
                          ).astype(np.float32)
        flat[k + ".b"] = (rng.standard_normal((RANK, fan_out)) * 0.3
                          ).astype(np.float32)
    return tlora.adapters_to_numpy(
        {k: torch.from_numpy(v) for k, v in flat.items()}, tree)


def _jpairs(state_tree):
    """JAX's LoRAPair tree from its state-dict form."""
    def walk(node):
        if node is None:
            return None
        if set(node) == {"a", "b"}:
            return jlora.LoRAPair(a=jnp.asarray(node["a"]),
                                  b=jnp.asarray(node["b"]))
        return {k: walk(v) for k, v in node.items()}
    return walk(state_tree)


def _flat(tree):
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_is_target_matches_jax(family):
    """Every leaf's verdict equals JAX's: GPT-2 adapts ``c_attn`` and the
    attention ``c_proj`` (not ``c_fc`` or ``mlp_proj``), a Llama ``wq``,
    ``wk``, ``wv`` and ``wo`` (not the MLP)."""
    _, tree = _tree(family)
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ours = {k for k in tlora.targets(tree, CFG)}
    ref = {"/".join(jser.path_components(p)).replace("/", ".")
           for p, leaf in jflat if jlora.is_target(p, leaf, JCFG)}
    assert ours == ref and ours
    names = {k.split(".")[-2] for k in ours}
    assert names == ({"c_attn", "c_proj"} if family == "gpt2"
                     else {"wq", "wk", "wv", "wo"})
    # a bias or a 1-D leaf is not a target; the scan layout's 3-D
    # kernel [L, in, out] is, as in JAX; a 4-D leaf is not
    assert not tlora.is_target("h_0.c_attn.bias", np.zeros(8), CFG)
    for shape, want in (((2, 3, 4), True), ((2, 2, 3, 4), False)):
        path = [jax.tree_util.DictKey("h"), jax.tree_util.DictKey("block"),
                jax.tree_util.DictKey("c_attn"),
                jax.tree_util.DictKey("kernel")]
        assert jlora.is_target(path, np.zeros(shape), JCFG) is want
        assert tlora.is_target("h.block.c_attn.kernel", np.zeros(shape),
                               CFG) is want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_apply_lora_and_full_delta_match_jax(family):
    """On the same numpy adapters: zero-init identity, ``apply_lora`` and
    ``lora_to_full_delta`` within 1e-6 of JAX's, the host densify of the
    wire tree equal to the device one, and the adapter tree's JAX
    state-dict form round-tripping."""
    _, tree = _tree(family)
    np_ad = _numpy_adapters(tree, 1)
    ad = tlora.adapters_from_numpy(np_ad, device="cpu")
    base = models.params_from_numpy(tree, device="cpu")
    jbase = jax.tree_util.tree_map(jnp.asarray, tree)
    jad = _jpairs(np_ad)
    eff = tlora.apply_lora(base, ad, CFG)
    jeff = _flat(jlora.apply_lora(jbase, jad, JCFG))
    full = tlora.lora_to_full_delta(base, ad, CFG)
    jfull = _flat(jlora.lora_to_full_delta(jbase, jad, JCFG))
    assert set(eff) == set(jeff) == set(full) == set(jfull)
    for k in jeff:
        np.testing.assert_allclose(eff[k].numpy(), jeff[k], rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(full[k].numpy(), jfull[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    dense = tlora.densify_adapters(_wire_template(models.make_model(
        _tree(family)[0])[0]), np_ad, CFG)
    from distributedtraining_tpu_torch.delta import flatten_tree
    for k, v in flatten_tree(dense).items():
        np.testing.assert_allclose(v, jfull[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # zero-init (b = 0) is the identity
    zero = tlora.init_lora(0, base, CFG)
    for k, v in tlora.apply_lora(base, zero, CFG).items():
        assert torch.equal(v, base[k]), k
    back = tlora.adapters_to_numpy(ad, base)
    assert _flat(back).keys() == _flat(np_ad).keys()
    assert tlora.adapted_pairs(ad)[0][0].shape[1] == RANK


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_lora_matches_jax_from_the_same_key(family):
    """One key each for the flattened base leaves, in JAX's flatten
    order: ``a`` within 3 ulps of ``jax.random.normal * 0.02``, ``b``
    zero, every shape JAX's."""
    _, tree = _tree(family)
    jad = jlora.init_lora(jax.random.PRNGKey(7), tree, JCFG)
    ours = tlora.init_lora(7, tree, CFG)
    ref = _flat(fser.to_state_dict(jax.tree_util.tree_map(
        np.asarray, jad)))
    assert set(ours) == set(ref)
    for k, v in ours.items():
        r = ref[k]
        assert v.shape == r.shape, k
        if k.endswith(".b"):
            assert not r.any() and not v.any()
            continue
        ulp = np.spacing(np.abs(r).astype(np.float32))
        assert np.all(np.abs(v.numpy() - r) <= 3 * ulp), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_adapter_bytes_equal_jax(family):
    """The adapter artifact: ``to_msgpack`` of the wire tree (None at
    every unadapted leaf) is byte for byte JAX's ``to_msgpack`` of its
    ``LoRAPair`` tree, and it reads back through the adapter
    template."""
    cfg, tree = _tree(family)
    np_ad = _numpy_adapters(tree, 2)
    ours = tser.to_msgpack(np_ad)
    ref = jser.to_msgpack(_jpairs(np_ad))
    assert ours == ref
    # the miner's spelling: flat adapters with None entries, nested by
    # the publisher's host copy
    from distributedtraining_tpu_torch.engine.publish import host_materialize
    ad = tlora.adapters_from_numpy(np_ad, device="cpu")
    assert tser.to_msgpack(host_materialize(
        tlora.wire_adapters(ad, tree))) == ref
    tmpl = tlt.adapter_template(_wire_template(models.make_model(cfg)[0]),
                                CFG)
    back = tser.validated_load(ours, tmpl)
    assert _flat(back).keys() == _flat(np_ad).keys()


def _payloads(tree):
    np_ad = _numpy_adapters(tree, 3)
    sd = copy.deepcopy(np_ad)
    first = next(k for k in tlora.targets(tree, CFG))
    path = first.split(".")
    out = {}
    bad = copy.deepcopy(sd)
    leaf = next(k for k, v in _flat_none(sd).items() if v is None)
    _set(bad, leaf.split("."), np.ones((3, 3), np.float32))
    out["array_where_none"] = fser.msgpack_serialize(bad)
    bad = copy.deepcopy(sd)
    node = bad
    for p in path:
        node = node[p]
    del node["b"]
    out["missing_b"] = fser.msgpack_serialize(bad)
    wrong = dataclasses.replace(CFG, rank=RANK * 2)
    out["wrong_rank"] = tser.to_msgpack(tlora.adapters_to_numpy(
        tlora.init_lora(1, tree, wrong), tree))
    out["dense_to_adapter"] = tser.to_msgpack(tree)
    out["adapter_to_dense"] = tser.to_msgpack(np_ad)
    out["good"] = tser.to_msgpack(np_ad)
    return out


def _flat_none(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_none(v, path + (k,)))
        else:
            out[".".join(path + (k,))] = v
    return out


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _verdict(load, data, template) -> bool:
    try:
        load(data, template)
        return True
    except (tser.PayloadError, jser.PayloadError):
        return False


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("case", ["array_where_none", "missing_b",
                                  "wrong_rank", "dense_to_adapter",
                                  "adapter_to_dense", "good"])
def test_adapter_payload_verdicts_equal_jax(family, case):
    """``validated_load``'s accept/refuse verdict on an adapter template
    (or, for adapter bytes, the dense template) equals JAX's."""
    cfg, tree = _tree(family)
    data = _payloads(tree)[case]
    host = _wire_template(models.make_model(cfg)[0])
    jhost = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   tree)
    if case == "adapter_to_dense":
        t_tmpl, j_tmpl = host, jhost
    else:
        t_tmpl = tlt.adapter_template(host, CFG)
        j_tmpl = jlt.adapter_template(jhost, JCFG)
    ours = _verdict(tser.validated_load, data, t_tmpl)
    ref = _verdict(jser.validated_load, data, j_tmpl)
    assert ours == ref == (case == "good")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_head_ce_backward_returns_no_head_gradient(dtype):
    """A head that takes no gradient (a LoRA miner's frozen base head):
    the plain backward returns None for it and the same dh as the full
    backward; full-parameter training still gets dW."""
    g = torch.Generator().manual_seed(0)
    N, E, V = 24, 64, 300
    h = (torch.randn(N, E, generator=g) * 0.5).to(dtype)
    w = (torch.randn(V, E, generator=g) * 0.5).to(dtype)
    y = torch.randint(0, V, (N,), generator=g, dtype=torch.int32)
    hf, hl = h.clone().requires_grad_(), h.clone().requires_grad_()
    wf = w.clone().requires_grad_()
    full = tfce._PerTokenCE.apply(hf, wf, y).sum()
    frozen = tfce._PerTokenCE.apply(hl, w, y).sum()
    dh_full, dw_full = torch.autograd.grad(full, (hf, wf))
    (dh_frozen,) = torch.autograd.grad(frozen, (hl,))
    assert torch.equal(dh_full, dh_frozen)
    assert dw_full.shape == (V, E)
    loss, m, s = tfce.fused_ce_fwd_reference(h, w, y)
    ones = torch.ones(N)
    dh, dw = tfce.fused_ce_bwd_reference(h, w, y, m, s, ones,
                                         want_dw=False)
    assert dw is None and torch.equal(dh, dh_frozen)
