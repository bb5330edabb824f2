"""Load generation of the PyTorch port (utils/loadgen.py) against the JAX
package's, on the CPU.

The submission flood draws the same arrays from the same ``rng`` (benign
and each tree-level poison), and a seeded ``LoadGenerator`` publishes
the same artifact bytes, hostile ones included. The open-loop runners
count virtual time, so on the same tiny f32 model and spec the port's
engines and the JAX package's give equal load points: one engine (also
under page pressure), two behind the router policy, and a prefill engine
handing off to a decode engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import kv_transfer as jkvt
from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.utils import loadgen as jload
from distributedtraining_tpu_torch.engine import kv_transfer as kvt
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import InMemoryTransport
from distributedtraining_tpu_torch.utils import loadgen as tload

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [
    dict(rate_rps=50.0, duration_s=20.0, seed=3),
    dict(rate_rps=400.0, duration_s=0.12, seed=3, max_prompt_tokens=12),
    dict(rate_rps=3.0, duration_s=4.0, seed=11, min_prompt_tokens=8,
         max_prompt_tokens=900, tail_alpha=0.9, vocab=50257),
])
def test_sample_arrivals_equal_jax(spec):
    ours = tload.sample_arrivals(tload.OpenLoopSpec(**spec))
    assert ours == jload.sample_arrivals(jload.OpenLoopSpec(**spec))
    assert ours
    with pytest.raises(ValueError):
        tload.OpenLoopSpec(rate_rps=0.0)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _template():
    model, _ = tg.make_model(TINY)
    return tserve.host_param_template(model)


@pytest.mark.parametrize("mode", ["benign", "nan", "shape", "huge"])
def test_tree_deltas_equal_jax(mode):
    """The same rng state draws the same leaves, visited in the same
    (sorted) order; a poison lands in the same first leaf."""
    template = _template()
    jtemplate = jax.tree_util.tree_map(np.asarray, template)
    rngs = [np.random.default_rng(4), np.random.default_rng(4)]
    if mode == "benign":
        ours = tload.benign_delta(template, rngs[0], 2e-3)
        theirs = jload.benign_delta(jtemplate, rngs[1], 2e-3)
    else:
        ours = tload.poisoned_delta(template, mode, rngs[0])
        theirs = jload.poisoned_delta(jtemplate, mode, rngs[1])
    a, b = _flat(ours), _flat(theirs)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        tload.poisoned_delta(template, "garbage", rngs[0])


def test_load_generator_publishes_jax_bytes():
    """A seeded round publishes, identity by identity, the JAX
    generator's artifact bytes (the hotkeys are fresh keys on each
    side)."""
    template = _template()
    ours_t, theirs_t = InMemoryTransport(), JMem()
    ours = tload.LoadGenerator(ours_t, template, n_miners=6,
                               poison_fraction=0.5, seed=7)
    theirs = jload.LoadGenerator(
        theirs_t, jax.tree_util.tree_map(np.asarray, template),
        n_miners=6, poison_fraction=0.5, seed=7)
    rep = ours.publish_round()
    jrep = theirs.publish_round()
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.by_mode == {"nan": 1, "shape": 1, "huge": 1}
    assert [ours_t._deltas[h] for h in ours.hotkeys()] == \
        [theirs_t._deltas[h] for h in theirs.hotkeys()]
    assert len(set(ours.hotkeys())) == 6


# ---------------------------------------------------------------------------
# Open-loop load points against the JAX engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    tree = tg.init_params_numpy(TINY, 0)
    jmodel, _ = jg.make_model(JTINY)
    tmodel, _ = tg.make_model(TINY)
    return {"tmodel": tmodel, "jmodel": jmodel,
            "state": tg.params_from_numpy(tree, device="cpu"),
            "jparams": jax.tree_util.tree_map(jnp.asarray, tree)}


def _engines(world, pkg, n=1, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("revision", "r0")
    if pkg == "torch":
        return [tserve.GenerationEngine(world["tmodel"], world["state"],
                                        device="cpu", trace=False, **kw)
                for _ in range(n)]
    return [jserve.GenerationEngine(world["jmodel"], world["jparams"],
                                    trace=False, **kw) for _ in range(n)]


SPEC = dict(rate_rps=60.0, duration_s=0.4, seed=5, max_new_tokens=6,
            max_prompt_tokens=30)


@pytest.mark.parametrize("busy", [0, 3])
def test_open_loop_load_point_equals_jax(world, busy):
    pts = []
    for pkg, mod in (("torch", tload), ("jax", jload)):
        # a pool short of two full slots: preemption is on the path
        (eng,) = _engines(world, pkg, max_seq_len=48, pool_pages=10)
        try:
            pts.append(mod.run_open_loop(eng, mod.OpenLoopSpec(**SPEC),
                                         prefill_busy_steps=busy))
        finally:
            eng.close()
    assert pts[0] == pts[1]
    assert pts[0]["completed"] == pts[0]["offered"] > 0


def test_routed_load_point_equals_jax(world):
    pts = []
    spec = dict(SPEC, rate_rps=400.0, duration_s=0.1)
    for pkg, mod in (("torch", tload), ("jax", jload)):
        engines = _engines(world, pkg, n=2)
        try:
            pts.append(mod.run_open_loop_routed(
                engines, mod.OpenLoopSpec(**spec), max_backend_queue=2))
        finally:
            for e in engines:
                e.close()
    assert pts[0] == pts[1]
    assert pts[0]["shed"] > 0 and pts[0]["completed"] == pts[0]["routed"]


def test_disagg_load_point_equals_jax(world):
    pts = []
    for pkg, mod, kv, tr in (("torch", tload, kvt, InMemoryTransport()),
                             ("jax", jload, jkvt, JMem())):
        (pe,) = _engines(world, pkg, phase="prefill",
                         kv_exporter=kv.KVExporter(tr))
        (de,) = _engines(world, pkg, phase="decode",
                         kv_adopter=kv.KVAdopter(tr))
        try:
            pts.append(mod.run_open_loop_disagg(
                [pe], [de], mod.OpenLoopSpec(**SPEC), prefill_busy_steps=2))
        finally:
            pe.close()
            de.close()
    assert pts[0] == pts[1]
    p = pts[0]
    assert p["handoffs"] == p["kv_adopted"] == p["completed"] > 0
    assert p["kv_reprefills"] == 0
