"""Serving engine of the PyTorch port (distributedtraining_tpu_torch/engine
/serve.py) against the JAX package's, on the CPU.

The spine is token identity: on the tiny f32 model, with the same
weights, the port's greedy GenerationEngine emits exactly the tokens of
the JAX GenerationEngine and of the JAX ``reference_generate`` oracle —
across page boundaries, with more requests than slots (continuous
batching), under pool pressure (preemption) and across drain/restart hot
swaps. Also here: the scheduler's bookkeeping classes against the JAX
ones, the HTTP frontend, the explicit refusal of what the slice does not
carry, and the port's isolation from JAX.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.utils import obs

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_PKG = REPO / "distributedtraining_tpu_torch"

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside timing-sensitive JAX
    tests; these tiny shapes need no intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharpened_tree(cfg, seed):
    """JAX init distributions with dense kernels and positions scaled
    x10: generations then depend on the context (at the init scale a
    random GPT-2 mostly repeats its last token)."""
    tree = tg.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


class World:
    """Two weight sets, in both packages, plus cached JAX oracles."""

    def __init__(self):
        self.jmodel, _ = jg.make_model(JTINY)
        self.tmodel, _ = tg.make_model(TINY)
        self.trees = [sharpened_tree(TINY, 0), sharpened_tree(TINY, 7)]
        self.jparams = [jax.tree_util.tree_map(jnp.asarray, t)
                        for t in self.trees]
        self.states = [tg.params_from_numpy(t, device="cpu")
                       for t in self.trees]
        rng = np.random.RandomState(0)
        # P = 8: prompts straddle page boundaries (8, 16 exactly; 9, 17
        # one past)
        self.prompts = [[int(t) for t in rng.randint(0, TINY.vocab_size,
                                                     size=n)]
                        for n in (5, 9, 16, 17, 3)]
        self._refs = {}

    def refs(self, which, prompts, n=GEN):
        out = []
        for p in prompts:
            key = (which, tuple(p), n)
            if key not in self._refs:
                self._refs[key] = jserve.reference_generate(
                    self.jmodel, self.jparams[which], p, n)
            out.append(self._refs[key])
        return out

    def engine(self, which=0, **kw):
        kw.setdefault("max_slots", 2)
        kw.setdefault("page_size", 8)
        return tserve.GenerationEngine(self.tmodel, self.states[which],
                                       device="cpu", debug_invariants=True,
                                       **kw)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.fixture()
def metrics():
    obs.configure()
    try:
        yield obs.registry()
    finally:
        obs.reset()


# ---------------------------------------------------------------------------
# Token identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stop", ["length", "eos"])
def test_generate_matches_jax_engine_and_oracle(world, stop):
    """Five ragged prompts on two slots (continuous batching): the port
    emits exactly what the JAX engine and the JAX oracle emit. With an
    ``eos_id`` that the oracle emits mid-sequence, the requests that
    reach it stop there, in both engines and both oracles."""
    eos = None
    if stop == "eos":
        eos = world.refs(0, world.prompts[:1])[0][GEN // 2]
    jeng = jserve.GenerationEngine(world.jmodel, world.jparams[0],
                                   max_slots=2, page_size=8, eos_id=eos)
    try:
        jout = jeng.generate(world.prompts, GEN)
    finally:
        jeng.close()
    eng = world.engine(eos_id=eos)
    try:
        out = eng.generate(world.prompts, GEN)
        assert eng.tokens_emitted == sum(map(len, out))
    finally:
        eng.close()
    assert out == jout
    assert any(len(set(o)) > 2 for o in out), "degenerate generations"
    if eos is None:
        assert out == world.refs(0, world.prompts)
        assert all(len(o) == GEN for o in out)
        return
    refs = [jserve.reference_generate(world.jmodel, world.jparams[0], p, GEN,
                                      eos_id=eos) for p in world.prompts]
    ours = [tserve.reference_generate(world.tmodel, world.states[0], p, GEN,
                                      eos_id=eos) for p in world.prompts]
    assert out == refs == ours
    assert 0 < len(out[0]) < GEN and out[0][-1] == eos


def test_reference_generate_matches_jax(world):
    ours = [tserve.reference_generate(world.tmodel, world.states[0], p, GEN)
            for p in world.prompts[:2]]
    assert ours == world.refs(0, world.prompts[:2])


@pytest.mark.parametrize("page_size", [4, 16])
def test_page_size_does_not_change_tokens(world, page_size):
    """Paging is a memory layout: small pages (many per sequence) and a
    page that holds a whole prompt give the oracle's tokens."""
    eng = world.engine(page_size=page_size, max_slots=3)
    try:
        assert eng.generate(world.prompts, GEN) == world.refs(
            0, world.prompts)
    finally:
        eng.close()


def test_preemption_under_page_pressure(world, metrics):
    """An undersized pool forces preemption; preempted requests requeue
    and regenerate identically."""
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(0, TINY.vocab_size, size=10)]
               for _ in range(3)]
    eng = world.engine(max_seq_len=32, pool_pages=6)
    try:
        assert eng.generate(prompts, 16) == world.refs(0, prompts, 16)
        assert metrics.counter("serve.preempted").value >= 1
        assert eng.pool.free == eng.pool.total
    finally:
        eng.close()


class StubWatcher:
    """Hands the engine one staged (revision, state) when armed."""

    def __init__(self):
        self.staged = None
        self.closed = False

    def take_pending(self):
        staged, self.staged = self.staged, None
        return staged

    def close(self):
        self.closed = True


@pytest.mark.parametrize("policy", ["drain", "restart"])
def test_hot_swap_matches_jax(world, policy, metrics):
    """A stages a new revision mid-stream of request A, then B arrives.
    drain: A finishes on r1, B decodes on r2. restart: A regenerates on
    r2 from its prompt. Tokens are the JAX oracle's under the revision
    that produced them, and each request is stamped with it."""
    watcher = StubWatcher()
    eng = world.engine(revision="r1", swap_policy=policy, watcher=watcher)
    try:
        ra = eng.submit(world.prompts[0], GEN)
        for _ in range(3):
            eng.step()
        assert 0 < len(ra.tokens) < GEN
        watcher.staged = ("r2", world.states[1])
        rb = eng.submit(world.prompts[1], GEN)
        while not (ra.done_evt.is_set() and rb.done_evt.is_set()):
            eng.step()
        a_rev = "r1" if policy == "drain" else "r2"
        assert ra.revision == a_rev
        assert [ra.tokens] == world.refs(int(a_rev == "r2"),
                                         world.prompts[:1])
        assert rb.revision == "r2"
        assert [rb.tokens] == world.refs(1, world.prompts[1:2])
        assert metrics.counter("serve.swaps").value == 1
    finally:
        eng.close()
    assert watcher.closed


# ---------------------------------------------------------------------------
# Scheduler bookkeeping vs the JAX classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top", [1, 5, 8, 64])
def test_bucket_ladder_matches_jax(top):
    """The port's ladder is the JAX ladder's exact fit (the JAX engine's
    pad-up to already-compiled buckets has nothing to reuse in eager
    PyTorch)."""
    ours = tserve.BucketLadder(top)
    ref = jserve.BucketLadder(top, prefer_compiled=False)
    assert ours.buckets == ref.buckets
    for n in (1, 2, 3, 5, 8, 9, 33, 64, 65, 130):
        assert ours.bucket_for(n) == ref.bucket_for(n), n
    with pytest.raises(ValueError):
        ours.bucket_for(0)


def test_page_pool_matches_jax():
    ours, ref = tserve.PagePool(9), jserve.PagePool(9)
    ops = [("alloc", 3), ("alloc", 2), ("incref", 2), ("decref", 1),
           ("alloc", 4), ("decref", 2), ("decref", 2), ("alloc", 1),
           ("decref", 5), ("alloc", 3)]
    for op, arg in ops:
        got = [getattr(pool, op)(arg) for pool in (ours, ref)]
        assert got[0] == got[1], (op, arg)
        assert ours.free == ref.free
        assert [ours.refs(p) for p in range(9)] == \
            [ref.refs(p) for p in range(9)]
    ours.check()
    with pytest.raises(AssertionError, match="drift"):
        ours.check({1: 5})


def test_admission_state_sheds_and_drains(world):
    """Queue at max_queue -> shed (429); a staged drain-policy swap with
    sequences in flight -> drain (503); both with a Retry-After in
    [1, 30] s."""
    watcher = StubWatcher()
    eng = world.engine(max_queue=1, watcher=watcher)
    try:
        assert eng.admission_state() == ("ok", 0.0)
        eng.submit(world.prompts[0], GEN)
        state, retry = eng.admission_state()
        assert state == "shed" and 1.0 <= retry <= 30.0
        eng.step()                                  # admitted, in flight
        watcher.staged = ("r2", world.states[1])
        eng.step()                                  # swap staged, draining
        state, retry = eng.admission_state()
        assert state == "drain" and 1.0 <= retry <= 30.0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# HTTP frontend + serve loop
# ---------------------------------------------------------------------------

def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_round_trip(world):
    eng = world.engine(revision="r1")
    loop = tserve.ServeLoop(eng, idle_poll_s=0.02).start()
    fe = tserve.ServeHTTPFrontend(eng, 0, timeout_s=60.0)
    port = fe.start()
    try:
        assert fe in tserve.live_frontends()
        out = _post(port, {"tokens": world.prompts[2], "max_new_tokens": GEN})
        assert out["tokens"] == world.refs(0, world.prompts[2:3])[0]
        assert out["status"] == "done" and out["revision"] == "r1"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            hz = json.loads(resp.read())
        assert hz["ok"] and hz["revision"] == "r1" and hz["active"] == 0
        for bad in ({"tokens": []},
                    {"tokens": [1, 2], "temperature": 0.7}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, bad)
            assert ei.value.code == 400
    finally:
        fe.close()
        loop.close()
        eng.close()
    assert not fe.running and fe not in tserve.live_frontends()


# ---------------------------------------------------------------------------
# What the slice does not carry is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"prefix_cache": True}, {"draft": object()},
                                {"phase": "decode"}, {"trace": True}])
def test_unported_engine_options_raise(world, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        world.engine(**kw)


def test_sampling_and_transport_watcher_raise(world):
    eng = world.engine()
    try:
        with pytest.raises(NotImplementedError, match="sampled"):
            eng.submit([1, 2, 3], 4, temperature=0.5)
        with pytest.raises(ValueError):
            eng.submit([])
    finally:
        eng.close()
    with pytest.raises(NotImplementedError, match="transport"):
        tserve.BaseRevisionWatcher(None, lambda: None)


def test_cuda_is_not_silently_replaced_by_the_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.GenerationEngine(world.tmodel, world.states[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.params_from_numpy(world.trees[0])


# ---------------------------------------------------------------------------
# Isolation: the port never imports JAX or the JAX package
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "ml_dtypes", "distributedtraining_tpu")


def test_port_sources_import_no_jax():
    bad = []
    files = sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert len(files) > 8 and not bad, bad


def test_port_serving_path_loads_without_jax():
    code = ("import sys\n"
            "import distributedtraining_tpu_torch.engine.serve\n"
            "import distributedtraining_tpu_torch.models.gpt2\n"
            "import distributedtraining_tpu_torch.ops.paged_attention\n"
            "import distributedtraining_tpu_torch.neurons.miner\n"
            "import distributedtraining_tpu_torch.ops.fused_ce\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
