"""The miner's round of the PyTorch port (engine/train.py TrainEngine with
``fused_loss=True`` and MinerLoop, engine/publish.py, transport/,
neurons/miner.py) against the JAX package, on the CPU.

- The fused-loss training step against the JAX engine's Pallas fused
  loss (interpret mode) and the port's unfused step: 3 steps, losses
  within 5e-4 relative (the JAX package's own limit,
  tests/test_fused_loss.py).
- MinerLoop against the JAX MinerLoop on the same FakeClock schedule, the
  same batches and the same published bases: push and pull counts, the
  optimizer reset on a pull (or kept), the self-eval guard's revert, the
  NaN guard refusing a push; and sync vs async publishes byte-identical.
- A mixed round over one LocalFSTransport root in both directions: a JAX
  base pulled by the port's miner, the port's delta fetched, screened and
  scored by the JAX package (scores within 1e-5 relative), and the
  port's ``neurons.miner.main`` run with ``DT_FORCE_PLATFORM=cpu``.

f32 tiny GPT-2 on both sides, weights from numpy with a seed.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdelta
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.scheduler import FakeClock as JFakeClock
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import serialization as tser
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Two bases, 12 packed train batches, 2 held-out batches and one
    JAX engine (one set of compiled programs for every JAX loop)."""
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(12)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    jmodel, _ = jg.make_model(JTINY)
    return {"bases": [tg.init_params_numpy(TINY, s) for s in (0, 1)],
            "train": train, "val": val,
            "jeng": jtrain.TrainEngine(jmodel), "jmodel": jmodel}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# The fused-loss step
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:pallas fused-CE")
def test_fused_step_matches_jax_pallas_and_unfused(world):
    tree, batches = world["bases"][0], world["train"][:3]
    jpal = jtrain.TrainEngine(world["jmodel"], fused_loss="pallas")
    model, _ = tg.make_model(TINY)
    fused = ttrain.TrainEngine(model, fused_loss=True, device="cpu")
    plain = ttrain.TrainEngine(model, device="cpu")
    start = tg.params_from_numpy(tree, device="cpu")
    s_j = jpal.init_state(params=_jtree(tree))
    s_f, s_p = fused.init_state(start), plain.init_state(start)
    for b in batches:
        s_j, m_j = jpal.train_step(s_j, b)
        s_f, m_f = fused.train_step(s_f, fused.place_batch(b))
        s_p, m_p = plain.train_step(s_p, plain.place_batch(b))
        np.testing.assert_allclose(float(m_f["loss"]), float(m_j["loss"]),
                                   rtol=5e-4)
        np.testing.assert_allclose(float(m_f["loss"]), float(m_p["loss"]),
                                   rtol=5e-4)
        assert float(m_f["tokens"]) == float(m_j["tokens"])
    # eval goes through the same loss
    np.testing.assert_allclose(fused.evaluate(s_f.params, world["val"])[0],
                               plain.evaluate(s_f.params, world["val"])[0],
                               rtol=1e-5)


def test_default_optimizer_takes_the_miner_flags():
    opt = ttrain.default_optimizer(1e-3, weight_decay=0.1, grad_clip=1.0)
    assert (opt.lr, opt.weight_decay, opt.grad_clip) == (1e-3, 0.1, 1.0)


# ---------------------------------------------------------------------------
# MinerLoop against the JAX MinerLoop
# ---------------------------------------------------------------------------

def _schedule(loop, batches, publish_second, second_at=5):
    """Batches on a clock that advances 1 s each; the second base is
    published just before batch ``second_at``."""
    for i, b in enumerate(batches):
        if i == second_at and publish_second is not None:
            publish_second()
        loop.clock.sleep(1.0)
        yield b


def _run_pair(world, *, keep_optimizer_on_pull=False, push_async=False,
              val=False, bases=None, steps=10, **kw):
    """The same round through the port's and the JAX package's loop:
    base 0 published before boot, base 1 mid-run."""
    bases = bases or world["bases"]
    model, _ = tg.make_model(TINY)
    eng = ttrain.TrainEngine(model, device="cpu")
    loops = []
    for side in ("port", "jax"):
        if side == "port":
            t = InMemoryTransport()
            mk = lambda tr: ttrain.MinerLoop(eng, tr, "m0", clock=FakeClock(),
                                             **kw_loop)
        else:
            t = JMem()
            mk = lambda tr: jtrain.MinerLoop(world["jeng"], tr, "m0",
                                             clock=JFakeClock(), **kw_loop)
        kw_loop = dict(send_interval=4.0, check_update_interval=3.0,
                       log_every=10**9,
                       keep_optimizer_on_pull=keep_optimizer_on_pull,
                       push_async=push_async, **kw)
        if val:
            kw_loop.update(val_batches=lambda: world["val"],
                           val_guard_interval=2.0, val_guard_patience=2,
                           val_guard_margin=0.1)
        t.publish_base(bases[0] if side == "port" else _jtree(bases[0]))
        loop = mk(t)
        if side == "port":
            loop.bootstrap()
        else:
            loop.bootstrap(jax.random.PRNGKey(0))
        second = (lambda t=t, side=side: t.publish_base(
            bases[1] if side == "port" else _jtree(bases[1])))
        loop.run(_schedule(loop, world["train"][:steps], second),
                 max_steps=steps)
        loop.flush()
        loops.append((t, loop))
    (t, loop), (jt, jloop) = loops
    loop.close()
    return t, loop, jt, jloop


@pytest.mark.parametrize("keep", [False, True])
def test_miner_loop_schedule_matches_jax(world, keep):
    t, loop, jt, jloop = _run_pair(world, keep_optimizer_on_pull=keep)
    r, jr = loop.report, jloop.report
    assert (r.steps, r.pushes, r.base_pulls, r.pushes_failed) == \
        (jr.steps, jr.pushes, jr.base_pulls, jr.pushes_failed)
    assert r.base_pulls == 1 and r.pushes >= 2
    # the optimizer was reset on the pull (or kept): equal step counts
    assert loop.state.opt_state.count == int(jloop.state.opt_state[0].count)
    assert loop.state.opt_state.count == (10 if keep else 10 - 5)
    np.testing.assert_allclose(r.last_loss, jr.last_loss, rtol=1e-4)
    # the rider names the pulled base, by the same revision string
    assert loop._base_revision == jloop._base_revision == t.base_revision()
    assert t.fetch_delta_meta("m0")["base_revision"] == t.base_revision()
    assert jt.base_revision() == t.base_revision()


def test_guard_reverts_like_jax(world, monkeypatch):
    """A scripted held-out loss sequence (best, then two evals worse than
    best + margin) reverts both loops to the best full state."""
    script = [3.0, 2.5, 2.8, 2.9, 2.4, 2.7, 2.45]

    def scripted():
        calls = iter(script)
        return lambda params, batches: (next(calls), 0.0)

    monkeypatch.setattr(world["jeng"], "evaluate", scripted())
    port_eval = scripted()
    monkeypatch.setattr(ttrain.TrainEngine, "evaluate",
                        lambda self, params, batches: port_eval(params,
                                                                batches))
    t, loop, jt, jloop = _run_pair(world, val=True, bases=[
        world["bases"][0], world["bases"][0]])
    assert loop.report.val_reverts == jloop.report.val_reverts == 1
    assert loop._best_val == jloop._best_val


def test_nan_guard_refuses_the_push_like_jax(world):
    poisoned = jax.tree_util.tree_map(np.copy, world["bases"][0])
    poisoned["wte"][3, 5] = np.nan
    t, loop, jt, jloop = _run_pair(world, bases=[poisoned, poisoned],
                                   steps=6)
    assert loop.report.pushes == jloop.report.pushes == 0
    assert loop.report.pushes_failed == jloop.report.pushes_failed == 0
    assert t.fetch_delta_bytes("m0") is None
    assert jt.fetch_delta_bytes("m0") is None


def _port_round(world, push_async):
    """The port's loop alone on the round of ``_run_pair``. An async push
    is drained before the loop goes on, so no push is superseded by the
    next one however the worker thread is scheduled."""
    model, _ = tg.make_model(TINY)
    t = InMemoryTransport()
    t.publish_base(world["bases"][0])
    loop = ttrain.MinerLoop(ttrain.TrainEngine(model, device="cpu"), t, "m0",
                            clock=FakeClock(), send_interval=4.0,
                            check_update_interval=3.0, log_every=10**9,
                            push_async=push_async)
    submit = loop._publisher.submit

    def submit_and_drain(*args, **kw):
        dropped = submit(*args, **kw)
        assert loop._publisher.flush(timeout=60)
        return dropped

    loop._publisher.submit = submit_and_drain
    loop.bootstrap()
    loop.run(_schedule(loop, world["train"][:10],
                       lambda: t.publish_base(world["bases"][1])),
             max_steps=10)
    loop.flush()
    loop.close()
    return t, loop.report


def test_async_and_sync_artifacts_byte_identical(world):
    t_sync, r_sync = _port_round(world, push_async=False)
    t_async, r_async = _port_round(world, push_async=True)
    assert r_sync.pushes == r_async.pushes >= 2
    assert r_async.pushes_superseded == 0 and r_async.pushes_failed == 0
    assert t_sync.fetch_delta_bytes("m0") == t_async.fetch_delta_bytes("m0")


def test_unported_miner_options_raise(world):
    model, _ = tg.make_model(TINY)
    eng = ttrain.TrainEngine(model, device="cpu")
    for kw, match in (({"delta_dtype": "int8"}, "slice 5"),
                      ({"checkpoint_store": object()}, "slice 5"),
                      ({"base_fetcher": object()}, "slice 5"),
                      ({"heartbeat": object()}, "slice 7")):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.MinerLoop(eng, InMemoryTransport(), "m0", **kw)


# ---------------------------------------------------------------------------
# The CLI's configuration
# ---------------------------------------------------------------------------

MINER_ARGS = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--fused-loss",
              "--no-base-wire-v2", "--checkpoint-interval", "0",
              "--no-anomaly-trace", "--flight-events", "0"]


def test_config_parses_a_jax_miner_command_line_unchanged():
    from distributedtraining_tpu.config import RunConfig as JRunConfig
    argv = MINER_ARGS + ["--max-steps", "3", "--learning-rate", "1e-3",
                         "--seq-len", "32", "--send-interval", "10",
                         "--keep-optimizer-on-pull", "--no-push-async",
                         "--delta-dtype", "bfloat16"]
    for args in (argv, []):
        ours = dataclasses.asdict(RunConfig.from_args("miner", args))
        ref = dataclasses.asdict(JRunConfig.from_args("miner", args))
        assert ours == {k: ref[k] for k in ours}
    RunConfig.from_args("miner", argv).check_ported()


@pytest.mark.parametrize("extra,slice_no", [
    ([], 5),                                    # --base-wire-v2 is on
    (["--no-base-wire-v2"], 5),                 # --checkpoint-interval 600
    (["--no-base-wire-v2", "--checkpoint-interval", "0"], 7),
    (MINER_ARGS + ["--wire-v2", "--delta-dtype", "int8"], 5),
    (MINER_ARGS + ["--delta-dtype", "sparse8"], 5),
    (MINER_ARGS + ["--backend", "hf"], 7),
    (MINER_ARGS + ["--lora-rank", "4"], 7),
    (MINER_ARGS + ["--fsdp", "2"], 7),
    (MINER_ARGS + ["--metrics-path", "m.jsonl"], 7),
    (MINER_ARGS + ["--model", "gpt2-774m"], 7),  # bf16 E 1280, fused
    (MINER_ARGS + ["--model", "gpt2-1.5b"], 7),  # bf16 E 1600, fused
])
def test_config_refuses_what_is_not_ported(extra, slice_no):
    cfg = RunConfig.from_args("miner", extra)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        cfg.check_ported()


def test_fused_loss_width_refused_on_the_card_only(monkeypatch):
    """--fused-loss at a bf16 width the CE kernels do not take is refused
    before any work where the kernels would run (the card), by the
    config and by the engine, and runs on the CPU's plain version."""
    wide = MINER_ARGS + ["--model", "gpt2-774m"]
    RunConfig.from_args("miner", wide).check_ported("cpu")
    RunConfig.from_args("miner", MINER_ARGS + ["--model", "gpt2-355m"]
                        ).check_ported()
    model, _ = tg.make_model(dataclasses.replace(TINY, dtype="bfloat16",
                                                 n_embd=1280, n_head=20))
    ttrain.TrainEngine(model, fused_loss=True, device="cpu")
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="slice 7"):
        ttrain.TrainEngine(model, fused_loss=True)
    ttrain.TrainEngine(model, fused_loss=False)


# ---------------------------------------------------------------------------
# A mixed round over one local root
# ---------------------------------------------------------------------------

def test_mixed_round_jax_base_port_delta_scored_by_jax(world, tmp_path):
    root = str(tmp_path / "artifacts")
    jt = JFS(root)
    rev = jt.publish_base(_jtree(world["bases"][0]))
    model, _ = tg.make_model(TINY)
    eng = ttrain.TrainEngine(model, fused_loss=True, device="cpu")
    loop = ttrain.MinerLoop(eng, LocalFSTransport(root), "m7",
                            clock=FakeClock(), send_interval=1e9,
                            check_update_interval=1e9)
    loop.bootstrap()
    assert loop._base_revision == rev
    for k, v in tg.params_to_numpy(loop.base_params).items():
        if not isinstance(v, dict):
            np.testing.assert_array_equal(v, world["bases"][0][k])
    loop.run(iter(world["train"][:6]))
    loop.flush()
    loop.close()
    assert jt.fetch_delta_meta("m7")["base_revision"] == rev
    template = jax.tree_util.tree_map(np.asarray, world["bases"][0])
    d = jt.fetch_delta("m7", template)
    assert d is not None
    ok, reason = jdelta.screen_delta(d, template)
    assert ok, reason
    jbase = _jtree(world["bases"][0])
    jscore = (world["jeng"].evaluate(jbase, world["val"])[0]
              - world["jeng"].evaluate(jdelta.apply_delta(jbase, d),
                                       world["val"])[0])
    tbase = tg.params_from_numpy(world["bases"][0], device="cpu")
    tdelta = tg.params_from_numpy(tser.load_file(
        f"{root}/deltas/m7.msgpack", world["bases"][0]), device="cpu")
    trained = {k: tbase[k] + tdelta[k] for k in tbase}
    tscore = (eng.evaluate(tbase, world["val"])[0]
              - eng.evaluate(trained, world["val"])[0])
    assert jscore > 0
    np.testing.assert_allclose(tscore, jscore, rtol=1e-5)


def test_port_miner_main_on_cpu_publishes_a_delta_jax_reads(
        world, tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tminer.main(MINER_ARGS + ["--work-dir", work, "--max-steps",
                                         "3", "--seq-len", "32",
                                         "--batch-size", "2"]) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    template = jax.tree_util.tree_map(
        np.asarray, tg.init_params_numpy(tg.PRESETS["tiny"], 0))
    d = JFS(f"{work}/artifacts").fetch_delta("hotkey_0", template)
    assert d is not None and jdelta.screen_delta(d, template)[0]


def test_miner_spans_and_step_observations_with_obs_on(world, tmp_path):
    """With the port's obs switched on, a round over a local root feeds
    the step, data-wait and push/transport span histograms, and the
    publish worker carries the push's correlation id."""
    from distributedtraining_tpu_torch.utils import obs
    model, _ = tg.make_model(TINY)
    eng = ttrain.TrainEngine(model, device="cpu")
    t = LocalFSTransport(str(tmp_path / "artifacts"))
    t.publish_base(world["bases"][0])
    seen = []
    orig = t.publish_delta

    def spy(miner_id, delta):
        seen.append(obs.current_cid())
        return orig(miner_id, delta)

    t.publish_delta = spy
    reg = obs.configure()
    try:
        loop = ttrain.MinerLoop(eng, t, "m9", clock=FakeClock(),
                                send_interval=1e9,
                                check_update_interval=1e9, push_async=True)
        loop.bootstrap()
        loop.run(iter(world["train"][:3]))
        loop.flush()
        loop.close()
        snap = obs.flush()
    finally:
        obs.reset()
    assert seen == ["m9-000001"]
    for name in ("miner.step_ms", "miner.data_wait_ms", "span.push.snapshot_ms",
                 "span.push.upload_ms", "span.transport.publish_delta_ms",
                 "publish.submit_ms"):
        assert snap[f"{name}.count"] >= 1, name
    assert snap["miner.step_ms.count"] == 3 and snap["publish.pushes"] == 1
    assert reg is not obs.registry()    # reset dropped the registry
