"""The port's validator (engine/validate.py, engine/batched_eval.py,
engine/lineage.py's credit, neurons/validator.py, the validator half of
config.py) against the JAX package, on the CPU.

- One LocalFSTransport root holds a fleet of JAX and port miners: dense
  v1 deltas, JAX- and port-packed wire-v2 submissions (int8 and f32), an
  index-out-of-range one, an over-cap one, a stale one, and the empty
  slots of every other hotkey. The port's ``Validator`` and the JAX one
  score it on their own chain directories, with the cohort path and the
  sequential path, under both staleness policies: per-miner losses within
  1e-5 relative, scores within 1e-6, the same reasons, and
  ``consensus_scores()`` within 1e-6.
- Mixed fleets both ways: the port validator's chain weights drive a JAX
  ``AveragerLoop``, the JAX validator's drive the port's.
- The cohort path against the sequential one, ``include_base``, the
  bucket ladder, ``stage_cohorts``, the credit ledger, the permit gate,
  the flags against the JAX parser, the refusals and the CLI.

f32 tiny GPT-2 on both sides; weights from numpy with a seed, deltas from
a few training steps of the port's engine.
"""

import dataclasses
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import lineage as jlineage
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.batched_eval import \
    BatchedCohortEvaluator as JEval
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.engine.validate import Validator as JValidator
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.chain import LocalChain
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import batched_eval as tbe
from distributedtraining_tpu_torch.engine import lineage as tlineage
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine import validate as tval
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.neurons import validator as tcli
from distributedtraining_tpu_torch.transport import LocalFSTransport

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HONEST = ("hotkey_1", "hotkey_2", "hotkey_3", "hotkey_4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Report:
    pushes = pushes_failed = pushes_superseded = 0


def _jpublish_v2(jt, hotkey, packed, rev, quant):
    fast = JRetry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)
    pub = JPub(jt, hotkey, report=_Report(), publish_retry=fast,
               meta_retry=fast,
               wire_spec={"format": 2, "density": 1.0 / 16.0,
                          "quant": quant})
    assert pub.publish_now(packed, None, rev, f"{hotkey}-000001")
    pub.close()


def _trained_delta(teng, base, batches):
    """``trained - base`` after a few steps of the port's engine: a delta
    that lowers the held-out loss (an honest miner)."""
    state = teng.init_state(tg.params_from_numpy(base, device="cpu"))
    snap = {k: v.detach().clone() for k, v in state.params.items()}
    for b in batches:
        state, _ = teng.train_step(state, teng.place_batch(b))
    d = tdl.compute_delta(state.params, snap)
    return tg.params_to_numpy(d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(8)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    teng = ttrain.TrainEngine(model, device="cpu")
    fast = ttrain.TrainEngine(
        model, optimizer=ttrain.default_optimizer(1e-2), device="cpu")
    base = tg.init_params_numpy(TINY, 0)
    root = str(tmp_path_factory.mktemp("val") / "artifacts")
    jt = JFS(root)
    rev = jt.publish_base(jax.tree_util.tree_map(jnp.asarray, base))
    deltas = {}
    # a JAX dense v1 miner and a JAX-packed int8 wire-v2 miner
    deltas["hotkey_1"] = _trained_delta(fast, base, train[0:2])
    jt.publish_delta("hotkey_1", deltas["hotkey_1"])
    jt.publish_delta_meta("hotkey_1", {"base_revision": rev})
    packed, _ = jdl.pack_delta_v2(
        jax.tree_util.tree_map(jnp.asarray,
                               _trained_delta(fast, base, train[2:4])),
        density=1.0 / 16.0, quant="int8")
    deltas["hotkey_2"] = jax.tree_util.tree_map(np.asarray, packed)
    _jpublish_v2(jt, "hotkey_2", deltas["hotkey_2"], rev, "int8")
    # a port MinerLoop wire-v2 miner (f32 kept values) and a port dense one
    pt = LocalFSTransport(root)
    miner = ttrain.MinerLoop(
        ttrain.TrainEngine(tg.make_model(TINY)[0],
                           optimizer=ttrain.default_optimizer(1e-2),
                           device="cpu"),
        pt, "hotkey_3", clock=FakeClock(), send_interval=1e9,
        check_update_interval=1e9, wire_v2=True, wire_density=1.0 / 16.0,
        wire_quant="none")
    miner.bootstrap()
    miner.run(iter(train[4:6]))
    miner.flush()
    miner.close()
    deltas["hotkey_4"] = _trained_delta(fast, base, train[6:8])
    pt.publish_delta("hotkey_4", deltas["hotkey_4"])
    pt.publish_delta_meta("hotkey_4", {"base_revision": rev})
    # hostiles: an index out of range, a value over the cap; a stale one
    bad = jax.tree_util.tree_map(np.copy, deltas["hotkey_2"])
    bad["leaves"]["wpe"]["idx"][0] = np.int32(
        np.prod(np.shape(base["wpe"])))
    _jpublish_v2(jt, "hotkey_5", bad, rev, "int8")
    huge = jax.tree_util.tree_map(np.copy, deltas["hotkey_2"])
    huge["leaves"]["wte"]["scale"] = np.asarray(1e6, np.float32)
    _jpublish_v2(jt, "hotkey_6", huge, rev, "int8")
    deltas["hotkey_7"] = _trained_delta(fast, base, train[1:3])
    jt.publish_delta("hotkey_7", deltas["hotkey_7"])
    jt.publish_delta_meta("hotkey_7", {"base_revision": "old"})
    return {"base": base, "val": val, "train": train, "root": root,
            "rev": rev, "deltas": deltas, "teng": teng, "model": model,
            "jeng": jtrain.TrainEngine(jmodel), "tok": tok}


def _port_validator(world, chain_dir, **kw):
    return tval.Validator(
        world["teng"], LocalFSTransport(world["root"]),
        LocalChain(chain_dir, my_hotkey="hotkey_91"),
        eval_batches=lambda: iter(world["val"]), **kw)


def _jax_validator(world, chain_dir, **kw):
    return JValidator(
        world["jeng"], JFS(world["root"]),
        JChain(chain_dir, my_hotkey="hotkey_91"),
        eval_batches=lambda: iter(world["val"]), **kw)


_ROUNDS: dict = {}


def _round(world, tmp_path_factory, cohort, stale):
    """Both validators, one round each on their own chain directory
    (memoized: the mixed-fleet tests reuse the chain weights)."""
    key = (cohort, stale)
    if key not in _ROUNDS:
        d = tmp_path_factory.mktemp(f"chains_{cohort}_{stale}")
        out = {}
        for side, make in (("port", _port_validator),
                           ("jax", _jax_validator)):
            chain_dir = str(d / side)
            v = make(world, chain_dir, cohort_size=cohort,
                     stale_deltas=stale)
            v.bootstrap()
            res = {s.hotkey: s for s in v.validate_and_score()}
            v.close()
            out[side] = (v, res, chain_dir)
        _ROUNDS[key] = out
    return _ROUNDS[key]


@pytest.mark.parametrize("cohort,stale", [(8, "accept"), (1, "skip")])
def test_validator_round_matches_jax(world, tmp_path_factory, cohort,
                                     stale):
    r = _round(world, tmp_path_factory, cohort, stale)
    (pv, ours, pchain), (jv, theirs, jchain) = r["port"], r["jax"]
    assert pv.base_loss == pytest.approx(jv.base_loss, rel=1e-5)
    assert set(ours) == set(theirs) and len(ours) == 99
    for h, s in theirs.items():
        o = ours[h]
        assert o.reason == s.reason, h
        if s.loss is None:
            assert o.loss is None and o.score == 0.0
        else:
            assert o.loss == pytest.approx(s.loss, rel=1e-5, abs=0), h
            assert o.perplexity == pytest.approx(s.perplexity, rel=1e-5)
            # the score is a difference of two f32 losses near 6, whose
            # ulp is 4.8e-7: the forwards of the two packages round
            # differently (summation order), so 1e-6 is two ulps; hold it
            # to four ulps of the larger loss, and the rule exactly
            ulp = float(np.spacing(np.float32(max(s.loss, jv.base_loss))))
            assert abs(o.score - s.score) <= max(1e-6, 4 * ulp), h
            assert o.score == max(0.0, pv.base_loss - o.loss)
    # the fleet's verdicts, as the JAX package gives them
    assert ours["hotkey_5"].reason == "no_delta"
    assert ours["hotkey_6"].reason.startswith("magnitude_exceeded(")
    assert ours["hotkey_7"].reason == ("ok" if stale == "accept"
                                       else "stale_base")
    assert ours["hotkey_8"].reason == "no_delta"          # an empty slot
    assert all(ours[h].score > 0 for h in HONEST)
    pc, jc = (LocalChain(pchain).consensus_scores(),
              JChain(jchain).consensus_scores())
    assert set(pc) == set(jc) and len(set(np.round(list(pc.values()),
                                                  4))) > 2
    for h in jc:
        assert abs(pc[h] - jc[h]) <= 1e-6, h
    # the leave-one-out credit, the same on both sides
    pt, jt = pv.credit.totals(), jv.credit.totals()
    assert set(pt) == set(jt)
    for h in jt:
        assert pt[h] == pytest.approx(jt[h], rel=1e-4, abs=1e-7)


def _published(root, template):
    fetched = JFS(root).fetch_base(template)
    return tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, fetched[0]))


@pytest.mark.parametrize("validator_side", ["port", "jax"])
def test_mixed_fleet_validator_weights_drive_the_other_averager(
        world, tmp_path_factory, tmp_path, validator_side):
    """A port validator's weights drive a JAX averager, and a JAX
    validator's drive the port's: the averager's merge weights are the
    normalized consensus of the other package's chain weights, and the
    published base equals base + sum w_i d_i."""
    _, _, chain_dir = _round(world, tmp_path_factory, 8,
                             "accept")[validator_side]
    root = str(tmp_path / "artifacts")
    shutil.copytree(world["root"], root)
    val = world["val"]
    if validator_side == "port":
        loop = JLoop(world["jeng"], JFS(root),
                     JChain(chain_dir, my_hotkey="hotkey_95"), JWA(),
                     val_batches=lambda: iter(val), publish_policy="always")
    else:
        loop = tavg.AveragerLoop(
            world["teng"], LocalFSTransport(root),
            LocalChain(chain_dir, my_hotkey="hotkey_95"),
            tavg.WeightedAverage(), val_batches=lambda: iter(val),
            publish_policy="always")
    loop.bootstrap()
    assert loop.run_round()
    loop.close()
    ids, w = loop.strategy._weights_cache[0][0], np.asarray(
        loop.strategy._weights_cache[1])
    consensus = JChain(chain_dir).consensus_scores()
    assert consensus and len(set(np.round(w, 6))) > 1   # not uniform
    np.testing.assert_allclose(
        w, np.asarray(jdl.normalized_merge_weights(list(ids), consensus)),
        rtol=0, atol=1e-7)
    template = jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.float32), world["base"])
    got = _published(root, template)
    expect = {k: v.astype(np.float64)
              for k, v in tdl.flatten_tree(world["base"]).items()}
    ingest = tval.Validator(world["teng"], LocalFSTransport(world["root"]),
                            LocalChain(str(tmp_path / "c")),
                            eval_batches=None)._ingest()
    staged = {s.hotkey: s.delta for s in ingest.stage(list(ids))}
    ingest.close()
    for h, wi in zip(ids, w):
        for k, v in tdl.flatten_tree(staged[h]).items():
            expect[k] += float(wi) * np.asarray(v, np.float64)
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=0, atol=1e-6)


def test_cohort_path_matches_sequential_and_include_base(world,
                                                       tmp_path_factory):
    """Cohort 8 against the one-at-a-time ``engine.evaluate`` path, with
    the base in slot 0, and the JAX evaluator on the same candidates;
    padded slots are not evaluated."""
    teng, base_np = world["teng"], world["base"]
    base = tg.params_from_numpy(base_np, device="cpu")
    ds = [world["deltas"][h] for h in ("hotkey_1", "hotkey_4", "hotkey_7")]
    ev = tbe.BatchedCohortEvaluator(teng)
    assert ev.bucket_for(len(ds) + 1) == 4 and not ev.compiled_buckets()
    calls = []
    orig = teng.place_batch
    teng.place_batch = lambda b: calls.append(1) or orig(b)
    try:
        got = ev.evaluate_cohort(base, ds, iter(world["val"]),
                                 include_base=True)
    finally:
        del teng.place_batch
    assert len(calls) == len(world["val"])     # each batch placed once
    assert ev.compiled_buckets() == {4}
    want = [teng.evaluate(base, iter(world["val"]))]
    want += [teng.evaluate(tbe.candidate_params(base, d),
                           iter(world["val"])) for d in ds]
    jev = JEval(world["jeng"])
    jgot = jev.evaluate_cohort(
        jax.tree_util.tree_map(jnp.asarray, base_np),
        [jax.tree_util.tree_map(jnp.asarray, d) for d in ds],
        iter(world["val"]), include_base=True)
    for (gl, gp), (wl, wp), (jl, jp) in zip(got, want, jgot):
        assert gl == pytest.approx(wl, rel=1e-5)
        assert gp == pytest.approx(wp, rel=1e-5)
        assert gl == pytest.approx(jl, rel=1e-5)
    assert ev.evaluate_cohort(base, [], iter(world["val"])) == []
    # the port's Validator: cohort 8 against sequential on the same fleet
    (cv, cohort, _), (sv, seq, _) = (
        _round(world, tmp_path_factory, 8, "accept")["port"],
        _round(world, tmp_path_factory, 1, "skip")["port"])
    assert cv.base_loss == pytest.approx(sv.base_loss, rel=1e-6)
    for h in HONEST:
        assert cohort[h].loss == pytest.approx(seq[h].loss, rel=1e-6)
        assert cohort[h].score == pytest.approx(seq[h].score, abs=2e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 16, 17, 33])
def test_bucket_ladder_matches_jax(k):
    eng = types.SimpleNamespace(mesh=None)
    assert tbe.BatchedCohortEvaluator(eng).bucket_for(k) == \
        JEval(eng).bucket_for(k)


def test_bucket_ladder_rejects_empty_and_mesh():
    with pytest.raises(ValueError):
        tbe.BatchedCohortEvaluator(types.SimpleNamespace()).bucket_for(0)
    with pytest.raises(NotImplementedError, match="slice 7"):
        tbe.BatchedCohortEvaluator(types.SimpleNamespace(mesh=object()))


# ---------------------------------------------------------------------------
# Credit attribution
# ---------------------------------------------------------------------------

def _scores(rows):
    return [types.SimpleNamespace(hotkey=h, loss=l, score=s)
            for h, l, s in rows]


CREDIT_CASES = {
    "weighted": [("r1", 3.0, [("a", 2.5, 0.5), ("b", 2.9, 0.1),
                              ("c", None, 0.0)])],
    "all_zero_uniform": [("r1", 3.0, [("a", 3.2, 0.0), ("b", 3.1, 0.0)])],
    "replace_on_revisit": [("r1", 3.0, [("a", 2.5, 0.5)]),
                           ("r1", 3.0, [("a", 2.0, 1.0), ("b", 2.8, 0.2)])],
    "nan_base_and_loss": [("r1", float("nan"), [("a", 2.5, 0.5)]),
                          ("r2", 3.0, [("a", float("nan"), 0.0),
                                       ("b", 2.5, 0.5)])],
    "eviction": [(f"r{i}", 3.0, [("a", 3.0 - 0.1 * i, 0.1 * i),
                                 ("b", 2.9, 0.1)]) for i in range(1, 6)],
}


@pytest.mark.parametrize("case", sorted(CREDIT_CASES))
def test_credit_ledger_matches_jax(case):
    ours = tlineage.CreditLedger(max_revisions=2)
    ref = jlineage.CreditLedger(max_revisions=2)
    for rev, base_loss, rows in CREDIT_CASES[case]:
        got = ours.update(rev, base_loss, _scores(rows))
        want = ref.update(rev, base_loss, _scores(rows))
        assert got == want
        assert tlineage.loo_credits(base_loss, _scores(rows)) == \
            jlineage.loo_credits(base_loss, _scores(rows))
    assert ours.totals() == ref.totals()
    assert ours.revisions() == ref.revisions()


# ---------------------------------------------------------------------------
# stage_cohorts
# ---------------------------------------------------------------------------

def test_stage_cohorts_order_and_pipeline_on_off():
    items = list(range(11))
    piped = tbe.stage_cohorts(items, 4, lambda x: x * x, pipeline=True)
    inline = tbe.stage_cohorts(items, 4, lambda x: x * x, pipeline=False)
    many = tbe.stage_cohorts(items, 4, None, pipeline=True,
                             stage_many=lambda g: [x * x for x in g])
    want = [[x * x for x in items[i:i + 4]] for i in (0, 4, 8)]
    assert list(piped) == list(inline) == list(many) == want


def test_stage_cohorts_inline_is_lazy():
    seen = []
    staged = tbe.stage_cohorts(list(range(6)), 2,
                               lambda x: seen.append(x) or x,
                               pipeline=False)
    assert next(staged) == [0, 1] and seen == [0, 1]
    assert next(staged) == [2, 3] and seen == [0, 1, 2, 3]


def test_stage_cohorts_close_stops_worker():
    staged_items = []
    release = threading.Event()

    def stage_one(x):
        staged_items.append(x)
        release.wait(2.0)
        return x

    staged = tbe.stage_cohorts(list(range(8)), 1, stage_one,
                               pipeline=True, depth=1)
    deadline = time.monotonic() + 2.0
    while not staged_items and time.monotonic() < deadline:
        time.sleep(0.005)
    staged.close()
    release.set()
    time.sleep(0.1)
    n = len(staged_items)
    time.sleep(0.1)
    assert len(staged_items) <= n + 1 < 8
    staged._worker.join(2.0)
    assert not staged._worker.is_alive()


def test_stage_cohorts_rejects_bad_cohort_size():
    with pytest.raises(ValueError):
        tbe.stage_cohorts([1, 2], 0, lambda x: x)


def test_failed_round_closes_the_stager(world, tmp_path, monkeypatch):
    v = _port_validator(world, str(tmp_path / "c"), cohort_size=2)
    v.bootstrap()
    made = []
    real = tbe.stage_cohorts

    def spy(*a, **kw):
        it = real(*a, **kw)
        made.append(it)
        return it

    def boom(*a, **kw):
        raise RuntimeError("eval failed")

    monkeypatch.setattr(tbe, "stage_cohorts", spy)
    monkeypatch.setattr(tbe.BatchedCohortEvaluator, "evaluate_cohort", boom)
    with pytest.raises(RuntimeError, match="eval failed"):
        v.validate_and_score()
    assert made and made[0]._stop.is_set()
    made[0]._worker.join(2.0)
    assert not made[0]._worker.is_alive()
    v.close()


# ---------------------------------------------------------------------------
# Permit, refusals, config, CLI, isolation
# ---------------------------------------------------------------------------

def test_unpermitted_validator_never_emits_weights(world, tmp_path):
    chain = LocalChain(str(tmp_path / "c"), my_hotkey="hotkey_5")
    v = tval.Validator(world["teng"], LocalFSTransport(world["root"]),
                       chain, eval_batches=lambda: iter(world["val"]))
    v.bootstrap()
    assert not v.has_vpermit()
    assert v.validate_and_score()          # scoring itself still works
    assert v.validate_and_score()
    assert chain.get_weights() == {}       # nothing was emitted
    assert chain.consensus_scores() == {}
    v.close()


@pytest.mark.parametrize("kw,slice_no", [
    ({"fleet": object()}, 7), ({"remediation": object()}, 7),
    ({"base_fetcher": object()}, None), ({"lora_cfg": object()}, 7),
    ({"metrics": object()}, 7)])
def test_unported_validator_planes_raise(world, kw, slice_no):
    if slice_no is None:    # ported: accepted
        val = tval.Validator(world["teng"], None, None, eval_batches=None,
                             **kw)
        assert val.base_fetcher is kw["base_fetcher"]
        return
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        tval.Validator(world["teng"], None, None, eval_batches=None, **kw)


VAL_ARGS = ["--backend", "local", "--model", "tiny", "--dataset",
            "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
            "--flight-events", "0"]


def test_validator_flags_match_the_jax_parser():
    from distributedtraining_tpu.config import RunConfig as JRunConfig
    from distributedtraining_tpu.config import build_parser as jparser
    from distributedtraining_tpu_torch.config import build_parser

    def table(p):
        return {o: (a.dest, a.default, a.choices)
                for a in p._actions for o in a.option_strings}
    assert table(build_parser("validator")) == table(jparser("validator"))
    argv = VAL_ARGS + ["--rounds", "2", "--val-cohort", "4",
                       "--val-pipeline-depth", "0", "--score-metric",
                       "perplexity", "--allow-no-vpermit", "--stale-deltas",
                       "skip", "--max-delta-abs", "0", "--no-wire-v2",
                       "--no-accept-quant", "--ingest-workers", "1",
                       "--validation-interval", "5"]
    for args in (argv, []):
        ours = dataclasses.asdict(RunConfig.from_args("validator", args))
        ref = dataclasses.asdict(JRunConfig.from_args("validator", args))
        assert ours == {k: ref[k] for k in ours}
    RunConfig.from_args("validator", argv).check_ported()


@pytest.mark.parametrize("extra,slice_no", [
    # the JAX defaults (--base-wire-v2, --flight-events 512) and the
    # opt-outs of them are ported: None means accepted
    ([], None),
    (["--no-base-wire-v2"], None),
    (VAL_ARGS + ["--remediate"], 7),
    (VAL_ARGS + ["--heartbeat-interval", "2"], 7),
    (VAL_ARGS + ["--metrics-path", "m.jsonl"], 7),
    (VAL_ARGS + ["--lora-rank", "4"], 7),
    # ported (tests/test_torch_signing.py runs the validator CLI with it)
    (VAL_ARGS + ["--sign-artifacts"], None),
])
def test_validator_refusals_name_their_slice(extra, slice_no):
    cfg = RunConfig.from_args("validator", extra)
    if slice_no is None:
        cfg.check_ported()
        return
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        cfg.check_ported()


def test_validator_cli_on_cpu_writes_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    small = ["--batch-size", "2", "--eval-batches", "2",
             "--eval-seq-len", "32", "--work-dir", work]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tminer.main(
            ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--checkpoint-interval", "0", "--no-anomaly-trace",
             "--flight-events", "0", "--wire-v2", "--hotkey", "hotkey_3",
             "--max-steps", "3", "--seq-len", "32",
             "--learning-rate", "1e-2"] + small) == 0
        # a miner's hotkey holds no permit: refused up front
        with pytest.raises(SystemExit, match="no validator permit"):
            tcli.main(VAL_ARGS + small + ["--rounds", "1",
                                          "--hotkey", "hotkey_4"])
        assert tcli.main(VAL_ARGS + small + ["--rounds", "1",
                                             "--hotkey", "hotkey_91"]) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    weights = JChain(f"{work}/chain").get_weights("hotkey_91")
    assert weights and weights.get("hotkey_3", 0) > 0


def test_validator_path_loads_without_jax():
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
                 "ml_dtypes", "distributedtraining_tpu")
    code = ("import sys\n"
            "import distributedtraining_tpu_torch.neurons.validator\n"
            "import distributedtraining_tpu_torch.engine.validate\n"
            "import distributedtraining_tpu_torch.engine.batched_eval\n"
            "import distributedtraining_tpu_torch.engine.lineage\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{forbidden!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
