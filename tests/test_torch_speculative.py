"""Speculative decoding of the port (engine/speculative.py and the verify
path of engine/serve.py) against the JAX package's, on the CPU.

With the same target and draft weights, the port's speculative engine
emits exactly the JAX speculative engine's tokens, which equal both
packages' spec-off streams (greedy and sampled lanes), with the same
proposed and accepted counts; the verify forward runs one window a round
and the drafter's steps are counted apart from the target's. A scripted
drafter that is always wrong accepts nothing and still emits the plain
stream; a draft revision staged on the drafter's watcher installs
between steps and flushes the draft KV.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.engine import speculative as jspec
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.engine import speculative as tspec
from distributedtraining_tpu_torch.models import gpt2 as tg

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
P = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharpened(cfg, seed):
    tree = tg.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


@pytest.fixture(scope="module")
def world():
    trees = [_sharpened(TINY, 0), _sharpened(TINY, 3)]
    rng = np.random.RandomState(2)
    sys_p = [int(t) for t in rng.randint(0, TINY.vocab_size, size=12)]
    prompts = [sys_p + [int(t) for t in rng.randint(0, TINY.vocab_size,
                                                    size=n)]
               for n in (3, 9, 1, 12)]
    return {"jmodel": jg.make_model(JTINY)[0],
            "tmodel": tg.make_model(TINY)[0],
            "jparams": [jax.tree_util.tree_map(jnp.asarray, t)
                        for t in trees],
            "states": [tg.params_from_numpy(t, device="cpu")
                       for t in trees],
            "prompts": prompts}


def _serve(eng, prompts, sampled, n=10):
    reqs = [eng.submit(p, n, temperature=(0.9 if sampled and i % 2
                                          else 0.0), top_p=0.9, seed=i)
            for i, p in enumerate(prompts)]
    for _ in range(2000):
        if all(r.done_evt.is_set() for r in reqs):
            break
        eng.step()
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("draft", [0, 1], ids=["self", "other"])
def test_spec_streams_and_accepts_match_jax(world, sampled, draft):
    kw = dict(max_slots=2, page_size=P, prefix_cache=True, draft_k=4)
    jd = jspec.DraftEngine(world["jmodel"], world["jparams"][draft],
                           max_slots=2, page_size=P)
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"][0],
                                   draft=jd, **kw)
    try:
        ref = _serve(jeng, world["prompts"], sampled)
        jacc = (jeng._spec_proposed, jeng._spec_accepted, jeng.spec_rounds)
    finally:
        jeng.close()
    td = tspec.DraftEngine(world["tmodel"], world["states"][draft],
                           device="cpu", max_slots=2, page_size=P)
    eng = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                  device="cpu", draft=td,
                                  debug_invariants=True, **kw)
    try:
        ours = _serve(eng, world["prompts"], sampled)
        acc = (eng._spec_proposed, eng._spec_accepted, eng.spec_rounds)
        assert eng.verify_dispatches == eng.spec_rounds > 0
        assert eng.decode_dispatches == 0 and eng.spec_fallbacks == 0
        assert td.step_dispatches > 0 and td.prefill_dispatches > 0
    finally:
        eng.close()
    assert ours == ref and acc == jacc
    if draft == 0:
        assert acc[1] == acc[0] > 0          # a self-draft agrees always
    plain = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                    device="cpu", max_slots=2, page_size=P)
    try:
        assert _serve(plain, world["prompts"], sampled) == ours
    finally:
        plain.close()


def test_a_wrong_drafter_accepts_nothing_and_changes_nothing(world):
    wrong = tspec.ScriptedDraftSource(
        lambda req, k: [(len(req.tokens) * 7 + i) % TINY.vocab_size
                        for i in range(k)])
    eng = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                  device="cpu", max_slots=2, page_size=P,
                                  draft=wrong, draft_k=3,
                                  debug_invariants=True)
    try:
        ours = _serve(eng, world["prompts"], True)
        assert eng._spec_proposed > 0 and eng._spec_accepted == 0
    finally:
        eng.close()
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"][0],
                                   max_slots=2, page_size=P)
    try:
        assert _serve(jeng, world["prompts"], True) == ours
    finally:
        jeng.close()


def test_a_failing_drafter_is_counted_and_serves_plain(world):
    """A drafter without weights, or one whose propose raises, leaves the
    step to plain decode and counts ``spec_fallbacks`` (what a check that
    speculation really ran reads); the stream is the plain one."""
    def boom(req, k):
        raise RuntimeError("drafter down")

    cold = tspec.DraftEngine(world["tmodel"], device="cpu", max_slots=2,
                             page_size=P)
    streams = []
    for draft in (tspec.ScriptedDraftSource(boom), cold):
        eng = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                      device="cpu", max_slots=2,
                                      page_size=P, draft=draft, draft_k=3,
                                      debug_invariants=True)
        try:
            streams.append(_serve(eng, world["prompts"], True))
            assert eng.spec_fallbacks > 0 and eng._spec_proposed == 0
            assert eng.decode_dispatches + eng.verify_dispatches > 0
        finally:
            eng.close()
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"][0],
                                   max_slots=2, page_size=P)
    try:
        assert streams == [_serve(jeng, world["prompts"], True)] * 2
    finally:
        jeng.close()


class _Staged:
    def __init__(self):
        self.staged = None
        self.closed = False

    def take_pending(self):
        s, self.staged = self.staged, None
        return s

    def close(self):
        self.closed = True


def test_draft_hot_swap_flushes_and_keeps_the_stream(world):
    """A new draft revision lands mid-run: the drafter installs it between
    steps (its states flushed), acceptance moves, the tokens do not."""
    watcher = _Staged()
    td = tspec.DraftEngine(world["tmodel"], world["states"][1],
                           device="cpu", max_slots=2, page_size=P,
                           revision="d1", watcher=watcher)
    eng = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                  device="cpu", max_slots=2, page_size=P,
                                  draft=td, debug_invariants=True)
    try:
        reqs = [eng.submit(p, 10) for p in world["prompts"]]
        for _ in range(3):
            eng.step()
        flushes = td.flush_count
        watcher.staged = ("d2", world["states"][0])
        eng.step()
        assert td.revision == "d2" and td.flush_count == flushes + 1
        for _ in range(500):
            if all(r.done_evt.is_set() for r in reqs):
                break
            eng.step()
        ours = [list(r.tokens) for r in reqs]
    finally:
        eng.close()
    assert watcher.closed
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"][0],
                                   max_slots=2, page_size=P)
    try:
        assert jeng.generate(world["prompts"], 10) == ours
    finally:
        jeng.close()


def test_compat_refuses_a_foreign_vocabulary(world):
    other = dataclasses.replace(TINY, vocab_size=256)
    assert tspec.compat_reason(tg.make_model(other)[0], TINY) == \
        jspec.compat_reason(jg.make_model(
            dataclasses.replace(JTINY, vocab_size=256))[0], JTINY)
    with pytest.raises(ValueError, match="incompatible draft"):
        tserve.GenerationEngine(
            world["tmodel"], world["states"][0], device="cpu",
            draft=tspec.DraftEngine(tg.make_model(other)[0], device="cpu"))


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shift", [0, 1], ids=["right", "shifted_key"])
def test_card_pair_readings_see_a_verify_key_fault(world, shift,
                                                   monkeypatch):
    """The server phase's sampled-pair readings on a self-draft: with the
    right keys every pair agrees; with the verify's token index shifted
    by one (a planted key fault), pairs whose rows rank the kept tokens
    alike still differ, which the phase fails on, and the drafter's rows
    no longer give back their proposals under the verify's keys."""
    smoke = _chip_smoke()
    if shift:
        real = tserve.GenerationEngine._lanes

        def lanes(eng, active, sb):
            temps, top_ps, seeds, tok_idx = real(eng, active, sb)
            return temps, top_ps, seeds, tok_idx + shift
        monkeypatch.setattr(tserve.GenerationEngine, "_lanes", lanes)
    rows: list = []
    undo = smoke._record_sampled_rows(rows)
    try:
        td = tspec.DraftEngine(world["tmodel"], world["states"][0],
                               device="cpu", max_slots=2, page_size=P)
        eng = tserve.GenerationEngine(world["tmodel"], world["states"][0],
                                      device="cpu", max_slots=2,
                                      page_size=P, draft=td)
        try:
            _serve(eng, world["prompts"], True)
        finally:
            eng.close()
    finally:
        undo()
    assert tserve._pick is tspec._pick
    got = smoke._sampled_pair_readings(rows)
    assert got["pairs"] > 0
    if shift:
        assert got["differ_same_order"] > 0
        assert got["witness_draft_rows_verify_keys_agree"] < 0.5
    else:
        assert got["picks_differ"] == 0 and got["differ_same_order"] == 0
        assert got["witness_draft_rows_verify_keys_agree"] == 1.0
