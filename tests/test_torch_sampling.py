"""Seeded sampling of the port's serving engine (engine/serve.py
``_sample_from_logits`` on utils/prng.py) against the JAX package's, on
the CPU.

The sampler is held to JAX's picks on logits without near-ties, with
greedy, temperature and top-p lanes mixed in one batch; on random normal
logits over GPT-2's vocabulary the agreement is measured and printed
(the Gumbel draws differ from XLA's by an ulp of ``log``, and the top-p
cumsum may round differently at the boundary). The engines then emit the
same sampled streams token for token (tiny f32 model), mixed with greedy
requests, and a stream depends on (seed, position) alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")

_JSAMPLE = jax.jit(jserve._sample_from_logits)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(B, seed):
    rng = np.random.default_rng(seed)
    temps = rng.choice([0.0, 0.7, 1.0, 1.6], B).astype(np.float32)
    top_ps = rng.choice([1.0, 0.95, 0.9, 0.5], B).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    tok_idx = rng.integers(0, 10**6, B).astype(np.int32)
    return temps, top_ps, seeds, tok_idx


def _both(logits, temps, top_ps, seeds, tok_idx):
    ref = np.asarray(_JSAMPLE(jnp.asarray(logits), temps, top_ps, seeds,
                              tok_idx))
    ours = tserve._sample_from_logits(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ps), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(tok_idx.astype(np.int64))).numpy()
    return ours, ref


@pytest.mark.parametrize("V", [7, 512, 50257])
def test_sampler_matches_jax_without_near_ties(V):
    """Distinct logits 0.05 apart (permuted per lane): no Gumbel ulp or
    cumsum rounding can reorder a pick."""
    B = 24
    rng = np.random.default_rng(V)
    logits = np.stack([rng.permutation(V) for _ in range(B)]
                      ).astype(np.float32) * np.float32(0.05)
    ours, ref = _both(logits, *_lanes(B, V))
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.int32


def test_pick_takes_the_sampler_only_for_sampled_lanes():
    """The engine's ``_pick`` (argmax for greedy rows, the sampler on the
    sampled rows alone) equals the JAX sampler over the whole batch."""
    B, V = 16, 512
    rng = np.random.default_rng(1)
    logits = np.stack([rng.permutation(V) for _ in range(B)]
                      ).astype(np.float32) * np.float32(0.05)
    temps, top_ps, seeds, tok_idx = _lanes(B, 2)
    _, ref = _both(logits, temps, top_ps, seeds, tok_idx)
    ours = tserve._pick(torch.from_numpy(logits), temps, top_ps, seeds,
                        tok_idx)
    assert ours == ref.tolist()
    assert tserve._pick(torch.from_numpy(logits), np.zeros(B), top_ps,
                        seeds, tok_idx) == logits.argmax(-1).tolist()


def test_sampler_agreement_on_random_logits_is_measured():
    """Random normal logits over 50257 entries, 64 sampled lanes: the
    share of picks equal to JAX's (the rest are near-ties that an ulp
    of log or of the cumsum decides). Printed, and it must stay high."""
    B, V = 64, 50257
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((B, V)) * 2.0).astype(np.float32)
    temps, top_ps, seeds, tok_idx = _lanes(B, 8)
    temps = np.maximum(temps, 0.7)
    ours, ref = _both(logits, temps, top_ps, seeds, tok_idx)
    agree = float(np.mean(ours == ref))
    print(f"sampler agreement with JAX on random logits: {agree:.4f} "
          f"({int(np.sum(ours != ref))} of {B} picks differ)")
    assert agree >= 0.95


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
    tree = _sharpened(TINY, 0)
    jmodel, _ = jg.make_model(JTINY)
    tmodel, _ = tg.make_model(TINY)
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, TINY.vocab_size, size=n)]
               for n in (5, 9, 16, 17)]
    return {"jmodel": jmodel, "tmodel": tmodel,
            "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
            "state": tg.params_from_numpy(tree, device="cpu"),
            "prompts": prompts}


# (temperature, top_p, seed) per prompt: greedy and sampled lanes mixed
MIX = [(0.0, 1.0, 0), (0.8, 0.9, 11), (1.3, 1.0, 2**31 - 1), (0.6, 0.5, 4)]


def _run(eng, prompts, n=8):
    reqs = [eng.submit(p, n, temperature=t, top_p=tp, seed=s)
            for p, (t, tp, s) in zip(prompts, MIX)]
    for _ in range(1000):
        if all(r.done_evt.is_set() for r in reqs):
            break
        eng.step()
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("slots", [2, 4])
def test_sampled_streams_match_the_jax_engine(world, slots):
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"],
                                   max_slots=slots, page_size=8)
    try:
        ref = _run(jeng, world["prompts"])
    finally:
        jeng.close()
    eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", max_slots=slots,
                                  page_size=8, debug_invariants=True)
    try:
        ours = _run(eng, world["prompts"])
    finally:
        eng.close()
    assert ours == ref
    # the sampled lanes really sampled: not the greedy stream
    greedy = jserve.GenerationEngine(world["jmodel"], world["jparams"],
                                     max_slots=slots, page_size=8)
    try:
        g = greedy.generate(world["prompts"], 8)
    finally:
        greedy.close()
    assert ours[0] == g[0] and any(o != r for o, r in zip(ours[1:], g[1:]))


def test_a_stream_depends_on_seed_and_position_only(world):
    """The same sampled request alone and inside a full batch, and after
    a preemption regenerates it, gives the same tokens."""
    p = world["prompts"][1]
    alone = tserve.GenerationEngine(world["tmodel"], world["state"],
                                    device="cpu", max_slots=1, page_size=8)
    try:
        a = alone.generate([p], 10, temperature=0.9, top_p=0.95, seed=5)[0]
    finally:
        alone.close()
    # 6 usable pages, 4 a sequence: growth preempts the youngest (p)
    busy = tserve.GenerationEngine(world["tmodel"], world["state"],
                                   device="cpu", max_slots=4, page_size=8,
                                   max_seq_len=32, pool_pages=7,
                                   debug_invariants=True)
    try:
        reqs = [busy.submit(q, 10, temperature=0.9, top_p=0.95, seed=5)
                for q in [world["prompts"][0], world["prompts"][3], p]]
        preempted = False
        for _ in range(1000):
            if all(r.done_evt.is_set() for r in reqs):
                break
            busy.step()
            preempted |= busy.trace.seen(reqs[2].rid, "preempt")
    finally:
        busy.close()
    assert preempted and reqs[2].tokens == a
