"""The prefix cache of the port's serving engine (engine/serve.py
``PrefixCache``, copy-on-write, eviction before preemption) against the
JAX package's, on the CPU.

The cache is driven op for op beside JAX's (chain digests, matches,
registrations, LRU evictions: equal pages, counts and refcounts); the
engines then serve prompts that share a system prefix with
``prefix_cache=True`` and emit the same tokens with the same hit
counts as the JAX engine (tiny f32 model, greedy and sampled lanes),
with the pool's refcounts audited after every step
(``debug_invariants``); copy-on-write keeps a shared page intact, and a
dry pool evicts cache-only pages before it preempts anyone.
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
from distributedtraining_tpu_torch.utils import obs

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
P = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_digests_match_jax():
    for parent in (tserve.PrefixCache.ROOT, b"\x01" * 16):
        for toks in ((), (1,), tuple(range(8)), (50256, 3, 7)):
            assert tserve.PrefixCache._digest(parent, toks) == \
                jserve.PrefixCache._digest(parent, toks)


def test_cache_ops_match_jax_op_for_op():
    """One script of register / match / evict on both caches (each over
    its own pool): every result, refcount and entry order agrees."""
    rng = np.random.default_rng(0)
    sys_p = [int(t) for t in rng.integers(0, 50, 20)]
    prompts = [sys_p + [int(t) for t in rng.integers(0, 50, n)]
               for n in (3, 0, 9, 12)] + [sys_p[:13], [1, 2, 3]]
    caches = []
    for mod in (tserve, jserve):
        pool = mod.PagePool(40)
        caches.append((pool, mod.PrefixCache(pool, P)))
    log = {0: [], 1: []}
    for i, (pool, cache) in enumerate(caches):
        for p in prompts:
            pages, matched = cache.match(p)
            log[i].append(("match", tuple(pages), matched))
            fresh = pool.alloc(len(p) // P + 1 - len(pages))
            for q in pages:
                pool.incref(q)
            cache.register(p, pages + fresh)
            log[i].append(("len", len(cache), pool.free))
            for q in pages + fresh:       # the slot finishes
                pool.decref(q)
        while cache.evict_one():
            log[i].append(("evict", len(cache), pool.free,
                           tuple(cache.pages())))
        log[i].append(("refs", tuple(sorted(pool._refs.items()))))
    assert log[0] == log[1]
    assert any(m[2] for m in log[0] if m[0] == "match")
    assert any(m[0] == "evict" for m in log[0])


def test_match_caps_one_short_and_partial_pages_are_terminal():
    pool = tserve.PagePool(10)
    cache = tserve.PrefixCache(pool, P)
    p = list(range(20))
    pages = pool.alloc(3)
    cache.register(p, pages)
    assert cache.match(p) == (pages, 19)       # one token runs prefill
    assert cache.match(p[:17] + [99]) == (pages, 17)   # into the tail
    assert cache.match(p[:5] + [99]) == (pages[:1], 5)
    assert cache.match([7] + p) == ([], 0)


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
    rng = np.random.RandomState(1)
    sys_p = [int(t) for t in rng.randint(0, TINY.vocab_size, size=20)]
    prompts = [sys_p + [int(t) for t in rng.randint(0, TINY.vocab_size,
                                                    size=n)]
               for n in (3, 9, 1, 12, 5)] + [sys_p[:16] + [3, 4]]
    return {"jmodel": jmodel, "tmodel": tmodel,
            "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
            "state": tg.params_from_numpy(tree, device="cpu"),
            "prompts": prompts}


def _serve(eng, prompts, sampled):
    reqs = [eng.submit(p, 8, temperature=(0.8 if sampled and i % 2
                                          else 0.0), top_p=0.9, seed=i)
            for i, p in enumerate(prompts)]
    for _ in range(2000):
        if all(r.done_evt.is_set() for r in reqs):
            break
        eng.step()
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("slots,sampled", [(2, False), (3, True)])
def test_engine_tokens_and_hits_match_jax(world, slots, sampled):
    kw = dict(max_slots=slots, page_size=P, prefix_cache=True)
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"], **kw)
    try:
        ref = _serve(jeng, world["prompts"], sampled)
        jhits = (jeng.prefix_hits, jeng.prefix_misses,
                 jeng.prefix_tokens_saved, jeng.cow_copies)
    finally:
        jeng.close()
    eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", debug_invariants=True, **kw)
    try:
        ours = _serve(eng, world["prompts"], sampled)
        hits = (eng.prefix_hits, eng.prefix_misses,
                eng.prefix_tokens_saved, eng.cow_copies)
        assert eng.suffix_prefills == eng.prefix_hits > 0
        assert eng.full_prefills == eng.prefix_misses
    finally:
        eng.close()
    assert ours == ref and hits == jhits
    # without the cache the same tokens come out
    plain = tserve.GenerationEngine(world["tmodel"], world["state"],
                                    device="cpu", max_slots=slots,
                                    page_size=P)
    try:
        assert _serve(plain, world["prompts"], sampled) == ours
    finally:
        plain.close()


def test_copy_on_write_keeps_the_shared_page(world):
    """A prompt ending inside a cached page maps it, copies it before its
    suffix prefill writes there, and the cached page's rows are
    untouched; the refcounts then match the holders exactly."""
    eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", max_slots=2, page_size=P,
                                  prefix_cache=True, debug_invariants=True)
    try:
        first = world["prompts"][0]               # 23 tokens: 3 pages
        eng.generate([first], 2)
        # its own decode wrote into its partial last page: copied first
        assert eng.cow_copies == 1
        cached = {k: p for k, p in eng._cache._entries.items()}
        tail_page = next(p for k, p in cached.items() if len(k[1]) < P)
        k_before = eng._kv[0][:, tail_page].clone()
        second = first[:20] + [5, 6]              # diverges in page 2
        req = eng.submit(second, 4)
        eng.step()
        slot = next(s for s in eng._active if s.req is req)
        assert eng.cow_copies == 2 and tail_page not in slot.pages
        assert slot.pages[:2] == [cached[k] for k in cached
                                  if len(k[1]) == P][:2]
        torch.testing.assert_close(eng._kv[0][:, tail_page], k_before,
                                   rtol=0, atol=0)
        for p in slot.pages[:2]:
            assert eng.pool.refs(p) == 2          # the cache and the slot
        while not req.done_evt.is_set():
            eng.step()
        assert all(eng.pool.refs(p) == 1 for p in eng._cache.pages())
    finally:
        eng.close()


def test_a_dry_pool_evicts_cache_pages_before_preempting(world):
    """Distinct prompts through a small pool: cache-only pages are
    evicted LRU-first to admit new work, nothing is preempted, and the
    tokens are the uncached engine's."""
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(0, TINY.vocab_size, size=14)]
               for _ in range(5)]
    obs.configure()
    try:
        eng = tserve.GenerationEngine(
            world["tmodel"], world["state"], device="cpu", max_slots=1,
            page_size=P, max_seq_len=32, pool_pages=6, prefix_cache=True,
            debug_invariants=True)
        try:
            out = eng.generate(prompts, 4)
        finally:
            eng.close()
        reg = obs.registry()
        assert reg.counter("serve.prefix_evictions").value >= 3
        assert reg.peek("serve.preempted") is None
    finally:
        obs.reset()
    ref = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", max_slots=1, page_size=P,
                                  max_seq_len=32)
    try:
        assert ref.generate(prompts, 4) == out
    finally:
        ref.close()
