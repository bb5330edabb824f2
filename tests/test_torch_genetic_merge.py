"""The port's genetic merge (engine/average.py ``GeneticMerge``, the
averager's ``--strategy genetic``) and its draws (utils/prng.py
``split``, ``randint``, ``normal``) against the JAX package, on the CPU.

- The draws: the keys and the parent picks equal ``jax.random``'s bits;
  the normals are held to 3 f32 ulps (XLA's ``log1p`` is not correctly
  rounded: over 30,000 draws 4.9% differ, none by more than 3 ulps; see
  tests/test_torch_prng.py). The population sequence (the first draw,
  then two generations bred from fixed elites) equals the JAX strategy's
  vectors within 8 f32 ulps (measured: 7 at most, the softmax's ``exp``
  adding to the normals' ulps), the parents exactly.
- A round on three trained deltas, f32 tiny GPT-2, population 6, 3
  generations, 2 val batches screened on 1: the winning vector and the
  merged tree match the JAX strategy's within 1e-6, with the memo's
  tiers as large as the JAX strategy's evaluations. The fixture's
  candidate losses are separated: the test asserts that no two distinct
  candidates' losses of one tier lie closer than 1e-5 (measured: 8.4e-5
  on the screen tier, 8.0e-4 on the full one), against cross-package forward noise of ~1e-6 at a
  loss near 6 (ROADMAP.md), so no rank flips between the packages.
- Sequential (``batched=False``) and batched evaluation pick the same
  winner; the CLI with ``--strategy genetic`` publishes on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu.engine import average as javg
from distributedtraining_tpu.engine import batched_eval as jbe
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.utils import prng

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
IDS = ["hotkey_1", "hotkey_2", "hotkey_3"]
GA = dict(population=6, generations=3, sigma=0.1, elite=2, seed=0,
          screen_batches=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

def _jax_first_population(seed, population, m):
    """The JAX strategy's first draw, its lines (engine/average.py
    GeneticMerge.merge) spelled out."""
    rng = jax.random.PRNGKey(seed)
    pop = [jnp.full((m,), 1.0 / m)]
    for _ in range(population - 1):
        rng, k = jax.random.split(rng)
        pop.append(jax.nn.softmax(jax.random.normal(k, (m,))))
    return rng, pop


def _jax_breed(rng, elites, population, elite, sigma, m):
    children, parents = list(elites), []
    while len(children) < population:
        rng, k1, k2 = jax.random.split(rng, 3)
        i = int(jax.random.randint(k1, (), 0, elite))
        parents.append(i)
        children.append(jax.nn.softmax(
            elites[i] + sigma * jax.random.normal(k2, (m,))))
    return rng, children, parents


@pytest.mark.parametrize("m,seed", [(3, 0), (5, 7), (16, 3)])
def test_population_sequence_matches_jax(m, seed):
    strat = tavg.GeneticMerge(population=8, elite=3, sigma=0.1, seed=seed)
    rng, pop = strat.first_population(prng.prng_key(seed), m)
    jrng, jpop = _jax_first_population(seed, 8, m)
    for gen in range(2):
        assert np.array_equal(rng.numpy(), np.asarray(jrng, np.int64))
        assert len(pop) == len(jpop) == 8
        for ours, theirs in zip(pop, jpop):
            assert _ulps(ours.numpy(), theirs) <= 8
        # fixed elites (the first three of JAX's population) on both
        # sides, so the breeding draws are compared alone
        elites = [np.array(w) for w in jpop[:3]]
        picks = []
        real = prng.randint

        def spy(key, n, lo, hi):
            out = real(key, n, lo, hi)
            picks.append(int(out[0]))
            return out
        prng.randint = spy
        try:
            rng, pop = strat.breed(rng, [torch.from_numpy(e) for e in
                                         elites], m)
        finally:
            prng.randint = real
        jrng, jpop, jparents = _jax_breed(jrng, [jnp.asarray(e)
                                                 for e in elites],
                                          8, 3, 0.1, m)
        assert picks == jparents and len(set(picks)) > 1


# ---------------------------------------------------------------------------
# A round against the JAX strategy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(6)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    base = tg.init_params_numpy(TINY, 0)
    fast = ttrain.TrainEngine(
        model, optimizer=ttrain.default_optimizer(1e-2), device="cpu")
    deltas = []
    for i in range(3):
        state = fast.init_state(tg.params_from_numpy(base, device="cpu"))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        for b in train[2 * i:2 * i + 2]:
            state, _ = fast.train_step(state, fast.place_batch(b))
        deltas.append(tg.params_to_numpy(
            tdl.compute_delta(state.params, snap)))
    return {"base": base, "val": val, "deltas": deltas, "model": model,
            "jmodel": jmodel,
            "teng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_round(world, **kw):
    strat = tavg.GeneticMerge(**{**GA, **kw})
    base = tg.params_from_numpy(world["base"], device="cpu")
    merged, w = strat.merge(world["teng"], base, world["deltas"], IDS,
                            val_batches=lambda: iter(world["val"]))
    return strat, merged, w


def _jax_round(world, monkeypatch):
    """The JAX strategy's round, counting its evaluations a tier (screen:
    1 batch; full: 2) through the engine and the cohort evaluator."""
    counts = {"cand_batches": 0}
    real_eval = jtrain.TrainEngine.evaluate
    real_stacked = jbe.BatchedCohortEvaluator.evaluate_stacked

    def evaluate(self, params, batches):
        batches = list(batches)
        counts["cand_batches"] += len(batches)
        return real_eval(self, params, batches)

    def evaluate_stacked(self, base, cands, k_real, batches):
        batches = list(batches)
        counts["cand_batches"] += k_real * len(batches)
        return real_stacked(self, base, cands, k_real, batches)

    monkeypatch.setattr(jtrain.TrainEngine, "evaluate", evaluate)
    monkeypatch.setattr(jbe.BatchedCohortEvaluator, "evaluate_stacked",
                        evaluate_stacked)
    strat = javg.GeneticMerge(**GA)
    stacked = jdl.stack_deltas([_jtree(d) for d in world["deltas"]])
    merged, w = strat.merge(world["jeng"], _jtree(world["base"]), stacked,
                            IDS, val_batches=lambda: iter(world["val"]))
    return counts, merged, w


def test_round_winner_and_merged_tree_match_jax(world, monkeypatch):
    strat, merged, w = _port_round(world)
    gaps = {}
    counts, jmerged, jw = _jax_round(world, monkeypatch)
    memo = strat.last_memo
    # the fixture's losses are separated: the closest two distinct
    # candidates of a tier are > 1e-5 apart (8.4e-5 measured), ten times
    # the cross-package noise, so no rank can flip
    for tier in (False, True):
        losses = sorted(v for (k, full), v in memo.items() if full == tier)
        assert len(losses) >= 2
        gaps[tier] = float(min(np.diff(losses)))
        assert gaps[tier] > 1e-5, gaps
    # the memo's misses are the JAX strategy's evaluations, batch for batch
    n_screen = sum(1 for _, full in memo if not full)
    n_full = sum(1 for _, full in memo if full)
    assert n_screen * 1 + n_full * 2 == counts["cand_batches"]
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    ours = tdl.flatten_tree(tg.params_to_numpy(merged))
    theirs = tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, jmerged))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-6)
    # the merged tree is the plain mixture at the winner
    base = tg.params_from_numpy(world["base"], device="cpu")
    placed = [tdl.place_delta(d, base) for d in world["deltas"]]
    plain = tdl.weighted_merge(base, placed, w)
    assert all(torch.equal(plain[k], merged[k]) for k in plain)
    assert strat.lineage_weights(w) is w


def test_sequential_and_batched_evaluation_agree(world):
    batched = _port_round(world)
    seq = _port_round(world, batched=False)
    assert torch.equal(batched[2], seq[2])
    assert batched[0].last_memo.keys() == seq[0].last_memo.keys()
    for k, v in batched[0].last_memo.items():
        assert v == pytest.approx(seq[0].last_memo[k], rel=1e-6)


def test_candidate_deltas_rebuild_the_merge_bit_for_bit(world):
    base = tg.params_from_numpy(world["base"], device="cpu")
    placed = [tdl.place_delta(d, base) for d in world["deltas"]]
    rows = torch.tensor([[0.2, 0.3, 0.5], [1 / 3, 1 / 3, 1 / 3]])
    cands = tdl.combine_candidate_deltas(base, placed, rows)
    for row, cand in zip(rows, cands):
        merged = tdl.weighted_merge(base, placed, row)
        assert all(torch.equal(base[k] + cand[k], merged[k]) for k in base)
    with pytest.raises(ValueError):
        tdl.combine_candidate_deltas(base, placed, torch.ones(1, 2))


def test_zero_generations_and_arguments(world):
    strat, merged, w = _port_round(world, generations=0)
    # the best of the first draw, screened then fully evaluated
    assert len(w) == 3 and abs(float(w.sum()) - 1.0) < 1e-6
    with pytest.raises(ValueError):
        tavg.GeneticMerge(screen_batches=0)
    d, j = tavg.GeneticMerge(), javg.GeneticMerge()
    assert (d.population, d.generations, d.sigma, d.elite, d.seed,
            d.screen_batches, d.batched) == \
        (j.population, j.generations, j.sigma, j.elite, j.seed,
         j.screen_batches, j.batched)


def test_genetic_cli_publishes_on_cpu(tmp_path, monkeypatch):
    """``neurons.averager.main --strategy genetic`` (a small population)
    merges a miner's delta and publishes a new base."""
    import logging

    from distributedtraining_tpu_torch.neurons import averager as tcli
    from distributedtraining_tpu_torch.neurons import miner as tminer
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    small = ["--batch-size", "2", "--eval-batches", "2",
             "--eval-seq-len", "32", "--work-dir", work]
    flags = ["--backend", "local", "--model", "tiny", "--dataset",
             "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
             "--no-lineage", "--flight-events", "0"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(flags + small + ["--rounds", "1"]) == 1  # genesis
        t = LocalFSTransport(f"{work}/artifacts")
        rev0 = t.base_revision()
        assert tminer.main(flags + small + [
            "--checkpoint-interval", "0", "--no-anomaly-trace",
            "--hotkey", "hotkey_3", "--max-steps", "3",
            "--seq-len", "32"]) == 0
        assert tcli.main(flags + small + [
            "--rounds", "1", "--publish-policy", "always", "--strategy",
            "genetic", "--genetic-population", "4",
            "--genetic-generations", "1", "--hotkey", "hotkey_95"]) == 0
    finally:   # main's logging.basicConfig must not outlive the test
        root.handlers[:], root.level = handlers, level
    assert t.base_revision() not in (None, rev0)
