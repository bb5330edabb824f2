"""The port's counter-based random numbers (distributedtraining_tpu_torch
/utils/prng.py) against ``jax.random`` on the CPU.

Keys, ``fold_in`` and the raw bits are exact (``array_equal``); uniforms
too, since they are built from the bits by integer operations; Gumbel
draws are within one ulp of each ``log`` (torch's and XLA's f32 ``log``
round differently in the last bit, about 14% of the time); categorical
picks agree where no two perturbed logits lie within those ulps.
``split`` and ``randint`` (the genetic merge's keys and parent picks)
are exact; ``normal`` is held to 3 ulps: XLA's f32 ``log1p`` inside its
erf-inverse is not correctly rounded, and over 30,000 draws (seeds 0-99,
300 each) 4.9% of the port's normals differ from ``jax.random.normal``,
by 3 ulps at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu_torch.utils import prng

SEEDS = (0, 1, 2**31 - 1)
TOK_IDX = (0, 1, 37, 10**6)
TINY = np.finfo(np.float32).tiny


def _jkey(seed, t):
    return jax.random.fold_in(jax.random.PRNGKey(seed), t)


def _tkey(seed, t):
    return prng.fold_in(prng.prng_key(torch.tensor([seed])),
                        torch.tensor([t]))


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_match_jax(seed):
    np.testing.assert_array_equal(
        prng.prng_key(torch.tensor(seed)).numpy(),
        _key_words(jax.random.PRNGKey(seed)))
    for t in TOK_IDX:
        np.testing.assert_array_equal(_tkey(seed, t)[0].numpy(),
                                      _key_words(_jkey(seed, t)))


def test_batched_keys_match_one_at_a_time():
    seeds = torch.tensor(SEEDS)
    idx = torch.tensor([5, 0, 10**6])
    keys = prng.fold_in(prng.prng_key(seeds), idx)
    for i, (s, t) in enumerate(zip(SEEDS, idx.tolist())):
        np.testing.assert_array_equal(keys[i].numpy(),
                                      _key_words(_jkey(s, t)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 50257])
def test_bits_and_uniform_match_jax(seed, n):
    for t in (0, 10**6):
        jk, tk = _jkey(seed, t), _tkey(seed, t)
        np.testing.assert_array_equal(
            prng.random_bits(tk, n)[0].numpy(),
            np.asarray(jax.random.bits(jk, (n,))).astype(np.int64))
        for lo in (0.0, TINY):
            np.testing.assert_array_equal(
                prng.uniform(tk, n, lo)[0].numpy(),
                np.asarray(jax.random.uniform(jk, (n,), minval=lo)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_an_ulp_of_each_log(seed):
    """-log(-log(u)) with each log allowed its last bit: the port's
    draw lies within the interval that one ulp of error in each of
    JAX's two logs spans (relative 2^-23 of the inner log moves the
    outer by 2^-23 absolute)."""
    n = 50257
    jk, tk = _jkey(seed, 3), _tkey(seed, 3)
    ours = prng.gumbel(tk, n)[0].numpy()
    ref = np.asarray(jax.random.gumbel(jk, (n,)))
    eps = np.float32(2.0 ** -23)
    tol = np.abs(np.spacing(ref)) + eps
    assert np.all(np.abs(ours - ref) <= tol)
    assert np.mean(ours == ref) > 0.5


@pytest.mark.parametrize("n", [1, 7, 50257])
def test_categorical_picks_match_jax(n):
    """Picks on logits spread wide enough that the Gumbel ulps cannot
    reorder two entries (the flips on a tight spread are counted in
    test_torch_sampling.py)."""
    rng = np.random.default_rng(n)
    logits = (rng.permutation(n).astype(np.float32) * 0.5)
    agree = 0
    for seed in SEEDS:
        for t in TOK_IDX:
            ref = int(jax.random.categorical(_jkey(seed, t),
                                             jnp.asarray(logits)))
            ours = int(prng.categorical(_tkey(seed, t),
                                        torch.from_numpy(logits)[None])[0])
            agree += ours == ref
    assert agree == len(SEEDS) * len(TOK_IDX)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(seed, num):
    k = jax.random.PRNGKey(seed)
    ours = prng.split(prng.prng_key(torch.tensor(seed)), num)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(
        jax.random.split(k, num)).astype(np.int64))
    # a batch of keys splits lane by lane; key i is fold_in(key, i)
    batch = prng.prng_key(torch.tensor([seed, 5]))
    assert torch.equal(prng.split(batch, num)[0], ours)
    assert torch.equal(ours[num - 1], prng.fold_in(
        prng.prng_key(torch.tensor(seed)), num - 1))


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 3), (5, 17), (0, 1), (3, 3),
                                   (-4, 1000), (0, 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    for seed in range(40):
        jk = jax.random.PRNGKey(seed)
        tk = prng.prng_key(torch.tensor(seed))
        np.testing.assert_array_equal(
            prng.randint(tk, 9, lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (9,), lo, hi)))
        assert int(prng.randint(tk, 1, lo, hi)[0]) == \
            int(jax.random.randint(jk, (), lo, hi))


@pytest.mark.parametrize("n", [1, 3, 300])
def test_normal_within_three_ulps(n):
    worst = 0
    for seed in range(0, 100, 3):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
        ours = prng.normal(prng.prng_key(torch.tensor(seed)), n).numpy()
        assert ours.dtype == np.float32
        d = np.abs(ours.view(np.int32).astype(np.int64)
                   - ref.view(np.int32).astype(np.int64))
        worst = max(worst, int(d.max()))
    assert worst <= 3


def test_erfinv_edges_follow_xla():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999], dtype=torch.float32)
    ours = prng.erfinv_f32(x).numpy()
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    # +-1 map to +-inf, as XLA's, 0 to 0
    np.testing.assert_array_equal(ours[:3], ref[:3])
    assert np.isinf(ours[1]) and ours[0] < 0
    np.testing.assert_allclose(ours[3:], ref[3:], rtol=1e-6)
