"""Counter-based random numbers, bit for bit the JAX package's: the port's
counterpart of the ``jax.random`` calls on the serving plane's sampler
(``jax.random.PRNGKey``, ``fold_in``, ``categorical`` with its
``uniform`` and ``gumbel`` draws) and on the genetic merge's population
(``split``, ``normal``, ``randint``), on the default threefry2x32
generator with ``jax_threefry_partitionable`` on.

These are batched integer ops on tensors, on the CPU or the card. The
JAX package computes them in XLA, not in a kernel, and so does the port.
torch has no unsigned 32-bit arithmetic to speak of, so every 32-bit word
lives in an ``int64`` tensor, masked to 32 bits after each add and
rotate; the bits are exact on either device.

A key is an ``int64`` tensor ``[..., 2]`` holding two 32-bit words; every
function takes a batch of keys (leading dims) and returns a batch.

- ``prng_key(seed)``: ``[0, seed mod 2^32]`` (a 32-bit seed's key).
- ``fold_in(key, data)``: ``threefry2x32(key, [0, data])``.
- ``random_bits(key, n)``: 32-bit words for the flat indices ``0..n-1``:
  the hash of the index as two words ``(i >> 32, i mod 2^32)``, the two
  output words xor-ed (the partitionable rule).
- ``uniform(key, n, minval)``: ``(bits >> 9) | 0x3F800000`` as f32, minus
  1, scaled to ``[minval, 1)``.
- ``gumbel(key, n)``: ``-log(-log(uniform(key, n, tiny)))`` (mode "low").
- ``categorical(key, logits)``: ``argmax(logits + gumbel)`` over the last
  axis (the first index among equals).
- ``split(key, num)``: key ``i`` is ``threefry2x32(key, [0, i])`` (the
  foldlike split the partitionable flag selects), so ``split(key, n)[i]
  == fold_in(key, i)``.
- ``randint(key, n, minval, maxval)``: int32 draws in ``[minval,
  maxval)``: two bit streams from ``split(key, 2)`` folded into the span
  as ``jax.random.randint`` folds them.
- ``normal(key, n)``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform on
  ``(nextafter(-1, 0), 1)``, ``erfinv`` being XLA's f32 polynomial
  (Giles) over ``w = -log1p(-u^2)``.

``torch.log`` and ``log1p`` may differ from XLA's in the last bit of a
float: the bits, keys, integers and uniforms are exact, a Gumbel draw is
within an ulp, and a normal within a few ulps (the JAX package's own
``log1p`` is not correctly rounded; here it is computed in f64 and
rounded, so the card and the CPU give the same bits).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under the key ``(k1, k2)``: ``int64`` tensors of 32-bit words that
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def _words(x, device=None) -> torch.Tensor:
    """``x`` (ints or an integer tensor) as 32-bit words in ``int64``."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & _MASK


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of 32-bit integer seeds: keys
    ``[..., 2]`` = ``[0, seed mod 2^32]``."""
    s = _words(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the keys ``key [..., 2]`` with the 32-bit
    integers ``data`` (broadcast to the key batch) folded in."""
    d = _words(data, key.device)
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words ``[..., n]`` (``int64``) of each key, as
    ``jax.random.bits(key, (n,))`` draws them under the partitionable
    threefry rule."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None],
                        idx >> 32, idx & _MASK)
    return a ^ b


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """f32 uniforms ``[..., n]`` in ``[minval, 1)``, as
    ``jax.random.uniform(key, (n,), minval=minval)``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel draws ``[..., n]`` (f32), ``jax.random.gumbel``'s
    mode "low"."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY)))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` keys ``[..., num, 2]``."""
    return fold_in(key[..., None, :],
                   torch.arange(num, dtype=torch.int64, device=key.device))


def randint(key: torch.Tensor, n: int, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32): ``[...,
    n]`` integers in ``[minval, maxval)`` (``minval`` when ``maxval <=
    minval``)."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], n)
    lo = random_bits(keys[..., 1, :], n)
    # int32 bounds (the default dtype); an empty range returns minval
    span = max(int(maxval) - int(minval), 1)
    # 2^32 mod span in uint32 words, as JAX computes it (the square wraps)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + (lo % span)
    off = (off & _MASK) % span
    return (int(minval) + off).to(torch.int32)


# XLA's f32 erf-inverse (Giles' polynomial): w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, op for op (no fused multiply-adds): each
    product and sum is rounded to f32 as XLA's is; ``log1p`` is f64
    rounded to f32."""
    f32 = torch.float32
    w = -torch.log1p((x * -x).to(torch.float64)).to(f32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device
    c = [torch.where(lt, torch.tensor(a, dtype=f32, device=dev),
                     torch.tensor(b, dtype=f32, device=dev))
         for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0]
    for ci in c[1:]:
        p = ci + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0),
                                   torch.tensor(0.0)))


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard normal f32 draws ``[..., n]``, ``jax.random.normal(key,
    (n,))``'s formula (see the module docstring for the ulps)."""
    u = uniform(key, n, _NORMAL_LO)
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=torch.float32, device=key.device)
    return sqrt2 * erfinv_f32(u)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for a batch: one index of
    the last axis of ``logits [..., V]`` (f32) for each key ``[..., 2]``."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
