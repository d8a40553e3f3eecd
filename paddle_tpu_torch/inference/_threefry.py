"""JAX's counter-based random numbers (threefry2x32), in plain torch
integer ops and vectorised over rows — so a sampled token of the port is
the same draw the JAX engine makes from the same (seed, counter).

Every function here reproduces one of ``jax.random`` with the default
``threefry2x32`` implementation and ``jax_threefry_partitionable=True``:

* `prng_key(seed)` — ``jax.random.PRNGKey(seed)``: the key
  ``(seed >> 32, seed & 0xFFFFFFFF)``;
* `fold_in(key, data)` — ``jax.random.fold_in``: threefry of the counter
  pair ``(0, data)`` under the key;
* `random_bits(key, n)` — ``jax.random.bits(key, (n,))``: the counter pair
  of element i is the 64-bit iota split into ``(i >> 32, i & mask)`` and
  the bits are the xor of the two threefry outputs;
* `uniform(key, n, minval)` — the top 23 bits OR'd into 1.0's exponent,
  minus 1, scaled to ``[minval, 1)``;
* `gumbel(key, n)` — ``-log(-log(u))`` with ``minval = tiny`` (mode
  "low");
* `categorical(key, logits)` — ``argmax(gumbel + logits)``;
* `split(key, num)` — ``jax.random.split``: key i is threefry of the
  counter pair ``(0, i)``, the same as ``fold_in(key, i)``.

A key is a pair ``(k1, k2)`` of int64 tensors; all arithmetic is int64
masked to 32 bits (torch's uint32 arithmetic is incomplete on both CPU and
CUDA). Keys of shape ``[rows]`` are one key a row, as the decode engine's
sampler draws: `random_bits(key, n)` gives each row ``jax.random.bits(
key_row, (n,))``. A key of 0-d tensors is one key for a whole shape, as
`models.generation` draws: `random_bits(key, shape)` is ``jax.random.bits(
key, shape)``, whose counters run over the flattened shape (row-major), so
one key over ``[B, V]`` draws what a ``[1]`` key draws over ``B * V``.
`categorical` over ``[B, V]`` logits under such a key is
``jax.random.categorical(key, logits)``.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the keys (k1, k2); all int64 in [0, 2**32), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed):
    """Keys of int64 seeds [rows] (values below 2**32 as the u32 seeds of
    `SamplingParams`); a 0-d seed gives one key."""
    seed = seed.to(torch.int64)
    return (seed >> 32) & _MASK, seed & _MASK


def split(key, num=2):
    """``jax.random.split(key, num)`` of one key (0-d tensors): a list of
    `num` keys, key i threefry of the counter pair ``(0, i)``."""
    k1, k2 = key
    i = torch.arange(num, dtype=torch.int64, device=k1.device)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return [(y0[j], y1[j]) for j in range(num)]


def fold_in(key, data):
    """Fold the per-row int counters `data` [rows] into the keys."""
    k1, k2 = key
    data = data.to(torch.int64) & _MASK
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(key, n):
    """int64 tensor holding u32 bits. Row keys ([rows]) and an int `n`:
    [rows, n], ``jax.random.bits(key, (n,))`` of each row's key. One key
    (0-d) and a shape `n`: ``jax.random.bits(key, n)``."""
    k1, k2 = key
    if k1.dim() == 0:
        shape = (n,) if isinstance(n, int) else tuple(n)
        iota = torch.arange(math.prod(shape), dtype=torch.int64,
                            device=k1.device)
        y0, y1 = threefry2x32(k1, k2, iota >> 32, iota & _MASK)
        return (y0 ^ y1).reshape(shape)
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)[None]
    y0, y1 = threefry2x32(k1[:, None], k2[:, None], iota >> 32,
                          iota & _MASK)
    return y0 ^ y1


def uniform(key, n, minval=0.0):
    """f32 uniforms in [minval, 1): [rows, n] from the rows' keys, or of
    shape `n` from one key (see `random_bits`)."""
    bits = random_bits(key, n)
    fb = (bits >> 9) | _ONE_F32_BITS
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    # f32 scalars formed on the host: no copy to the device, so that a
    # CUDA graph can capture the draw
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(1.0 - lo)
    lo = float(lo)
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key, n):
    """Standard Gumbel noise (JAX's mode "low"), shaped as `uniform`."""
    return -torch.log(-torch.log(uniform(key, n, _TINY)))


def categorical(key, logits):
    """One draw per row of `logits` [rows, V] f32 (the Gumbel-max trick):
    under row keys, row r's noise is its own key's; under one key, the
    noise of the whole [rows, V] shape is that key's."""
    n = tuple(logits.shape) if key[0].dim() == 0 else logits.shape[-1]
    return torch.argmax(gumbel(key, n) + logits, dim=-1)
