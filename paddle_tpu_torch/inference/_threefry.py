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
* `categorical(key, logits)` — ``argmax(gumbel + logits)``.

A key is a pair ``(k1, k2)`` of int64 tensors of shape ``[rows]``; all
arithmetic is int64 masked to 32 bits (torch's uint32 arithmetic is
incomplete on both CPU and CUDA).
"""
from __future__ import annotations

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
    `SamplingParams`)."""
    seed = seed.to(torch.int64)
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key, data):
    """Fold the per-row int counters `data` [rows] into the keys."""
    k1, k2 = key
    data = data.to(torch.int64) & _MASK
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(key, n):
    """[rows, n] int64 holding u32 bits: ``jax.random.bits(key, (n,))`` of
    each row's key."""
    k1, k2 = key
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)[None]
    y0, y1 = threefry2x32(k1[:, None], k2[:, None], iota >> 32,
                          iota & _MASK)
    return y0 ^ y1


def uniform(key, n, minval=0.0):
    """[rows, n] f32 uniforms in [minval, 1) from the rows' keys."""
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
    """[rows, n] standard Gumbel noise (JAX's mode "low")."""
    return -torch.log(-torch.log(uniform(key, n, _TINY)))


def categorical(key, logits):
    """One draw per row of `logits` [rows, V] f32 (the Gumbel-max trick)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
