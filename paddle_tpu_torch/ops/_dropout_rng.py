"""The attention-dropout bit stream: Philox4x32-10 in plain torch integer
ops, the same function that ``csrc/short_attention.cu`` computes inside
its kernels.

The keep bit of element ``(b, h, i, j)`` of a ``[B, H, Sq, Sk]``
probability matrix is a pure function of ``(seed, b, h, i, j)``, so the
forward kernel, the backward kernels and the plain versions draw the same
mask without storing it:

* key ``(seed & 0xFFFFFFFF, seed >> 32)``;
* counter ``(j & ~8, i & ~8, h, b)``;
* word ``2 * bit3(i) + bit3(j)`` of the four that Philox returns.

One Philox call thus serves the 2x2 group ``{i, i + 8} x {j, j + 8}``,
which is what one thread of the kernels holds of a score tile both in the
forward's ``S = Q K^T`` layout and in the dK/dV kernel's transposed one,
so neither kernel draws a word it does not use.

The rule of the JAX kernel (paddle_tpu/ops/pallas/short_attention.py
`_drop_mask`): keep where ``u32 >= uint32(min(p * 2**32, 0xFFFFFFFF))``
and scale kept values by ``1 / (1 - p)`` (an f32 constant). The TPU's own
stream (`pltpu.prng_random_bits`) cannot be reproduced; the port is
held to the JAX kernel exactly at p = 0 and statistically at p > 0.

All arithmetic is int64 masked to 32 bits; the 32 x 32 -> 64 bit products
are split into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import torch

__all__ = ["philox4x32", "keep_threshold", "keep_scale", "keep_mask",
           "dropout_mask", "draw_seed"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
_ROUNDS = 10
#: seeds are drawn in [0, SEED_HIGH): non-negative int64
SEED_HIGH = 2 ** 63 - 1


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant m and
    x (int64 in [0, 2**32))."""
    p_lo = x * (m & 0xFFFF)                     # < 2**48
    p_hi = x * (m >> 16)                        # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)          # < 2**49
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counters (c0, c1, c2, c3) under the key (k0, k1);
    int64 tensors (or ints) in [0, 2**32), broadcast together. Returns the
    four output words."""
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(p):
    """The u32 threshold: a bit pattern is kept where it is >= this."""
    return min(int(p * 2.0 ** 32), _MASK)


def keep_scale(p):
    """The value a kept probability is multiplied by, 1 / (1 - p)."""
    return 1.0 / (1.0 - p)


def _ceil16(n):
    return (n + 15) // 16 * 16


def keep_mask(seed, B, H, Sq, Sk, p):
    """bool [B, H, Sq, Sk]: the keep bits of the stream `seed` (an int64
    tensor of one element, on the device the mask is made on)."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    k0, k1 = s & _MASK, (s >> 32) & _MASK
    qa, ka = _ceil16(Sq) // 16, _ceil16(Sk) // 16
    ar = torch.arange(8, dtype=torch.int64, device=dev)
    # the counters' row and column: i = 16a + g, j = 16c + e (bit 3 clear)
    i = (torch.arange(qa, dtype=torch.int64, device=dev)[:, None] * 16
         + ar).reshape(-1)
    j = (torch.arange(ka, dtype=torch.int64, device=dev)[:, None] * 16
         + ar).reshape(-1)
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None, None]
    h = torch.arange(H, dtype=torch.int64, device=dev)[None, :, None, None]
    words = philox4x32(j[None, None, None, :], i[None, None, :, None], h, b,
                       k0, k1)
    thr = keep_threshold(p)
    # word 2u + v holds element (i + 8u, j + 8v)
    keep = torch.stack([w.expand(B, H, qa * 8, ka * 8) >= thr
                        for w in words], dim=-1)
    keep = keep.reshape(B, H, qa, 8, ka, 8, 2, 2)
    keep = keep.permute(0, 1, 2, 6, 3, 4, 7, 5)       # b h a u g c v e
    return keep.reshape(B, H, qa * 16, ka * 16)[:, :, :Sq, :Sk]


def dropout_mask(seed, B, H, Sq, Sk, p):
    """f32 [B, H, Sq, Sk]: 1 / (1 - p) where kept, else 0 (all 0 at
    p >= 1, as dropout with p = 1 gives zeros)."""
    if p >= 1.0:
        return torch.zeros((B, H, Sq, Sk), dtype=torch.float32,
                           device=seed.device)
    keep = keep_mask(seed, B, H, Sq, Sk, p)
    scale = torch.tensor(keep_scale(p), dtype=torch.float32,
                         device=seed.device)
    return torch.where(keep, scale, torch.zeros((), device=seed.device))


def draw_seed(generator=None, device=None):
    """One stream seed, an int64 tensor of shape [1] on `device`, drawn
    from `generator` (on the generator's own device; torch's default
    generator of `device` when None). A CUDA generator draws on the card,
    with no host synchronisation."""
    gdev = generator.device if generator is not None else device
    seed = torch.randint(0, SEED_HIGH, (1,), generator=generator,
                         device=gdev, dtype=torch.int64)
    return seed if device is None else seed.to(device)
