"""Paged KV-cache allocator (counterpart of
paddle_tpu/inference/decode/block_pool.py).

One pool of fixed-size blocks per layer, on the engine's device:

    k/v pools:           [num_blocks, block_size, Hkv, D]   (model dtype)
    int8 kq/vq pools:    [num_blocks, block_size, Hkv, D]   int8
    int8 ks/vs scales:   [num_blocks, block_size, Hkv]      f32

Each sequence holds a block table; position ``p`` lives at
``(table[p // block_size], p % block_size)``. Blocks are refcounted (a
block returns to the free list when its last holder drops it), and block 0
is RESERVED as the padding sink: padded rows of a bucketed decode step
carry an all-zeros table, so their writes land in block 0, which is never
handed out. The pool tensors are written in place by the model's paged
step.

Invariant: ``allocated + free + reserved == total`` at all times, and a
drained engine returns to ``allocated == 0``.
"""
from __future__ import annotations

import math
import threading

import torch

__all__ = ["BlockKVCache", "OutOfBlocks", "RESERVED_BLOCKS"]

#: block ids below this are never allocated (block 0 = padding sink)
RESERVED_BLOCKS = 1


class OutOfBlocks(RuntimeError):
    """The pool cannot satisfy an allocation (the engine's admission gate
    reserves worst-case growth, so live sequences never see this)."""


class BlockKVCache:
    """Device-resident paged KV pool + host-side free-list allocator.

    `entry_specs` is one tuple of ``(suffix_shape, dtype)`` pairs per
    layer, in the layer's cache-entry order; each pool tensor is
    ``[num_blocks, block_size, *suffix_shape]``. Models build it through
    ``init_block_pool``."""

    def __init__(self, num_blocks, block_size, entry_specs, quant=None,
                 name=None, device="cpu"):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < RESERVED_BLOCKS + 1:
            raise ValueError(
                f"num_blocks must be > {RESERVED_BLOCKS} (block 0 is the "
                f"reserved padding sink), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.quant = quant
        self.name = name
        self.device = torch.device(device)
        self.tensors = [
            tuple(torch.zeros((self.num_blocks, self.block_size, *suffix),
                              dtype=dtype, device=self.device)
                  for suffix, dtype in layer)
            for layer in entry_specs]
        self._lock = threading.Lock()
        self._free = list(range(self.num_blocks - 1, RESERVED_BLOCKS - 1,
                                -1))  # pop() hands out low ids first
        self._refs = {}            # block id -> list of holder tags
        self.allocs = 0
        self.frees = 0
        self.increfs = 0
        self.decrefs = 0
        self.failed_allocs = 0
        self.peak_allocated = 0

    # -- geometry ----------------------------------------------------------
    def blocks_for(self, num_tokens):
        """Blocks needed to hold `num_tokens` cache positions."""
        return max(1, math.ceil(num_tokens / self.block_size))

    @property
    def capacity_tokens(self):
        return (self.num_blocks - RESERVED_BLOCKS) * self.block_size

    # -- allocation --------------------------------------------------------
    def alloc(self, n, owner=None):
        """All-or-nothing allocation of `n` blocks held by `owner`."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if n > len(self._free):
                self.failed_allocs += 1
                raise OutOfBlocks(
                    f"pool exhausted: {n} block(s) requested, "
                    f"{len(self._free)} free of "
                    f"{self.num_blocks - RESERVED_BLOCKS} allocatable")
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._refs[b] = [owner]
            self.allocs += n
            self.peak_allocated = max(self.peak_allocated, len(self._refs))
            return blocks

    def incref(self, blocks, owner=None):
        """Add one `owner` reference to each allocated block."""
        with self._lock:
            for b in blocks:
                if b not in self._refs:
                    raise ValueError(f"block {b} is not allocated — cannot "
                                     f"add a reference")
            for b in blocks:
                self._refs[b].append(owner)
            self.increfs += len(blocks)

    def decref(self, blocks, owner=None):
        """Drop one `owner` reference per block; returns how many blocks
        were freed. Dropping a reference not held raises ValueError."""
        with self._lock:
            for b in blocks:
                holders = self._refs.get(b)
                if holders is None or owner not in holders:
                    raise ValueError(
                        f"block {b} holds no reference for owner {owner!r} "
                        f"(double-decref, or a reserved/unknown id)")
            freed = 0
            for b in blocks:
                holders = self._refs[b]
                holders.remove(owner)
                self.decrefs += 1
                if not holders:
                    del self._refs[b]
                    self._free.append(b)
                    self.frees += 1
                    freed += 1
            return freed

    def refcount(self, block):
        with self._lock:
            return len(self._refs.get(block, ()))

    def free(self, blocks):
        """Return exclusively held blocks. Double frees, reserved/unknown
        ids and shared blocks raise ValueError."""
        with self._lock:
            for b in blocks:
                holders = self._refs.get(b)
                if holders is None:
                    raise ValueError(f"block {b} is not allocated "
                                     f"(double-free, or a reserved/unknown "
                                     f"id)")
                if len(holders) != 1:
                    raise ValueError(f"block {b} is SHARED ({len(holders)} "
                                     f"refs) — use decref()")
            for b in blocks:
                del self._refs[b]
                self._free.append(b)
            self.decrefs += len(blocks)
            self.frees += len(blocks)

    def free_owned(self, owner):
        """Drop every reference `owner` holds; returns how many. Idempotent."""
        with self._lock:
            dropped = 0
            for b in [b for b, hs in self._refs.items() if owner in hs]:
                holders = self._refs[b]
                n = holders.count(owner)
                self._refs[b] = holders = [h for h in holders if h != owner]
                dropped += n
                self.decrefs += n
                if not holders:
                    del self._refs[b]
                    self._free.append(b)
                    self.frees += 1
            return dropped

    def copy_block(self, src, dst):
        """Copy block `src`'s rows into block `dst` in every layer tensor
        (in place)."""
        for layer in self.tensors:
            for t in layer:
                t[dst] = t[src]

    @property
    def free_count(self):
        with self._lock:
            return len(self._free)

    @property
    def allocated_count(self):
        with self._lock:
            return len(self._refs)

    # -- observability -----------------------------------------------------
    def stats(self):
        """Snapshot; asserts ``allocated + free + reserved == total``."""
        with self._lock:
            allocated = len(self._refs)
            free = len(self._free)
            assert allocated + free + RESERVED_BLOCKS == self.num_blocks, (
                f"block conservation violated: {allocated} allocated + "
                f"{free} free + {RESERVED_BLOCKS} reserved != "
                f"{self.num_blocks} total")
            return {
                "name": self.name,
                "total": self.num_blocks,
                "reserved": RESERVED_BLOCKS,
                "block_size": self.block_size,
                "quant": self.quant,
                "free": free,
                "allocated": allocated,
                "shared_blocks": sum(1 for hs in self._refs.values()
                                     if len(hs) > 1),
                "peak_allocated": self.peak_allocated,
                "allocs": self.allocs,
                "frees": self.frees,
                "increfs": self.increfs,
                "decrefs": self.decrefs,
                "failed_allocs": self.failed_allocs,
                "utilization": allocated / max(
                    1, self.num_blocks - RESERVED_BLOCKS),
            }

    def __repr__(self):
        s = self.stats()
        tag = f"[{self.name}]" if self.name else ""
        return (f"BlockKVCache{tag}(total={s['total']}, free={s['free']}, "
                f"allocated={s['allocated']}, block_size={self.block_size}, "
                f"quant={self.quant!r}, device={self.device})")
