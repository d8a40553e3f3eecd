"""Block-sparse flash attention (counterpart of
paddle_tpu/ops/pallas/block_sparse_attention.py).

The token-level CSR pattern of `nn.functional.sparse_attention` is
coarsened to a table of ``block_size`` x ``block_size`` tiles
(`csr_to_block_tables`); `block_sparse_attention` then runs an online
softmax of every query block over only the key blocks its row of the
table lists, so work and bytes scale with the listed tiles, not S^2.

* `block_sparse_attention_ref` is the plain version, the reference's
  dense-per-active-block `_bs_reference`: the listed K/V blocks gathered,
  entries past ``block_cnt`` masked, rows with no live key exactly 0, p
  normalised and cast to q's dtype before the PV product.
* `block_sparse_attention` is a `torch.autograd.Function`. Its forward
  launches ``csrc/block_sparse_attention.cu`` for a CUDA q (the TPU
  kernel `_bs_pallas`; a shape the kernel does not take raises) and
  computes the plain version for a CPU q. Its backward is autograd
  through the plain version on the saved inputs, as the reference's
  `_bs_bwd_rule`: the JAX package has no backward kernel here. The
  counter ``block_sparse_attention.launches`` counts kernel launches,
  ``.routes`` the launches of each body.
* `block_sparse_route` names the body a launch takes: BS_WGMMA (the flash
  forward's Hopper body under the block-table policy, `bs_fwd_sm90`) for
  bf16 at 32 < D <= 128 with D % 8 == 0 and 16-byte aligned operands,
  BS_MMA (`bs_fwd`, mma.sync) otherwise (f32, D <= 32, 128 < D <= 256).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["block_sparse_attention", "block_sparse_attention_ref",
           "csr_to_block_tables", "block_sparse_route", "BS_MMA",
           "BS_WGMMA"]

_NEG_INF = -1e30
_KERNEL_BLOCK = 128      # the tile of the kernel's CTA (and of the op)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's two bodies (`block_sparse_route`; the C entry's routes)
BS_MMA, BS_WGMMA = 0, 1


def csr_to_block_tables(offset, columns, seq_len, block_size):
    """Host-side: token CSR pattern (offset [S+1], columns [nnz]) ->
    (block_idx [nq, max_nb] int32 padded with 0, block_cnt [nq] int32,
    exact: bool), the reference's values: each row of block_idx lists the
    key blocks of its query block in increasing order, max_nb >= 1.

    `exact` is True when every listed tile holds all block_size^2 distinct
    (row, col) pairs, i.e. the pattern is exactly a union of whole tiles.
    Vectorised: when every row lists its columns in increasing order (no
    pair twice) the pairs of a tile are counted directly; otherwise the
    nonzeros' (tile, pair) keys are sorted to drop repeats."""
    offset = np.asarray(offset).ravel().astype(np.int64)
    nq = seq_len // block_size
    counts = np.diff(offset[:seq_len + 1])
    rows = np.repeat(np.arange(seq_len, dtype=np.int64), counts)
    cols = np.asarray(columns).ravel()[offset[0]:offset[seq_len]].astype(
        np.int64)
    kb = cols // block_size
    nk = max(seq_len // block_size, int(kb.max()) + 1 if kb.size else 0)
    tile = (rows // block_size) * nk + kb
    increasing = np.diff(cols) > 0
    if not (increasing | (rows[1:] != rows[:-1])).all():
        pair = (rows % block_size) * block_size + cols % block_size
        keys = np.unique(tile * (block_size * block_size) + pair)
        tile = keys // (block_size * block_size)
    per_tile = np.bincount(tile, minlength=nq * nk)
    tiles = np.flatnonzero(per_tile)               # sorted by (qb, kb)
    exact = bool((per_tile[tiles] == block_size * block_size).all())
    q_of, k_of = tiles // nk, tiles % nk
    cnt = np.bincount(q_of, minlength=nq).astype(np.int32)
    max_nb = int(cnt.max()) if cnt.size and cnt.max() > 0 else 1
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    idx = np.zeros((nq, max_nb), np.int32)
    idx[q_of, np.arange(tiles.size) - start[q_of]] = k_of
    return idx, cnt, exact


def block_sparse_attention_ref(q, k, v, block_idx, block_cnt, scale,
                               block_size):
    """Plain version: q/k/v [BH, S, D]; block_idx [nq, max_nb], block_cnt
    [nq]. Gathers only the listed blocks (compute O(nq * max_nb *
    block_size^2)); returns [BH, S, D] in q's dtype."""
    bh, s, d = q.shape
    bs = block_size
    nq, max_nb = block_idx.shape
    idx = block_idx.to(q.device, torch.long)
    cnt = block_cnt.to(q.device, torch.long)
    qb = q.reshape(bh, nq, bs, d)
    kg = k.reshape(bh, s // bs, bs, d)[:, idx]       # [BH, nq, max_nb, bs, d]
    vg = v.reshape(bh, s // bs, bs, d)[:, idx]
    logits = torch.einsum("bnqd,bnmkd->bnqmk", qb.float(), kg.float()) \
        * scale
    alive = torch.arange(max_nb, device=q.device)[None, :] < cnt[:, None]
    logits = torch.where(alive[None, :, None, :, None], logits, _NEG_INF)
    flat = logits.reshape(bh, nq, bs, max_nb * bs)
    m = flat.amax(-1, keepdim=True)
    p = torch.exp(flat - m)
    p = torch.where(flat <= _NEG_INF / 2, 0.0, p)
    den = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    p = (p / den).to(q.dtype)
    out = torch.einsum("bnqmk,bnmkd->bnqd",
                       p.reshape(bh, nq, bs, max_nb, bs).float(), vg.float())
    return out.reshape(bh, s, d).to(q.dtype)


def _check(q, k, v, block_idx, block_cnt, block_size):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be equal [BH, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, S, _ = q.shape
    if S % block_size:
        raise ValueError(f"S={S} is not a multiple of block_size="
                         f"{block_size}")
    if block_idx.dim() != 2 or block_idx.shape[0] != S // block_size \
            or tuple(block_cnt.shape) != (S // block_size,):
        raise ValueError(f"block_idx must be [{S // block_size}, max_nb] "
                         f"and block_cnt [{S // block_size}], got "
                         f"{tuple(block_idx.shape)}, "
                         f"{tuple(block_cnt.shape)}")


def block_sparse_route(q, k, v, scale=1.0):
    """The body a launch on contiguous q, k, v [BH, S, D] takes:
    BS_WGMMA (bf16 throughout, 32 < D <= 128, D % 8 == 0, a positive
    scale, 16-byte aligned bases: what the Hopper body's tensor maps
    describe) or BS_MMA. The wrapper launches exactly what this returns."""
    d = q.shape[-1]
    hopper = (32 < d <= 128 and not d % 8 and scale > 0
              and all(t.dtype == torch.bfloat16 and not t.data_ptr() % 16
                      for t in (q, k, v)))
    return BS_WGMMA if hopper else BS_MMA


def _launch(q, k, v, block_idx, block_cnt, scale, block_size):
    """One kernel launch on q's device: O [BH, S, D] in q's dtype, on the
    body `block_sparse_route` names."""
    BH, S, D = q.shape
    if block_size != _KERNEL_BLOCK:
        raise ValueError(f"the block-sparse kernel takes block_size "
                         f"{_KERNEL_BLOCK}, got {block_size}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the block-sparse kernel takes f32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D > 256:
        raise ValueError(f"the block-sparse kernel takes head dim <= 256, "
                         f"got {D}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    idx = block_idx.to(q.device, torch.int32).contiguous()
    cnt = block_cnt.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    if BH == 0:
        return out
    route = block_sparse_route(q, k, v, scale)
    # the Hopper body's work list: the tiles' order and a counter
    scratch = (torch.empty(S // block_size + 1, dtype=torch.int32,
                           device=q.device) if route == BS_WGMMA else None)
    ctx, stream = _build.launch_on(q.device)
    with ctx:
        err = _build.lib().ptt_block_sparse_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            cnt.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), BH, S, D,
            idx.shape[1], _build.dtype_code(q.dtype), route,
            ctypes.c_float(scale), stream)
    _build.check(err, "block_sparse_attention")
    block_sparse_attention.launches += 1
    block_sparse_attention.routes[route] += 1
    return out


def _forward(q, k, v, block_idx, block_cnt, scale, block_size):
    if q.device.type == "cpu":
        return block_sparse_attention_ref(q, k, v, block_idx, block_cnt,
                                          scale, block_size)
    if q.device.type != "cuda":
        raise RuntimeError(f"block_sparse_attention: no kernel for device "
                           f"{q.device}")
    return _launch(q, k, v, block_idx, block_cnt, scale, block_size)


class _BlockSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_idx, block_cnt, scale, block_size):
        ctx.save_for_backward(q, k, v, block_idx, block_cnt)
        ctx.scale, ctx.block_size = scale, block_size
        return _forward(q, k, v, block_idx, block_cnt, scale, block_size)

    @staticmethod
    def backward(ctx, g):
        q, k, v, block_idx, block_cnt = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = block_sparse_attention_ref(*leaves, block_idx, block_cnt,
                                             ctx.scale, ctx.block_size)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention(q, k, v, block_idx, block_cnt, scale,
                           block_size):
    """q/k/v [BH, S, D]; block_idx [nq, max_nb] int32 (padded), block_cnt
    [nq] int32 (S = nq * block_size). Returns [BH, S, D] in q's dtype;
    differentiable in q, k and v."""
    _check(q, k, v, block_idx, block_cnt, block_size)
    return _BlockSparse.apply(q, k, v, block_idx, block_cnt, float(scale),
                              int(block_size))


block_sparse_attention.launches = 0
#: launches of each body (`block_sparse_route`'s codes)
block_sparse_attention.routes = {BS_MMA: 0, BS_WGMMA: 0}
