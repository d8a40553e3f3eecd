"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

Routing follows the JAX package's rules, on the tensors' device:

* under an active `distributed.context_parallel_guard` whose mesh has a
  cp axis > 1, self-attention shapes (q, k and v of one shape) go
  to `distributed.context_parallel.context_parallel_attention` — the
  flash ring (the position-masked kernels) on CUDA when the shard's shape
  passes `_ring_flash_shapes_ok`, the plain ring otherwise, or Ulysses;
  attention dropout in training and any `attn_mask` raise there, as in
  JAX;
* training-mode dropout with no mask, self-attention shapes that the
  short-attention kernels admit (`ops.short_attention.supported` and
  `supports_p`): the short-attention kernels, dropout drawn inside them
  (`ops.short_attention`; on a CPU tensor their plain versions). A CUDA
  tensor of such a shape in a dtype the kernels do not take (fp16)
  raises TypeError, as the flash kernels' wrapper does. The JAX
  package gates this route behind an environment switch and a TPU, where
  XLA's fused composed path was faster; eagerly, the composed path writes
  [B, H, S, S] scores, probabilities and a mask through device memory in
  every layer, so here the kernels are the route;
* any other dropout (a mask, a shape the kernels do not take, p = 1,
  an fp16 CPU tensor):
  the composed path (`ops.short_attention.composed_attention`, the
  kernels' plain version), drawing its mask from the same bit stream
  (`ops._dropout_rng`);
* `attn_mask` without dropout: the same composed path with the additive
  bias;
* otherwise self-attention whose q, k and v share one shape that
  `flash_attention_supported` admits runs the FlashAttention-2 kernels on
  the GPU (`ops.flash_attention`); every other call takes the plain
  version (`ops.flash_attention.flash_attention_ref`).

Each dropout call draws a new stream seed from the caller's
`torch.Generator` (torch's default generator of the device when None), as
the JAX package draws a key per call. The rules are shape rules: a kernel
error is raised, never caught.

`sparse_attention` (CSR-pattern attention) and `flash_attn_unpadded`
(ragged batches by cumulative lengths) follow their own JAX rules, stated
in their docstrings.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...amp import amp_op
from ...ops import _dropout_rng
from ...ops.block_sparse_attention import (block_sparse_attention,
                                           csr_to_block_tables)
from ...ops.flash_attention import (flash_attention as _flash_kernel,
                                    flash_attention_ref,
                                    flash_attention_supported)
from ...ops.short_attention import composed_attention, short_attention
from ...ops.short_attention import supported as short_attention_supported
from ...ops.short_attention import supports_p

__all__ = ["apply_rotary_pos_emb", "scaled_dot_product_attention",
           "flash_attention", "flash_attn_unpadded", "sparse_attention"]

_SPARSE_BLOCK = 128      # the tile of the block route (attention.py:239)


@amp_op("sdpa")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Layout [batch, seq, num_heads, head_dim]; k and v may have fewer
    heads (GQA) or another length (the plain versions serve those).
    `attn_mask` is an additive float bias broadcast to [B, H, Sq, Sk];
    `generator` is where a dropout call draws its stream seed."""
    causal = bool(is_causal)
    from ...distributed.context_parallel import (active_context_parallel,
                                                 context_parallel_attention)
    cp = active_context_parallel()
    if (cp is not None and cp[0].size > 1
            and query.shape == key.shape == value.shape):
        # (cross-attention / cache-decode shapes fall through to the dense
        # paths — ring/Ulysses assume sequence-sharded self-attention)
        mesh, mode = cp
        if dropout_p > 0.0 and training:
            raise NotImplementedError(
                f"context-parallel attention ({mode}) does not support attention-probability dropout; "
                "set attention dropout to 0 (residual/hidden dropout is "
                "unaffected) or disable context_parallel")
        if attn_mask is not None:
            raise NotImplementedError(
                "context-parallel attention supports only causal/full "
                "masks; arbitrary attn_mask would be silently wrong under "
                "sequence sharding — pass is_causal instead")
        return context_parallel_attention(query, key, value, mesh, mode=mode,
                                          causal=causal)
    if dropout_p > 0.0 and training:
        seed = _dropout_rng.draw_seed(generator, query.device)
        if (attn_mask is None and supports_p(dropout_p)
                and query.shape == key.shape == value.shape
                and short_attention_supported(tuple(query.shape))):
            if short_attention_supported(tuple(query.shape), None,
                                         query.dtype):
                return short_attention(query, key, value, seed, dropout_p,
                                       causal)
            if query.is_cuda:
                raise TypeError(
                    f"short attention kernels take float32 or bfloat16, got "
                    f"{query.dtype} (fp16 training of the attention "
                    f"layers is not on a kernel: train in bf16)")
        return composed_attention(query, key, value, attn_mask, causal,
                                  dropout_p, seed)[0]
    if attn_mask is not None:
        return composed_attention(query, key, value, attn_mask, causal)[0]
    if (query.is_cuda and query.shape == key.shape == value.shape
            and flash_attention_supported(tuple(query.shape), is_causal)):
        return _flash_kernel(query, key, value, causal=causal)
    return flash_attention_ref(query, key, value, causal=causal)[0]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Reference signature of F.flash_attention; returns (out, None)."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attention(return_softmax=True): the flash kernels do not "
            "materialize attention probabilities; recompute them with "
            "scaled_dot_product_attention-style math if needed")
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _host(t):
    """A host numpy copy of an index tensor or array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@amp_op("flash_attn_unpadded")
def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Varlen attention (reference signature): query [total_q, H, D],
    key/value [total_k, H, D], sequence i spanning rows cu_seqlens[i] ..
    cu_seqlens[i + 1]. Returns (out [total_q, H, D], None).

    As the JAX package does it, outside any kernel: the tokens are packed
    into a padded [n_seq, max_seqlen, H, D] batch (gather indices built on
    the host from the concrete lengths), attended with the length and
    causal masks as a -1e30 bias (f32 scores and softmax, output in q's
    dtype), and scattered back; padded slots carry zeros. Work is
    O(n_seq * max_seqlen^2), not O(total^2). Attention dropout and
    returned probabilities are refused (the reference ignores both)."""
    if dropout:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not implemented "
            "(the JAX reference ignores the argument)")
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True): probabilities are "
            "not materialized")
    q, k, v = query, key, value
    dev = q.device
    cu_q = _host(cu_seqlens_q).astype(np.int64)
    cu_k = _host(cu_seqlens_k).astype(np.int64)
    mq, mk = int(max_seqlen_q), int(max_seqlen_k)
    # gather tables: padded slot (i, t) <- flat token cu[i] + t (clamped);
    # pad slots point at a real token and are masked by the length mask
    idx_q = np.minimum(cu_q[:-1, None] + np.arange(mq)[None],
                       max(q.shape[0] - 1, 0))
    idx_k = np.minimum(cu_k[:-1, None] + np.arange(mk)[None],
                       max(k.shape[0] - 1, 0))
    len_q = torch.from_numpy(cu_q[1:] - cu_q[:-1]).to(dev)
    len_k = torch.from_numpy(cu_k[1:] - cu_k[:-1]).to(dev)
    idx_q = torch.from_numpy(idx_q).to(dev)
    idx_k = torch.from_numpy(idx_k).to(dev)
    qp, kp, vp = q[idx_q], k[idx_k], v[idx_k]          # [n, m, H, D]
    valid_q = torch.arange(mq, device=dev)[None] < len_q[:, None]
    valid_k = torch.arange(mk, device=dev)[None] < len_k[:, None]
    mask = valid_q[:, :, None] & valid_k[:, None, :]    # [n, mq, mk]
    if causal:
        mask = mask & (torch.arange(mq, device=dev)[:, None]
                       >= torch.arange(mk, device=dev)[None, :])
    bias = torch.where(mask, 0.0, -1e30)[:, None]       # [n, 1, mq, mk]
    scores = torch.matmul(qp.float().transpose(1, 2),
                          kp.float().permute(0, 2, 3, 1)) * float(scale)
    p = torch.softmax(scores + bias, dim=-1)
    out = torch.matmul(p, vp.float().transpose(1, 2)).transpose(1, 2)
    out = torch.where(valid_q[..., None, None], out, 0.0).to(q.dtype)
    flat = torch.zeros((q.shape[0],) + tuple(out.shape[2:]), dtype=q.dtype,
                       device=dev)
    flat = flat.index_add(0, idx_q.reshape(-1),
                          out.reshape((-1,) + tuple(out.shape[2:])))
    return flat, None


@amp_op("sparse_attention")
def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """CSR-pattern attention (reference signature). q/k/v [B, H, S, D];
    offset [B, H, S + 1], columns [B, H, nnz] (torch tensors or arrays):
    row r of head (b, h) attends exactly its listed columns.
    key_padding_mask [B, S] is added at each column, attn_mask [S, S] at
    (r, c); both additive.

    The JAX routing: when one CSR is shared by every (b, h), both masks
    are None, S % 128 == 0 and the pattern is an exact union of 128 x 128
    tiles, the block route — `ops.block_sparse_attention` with scale
    1 / sqrt(D), the hand-written kernel on the GPU. Otherwise the SDDMM
    route: flat (bh, row, col) triples built on the host, scores for those
    pairs only, a segment softmax over the rows (scatter_reduce amax and
    sum, the denominator guarded by max(den, 1e-30)) and a scatter of
    p * v — plain PyTorch, as in the JAX package (no kernel there). Neither
    route forms a dense S x S score matrix."""
    q, k, v = query, key, value
    B, H, S, D = q.shape
    off = _host(sparse_csr_offset).astype(np.int64).reshape(B * H, S + 1)
    col = _host(sparse_csr_columns).reshape(B * H, -1)
    scale = 1.0 / math.sqrt(D)

    shared = bool((off == off[0]).all() and (col == col[0]).all())
    if (shared and key_padding_mask is None and attn_mask is None
            and S % _SPARSE_BLOCK == 0):
        bidx, bcnt, exact = csr_to_block_tables(off[0], col[0], S,
                                                _SPARSE_BLOCK)
        if exact:
            out = block_sparse_attention(
                q.reshape(B * H, S, D), k.reshape(B * H, S, D),
                v.reshape(B * H, S, D),
                torch.from_numpy(bidx).to(q.device),
                torch.from_numpy(bcnt).to(q.device), scale, _SPARSE_BLOCK)
            return out.reshape(B, H, S, D)
    return _sddmm_attention(q, k, v, off, col, key_padding_mask, attn_mask,
                            scale)


def _sddmm_attention(q, k, v, off, col, key_padding_mask, attn_mask, scale):
    """The SDDMM + segment-softmax route (the reference's
    `_sddmm_attn_impl`), in q's dtype."""
    B, H, S, D = q.shape
    dev = q.device
    counts = np.diff(off, axis=1)                       # [BH, S]
    per_head = counts.sum(1)
    bh = torch.from_numpy(np.repeat(np.arange(B * H), per_head)).to(dev)
    r = torch.from_numpy(np.repeat(np.tile(np.arange(S), B * H),
                                   counts.ravel())).to(dev)
    live = np.arange(col.shape[1])[None, :] < per_head[:, None]
    c = torch.from_numpy(col[live].astype(np.int64)).to(dev)
    qf, kf, vf = (t.reshape(B * H, S, D) for t in (q, k, v))
    scores = (qf[bh, r] * kf[bh, c]).sum(-1) * scale
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=dev)
        scores = scores + kpm.reshape(B, S)[bh // H, c]
    if attn_mask is not None:
        scores = scores + torch.as_tensor(attn_mask, device=dev)[r, c]
    rows = bh * S + r
    nrows = B * H * S
    # the max only shifts the exponent: its gradient cancels
    mx = torch.zeros(nrows, dtype=scores.dtype, device=dev).scatter_reduce(
        0, rows, scores.detach(), "amax", include_self=False)
    ex = torch.exp(scores - mx[rows])
    den = torch.zeros(nrows, dtype=ex.dtype, device=dev).scatter_reduce(
        0, rows, ex, "sum", include_self=False)
    p = ex / torch.clamp_min(den[rows], 1e-30)
    out = torch.zeros((nrows, D), dtype=vf.dtype, device=dev).index_add(
        0, rows, p[:, None].to(vf.dtype) * vf[bh, c])
    return out.reshape(B, H, S, D)


@amp_op("rope")
def apply_rotary_pos_emb(q, k, position_ids, theta=10000.0):
    """Half-split (LLaMA) rotary embedding on [B, S, H, D] q and k at
    position_ids [B, S]; the trigonometry is f32, the result cast back."""
    half = q.shape[-1] // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=q.device) / half))
    angles = position_ids.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1 = x[..., :half].to(torch.float32)
        x2 = x[..., half:].to(torch.float32)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)
