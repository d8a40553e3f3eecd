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
  (`ops.short_attention`; on a CPU tensor their plain versions). The JAX
  package gates this route behind an environment switch and a TPU, where
  XLA's fused composed path was faster; eagerly, the composed path writes
  [B, H, S, S] scores, probabilities and a mask through device memory in
  every layer, so here the kernels are the route;
* any other dropout (a mask, a shape the kernels do not take, p = 1):
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
"""
from __future__ import annotations

import torch

from ...ops import _dropout_rng
from ...ops.flash_attention import (flash_attention as _flash_kernel,
                                    flash_attention_ref,
                                    flash_attention_supported)
from ...ops.short_attention import composed_attention, short_attention
from ...ops.short_attention import supported as short_attention_supported
from ...ops.short_attention import supports_p

__all__ = ["apply_rotary_pos_emb", "scaled_dot_product_attention",
           "flash_attention"]


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
                and short_attention_supported(tuple(query.shape), None,
                                              query.dtype)):
            return short_attention(query, key, value, seed, dropout_p,
                                   causal)
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
