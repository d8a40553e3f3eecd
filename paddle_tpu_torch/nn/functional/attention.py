"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py).

Routing follows the JAX package's rule: self-attention on the
accelerator whose q, k and v share one shape that
`flash_attention_supported` admits runs the FlashAttention-2 kernels
(`ops.flash_attention`); every other call — CPU tensors, cross-attention
or GQA shapes, short sequences — takes the plain version
(`ops.flash_attention.flash_attention_ref`). The rule is a shape rule: a
kernel error is raised, never caught.
"""
from __future__ import annotations

import torch

from ...ops.flash_attention import (flash_attention as _flash_kernel,
                                    flash_attention_ref,
                                    flash_attention_supported)

__all__ = ["apply_rotary_pos_emb", "scaled_dot_product_attention",
           "flash_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Layout [batch, seq, num_heads, head_dim]; k and v may have fewer
    heads (GQA) or another length (the plain version serves those)."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention-probability dropout is not ported yet (ROADMAP "
            "Queue 2 #7, the short-attention kernels); set attention "
            "dropout to 0")
    if attn_mask is not None:
        raise NotImplementedError("scaled_dot_product_attention(attn_mask=)"
                                  " is not ported yet; pass is_causal")
    if (query.is_cuda and query.shape == key.shape == value.shape
            and flash_attention_supported(tuple(query.shape), is_causal)):
        return _flash_kernel(query, key, value, causal=bool(is_causal))
    return flash_attention_ref(query, key, value,
                               causal=bool(is_causal))[0]


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
