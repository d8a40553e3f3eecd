"""Attention helpers (counterpart of paddle_tpu/nn/functional/attention.py);
this slice needs only rotary embeddings."""
from __future__ import annotations

import torch

__all__ = ["apply_rotary_pos_emb"]


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
