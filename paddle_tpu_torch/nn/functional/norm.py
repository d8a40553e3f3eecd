"""Normalisation (counterpart of paddle_tpu/nn/functional/norm.py):
statistics in f32, the result cast back to the input's dtype."""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last dim, f32 statistics, affine in f32, then
    cast to x's dtype (the JAX fused forward `_ln_fused_fwd`)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim: f32 mean square, normalise, cast back to
    x's dtype, THEN multiply by the weight (the JAX `_rms_norm_impl`)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf / torch.sqrt(ms + epsilon)).to(x.dtype) * weight
