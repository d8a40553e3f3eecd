"""Normalisation (counterpart of paddle_tpu/nn/functional/norm.py):
statistics in f32, the result cast back to the input's dtype.

A row's statistics do not depend on how many rows share the call. PyTorch's
CUDA reduction sets the threads it gives each row by the row count, so a
plain `mean` over a long last dim can round a row differently alone and in
a batch, and a decode step's RMSNorm then differs by a bf16 ulp between
buckets. `_row_mean` sums fixed chunks of `_CHUNK` elements first and then
the chunk sums, which keeps a row's bits at any row count
(tests/test_torch_cuda.py holds this at widths 768 and 4096); so the
decode engine's rows are the same in every decode bucket."""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]

#: elements per first-stage chunk of a row reduction (see `_row_mean`)
_CHUNK = 128


def _row_mean(x):
    """Mean over the last dim (kept), summed in an order that does not
    depend on the leading dims; a width that is not a multiple of `_CHUNK`
    takes the plain mean."""
    d = x.shape[-1]
    if d % _CHUNK:
        return x.mean(dim=-1, keepdim=True)
    parts = x.reshape(*x.shape[:-1], d // _CHUNK, _CHUNK).sum(dim=-1)
    return parts.sum(dim=-1, keepdim=True) / d


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last dim, f32 statistics, affine in f32, then
    cast to x's dtype (the JAX fused forward `_ln_fused_fwd`)."""
    xf = x.to(torch.float32)
    mean = _row_mean(xf)
    var = _row_mean((xf - mean).square())
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
    ms = _row_mean(xf.square())
    return (xf / torch.sqrt(ms + epsilon)).to(x.dtype) * weight
