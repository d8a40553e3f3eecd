"""Normalisation (counterpart of paddle_tpu/nn/functional/norm.py):
statistics in f32, the result cast back to the input's dtype.

A row's statistics do not depend on how many rows share the call. PyTorch's
CUDA reduction sets the threads it gives each row by the row count, so a
plain `mean` over a long last dim can round a row differently alone and in
a batch, and a decode step's RMSNorm then differs by a bf16 ulp between
buckets. `_row_mean` sums fixed chunks of `_CHUNK` elements first and then
the chunk sums, which keeps a row's bits at any row count
(tests/test_torch_cuda.py holds this at widths 768 and 4096); so the
decode engine's rows are the same in every decode bucket.

`batch_norm` is `torch.nn.functional.batch_norm` (cuDNN's or PyTorch's
own kernels): training normalises with the biased batch variance and
blends the running stats as Paddle does, ``running * m + batch * (1 - m)``
with ``m = 0.9`` and the unbiased variance (torch's ``momentum = 1 - m``
is the same blend); inference normalises with the running stats. Under a
bf16 compute dtype the running buffers stay f32 (the JAX engine does not
cast them either) and gamma/beta arrive in bf16, so they are taken in f32:
PyTorch's mixed-type batch norm (bf16 data, f32 parameters and
statistics)."""
from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["batch_norm", "layer_norm", "rms_norm", "update_running_stats"]

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


@amp_op("layer_norm")
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


@amp_op("rms_norm")
def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim: f32 mean square, normalise, cast back to
    x's dtype, THEN multiply by the weight (the JAX `_rms_norm_impl`)."""
    xf = x.to(torch.float32)
    ms = _row_mean(xf.square())
    return (xf / torch.sqrt(ms + epsilon)).to(x.dtype) * weight


_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


@amp_op("batch_norm_train")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm over every dim but the channel's (the last one for
    NHWC / NLC / NDHWC, else dim 1). In training (unless
    `use_global_stats`) the running stats, when given, are updated in
    place with Paddle's `momentum`."""
    channel_last = data_format in _CHANNEL_LAST
    xc = x.movedim(-1, 1) if channel_last else x
    use_stats = (not training) if use_global_stats is None \
        else bool(use_global_stats)
    stat_dtype = running_mean.dtype if running_mean is not None \
        else torch.float32
    if xc.dtype != stat_dtype:
        weight = None if weight is None else weight.to(stat_dtype)
        bias = None if bias is None else bias.to(stat_dtype)
    out = torch.nn.functional.batch_norm(
        xc, running_mean, running_var, weight, bias, training=not use_stats,
        momentum=1.0 - momentum, eps=epsilon)
    return out.movedim(1, -1) if channel_last else out


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, momentum, n):
    """Paddle's running-stat blend with the unbiased variance, in place
    (shared with the fused bottleneck route of models/resnet.py)."""
    unbiased = var * (n / max(n - 1, 1))
    running_mean.copy_(running_mean * momentum + mean * (1 - momentum))
    running_var.copy_(running_var * momentum + unbiased * (1 - momentum))
