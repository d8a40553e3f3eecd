"""Weight-only quantized linear (counterpart of paddle_tpu/nn/quant.py).

The weight lives as int8 (or halves-packed int4) with per-output-channel
f32 scales; with per-channel scales every call goes to
`ops.weight_only.weight_only_matmul` — the CUDA kernel for a CUDA input at
any ``m``, its plain version for a CPU input — so only quantized bytes are
read from device memory. Grouped scales (``group_size != -1``) are computed
as a plain dequantize and product, as the JAX package does outside its
kernel.

Layouts follow the JAX package: `weight_quantize` takes an ``[in, out]``
float weight and returns ``[out, in]`` int8 (``[out, in/2]`` packed int4)
plus ``[out]`` (or ``[groups, out]``) f32 scales.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.weight_only import unpack_int4, weight_only_matmul_nd

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_inference"]

_QMAX = {"int8": 127.0, "int4": 7.0}


def weight_quantize(x, algo="weight_only_int8", group_size=-1):
    """Per-output-channel (or per-group) absmax quantization of an
    ``[in, out]`` weight, computed in f32. Returns ``(q, scale)``: q is
    ``[out, in]`` int8, or ``[out, in/2]`` halves-packed for
    ``weight_only_int4``; scale is ``[out]`` (``[in/group, out]``) f32."""
    dtype = algo.rsplit("_", 1)[-1]
    if dtype not in _QMAX:
        raise ValueError(f"unsupported algo {algo!r}")
    qmax = _QMAX[dtype]
    w = x.to(torch.float32)
    if group_size != -1:
        if w.shape[0] % group_size:
            raise ValueError(f"in-dim {w.shape[0]} not divisible by "
                             f"group_size {group_size}")
        g = w.reshape(w.shape[0] // group_size, group_size, w.shape[1])
        scale = g.abs().amax(dim=1) / qmax                  # [groups, out]
        q = torch.clamp(torch.round(g / scale.clamp_min(1e-8)[:, None, :]),
                        -qmax, qmax)
        q = q.reshape(w.shape).t().to(torch.int8)
    else:
        scale = w.abs().amax(dim=0) / qmax                  # [out]
        q = torch.clamp(torch.round(w / scale.clamp_min(1e-8)[None, :]),
                        -qmax, qmax).t().to(torch.int8)
    if dtype == "int4":
        q = _pack_int4(q)
    return q.contiguous(), scale.to(torch.float32)


def _pack_int4(q):
    """[out, in] int8 in [-7, 7] -> [out, in/2] halves-packed nibbles:
    byte j holds w[:, j] in the low nibble and w[:, in/2 + j] in the high
    one, both as raw two's-complement nibbles (the layout v2 of the JAX
    package, so a packed weight means the same in both)."""
    if q.shape[1] % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got "
                         f"{q.shape[1]}")
    k2 = q.shape[1] // 2
    low = torch.bitwise_and(q[:, :k2], 15)
    high = torch.bitwise_left_shift(q[:, k2:], 4)
    return torch.bitwise_or(low, high).to(torch.int8)


_unpack_int4 = unpack_int4


def weight_dequantize(weight, scale, algo="weight_only_int8", group_size=-1,
                      out_dtype=torch.float32):
    """Inverse of `weight_quantize`: [out, in] int8 (or packed int4) ->
    [in, out] float."""
    q = _unpack_int4(weight) if algo.endswith("int4") else weight
    w = q.t().to(out_dtype)
    if group_size != -1:
        g = w.reshape(w.shape[0] // group_size, group_size, w.shape[1])
        return (g * scale[:, None, :].to(out_dtype)).reshape(w.shape)
    return w * scale[None, :].to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", group_size=-1):
    """y = x @ dequant(weight).T + bias."""
    if weight_scale is None:
        raise ValueError("weight_scale is required")
    if group_size == -1:
        out = weight_only_matmul_nd(x, weight, weight_scale, weight_dtype)
    else:
        w = weight_dequantize(weight, weight_scale,
                              f"weight_only_{weight_dtype}", group_size,
                              out_dtype=x.dtype)
        out = x @ w
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


class WeightOnlyLinear(nn.Module):
    """Drop-in `nn.Linear` replacement holding the quantized weight
    (``quant_weight`` [out, in] int8 or [out, in/2] packed int4) and its
    scales (``quant_scale``) as buffers — the JAX layer's names."""

    def __init__(self, in_features, out_features, weight_dtype="int8",
                 group_size=-1, bias=True, device=None, dtype=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight_dtype = weight_dtype
        self.group_size = int(group_size)
        cols = in_features // 2 if weight_dtype == "int4" else in_features
        self.register_buffer("quant_weight", torch.zeros(
            out_features, cols, dtype=torch.int8, device=device))
        sshape = (in_features // group_size, out_features) \
            if group_size != -1 else (out_features,)
        self.register_buffer("quant_scale", torch.zeros(
            sshape, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    @classmethod
    def from_linear(cls, linear, weight_dtype="int8", group_size=-1):
        w = linear.weight                       # [out, in]
        lay = cls(w.shape[1], w.shape[0], weight_dtype=weight_dtype,
                  group_size=group_size, bias=linear.bias is not None,
                  device=w.device, dtype=w.dtype)
        with torch.no_grad():
            q, s = weight_quantize(w.t(), f"weight_only_{weight_dtype}",
                                   group_size=group_size)
            lay.quant_weight.copy_(q)
            lay.quant_scale.copy_(s)
            if linear.bias is not None:
                lay.bias.copy_(linear.bias)
        return lay

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, self.bias,
                                  self.quant_scale,
                                  weight_dtype=self.weight_dtype,
                                  group_size=self.group_size)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, weight_dtype={self.weight_dtype}, "
                f"group_size={self.group_size}")


@torch.no_grad()
def quantize_for_inference(model, weight_dtype="int8", group_size=-1,
                           min_features=256):
    """Swap every `nn.Linear` of `model` for a `WeightOnlyLinear` (in
    place), one layer at a time so the float weight of each is freed as
    soon as it is replaced. Layers smaller than `min_features` on either
    dim stay float — note that at test widths the default quantizes
    nothing (pass ``min_features=0``)."""
    for name, sub in list(model.named_modules()):
        if not isinstance(sub, nn.Linear):
            continue
        if min(sub.weight.shape) < min_features:
            continue
        parent = model
        parts = name.split(".")
        for p in parts[:-1]:
            parent = getattr(parent, p)
        setattr(parent, parts[-1],
                WeightOnlyLinear.from_linear(sub, weight_dtype, group_size))
    return model
