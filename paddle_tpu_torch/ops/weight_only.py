"""Weight-only int8 / int4 matrix product (counterpart of
paddle_tpu/ops/pallas/weight_only.py).

``out[m, n] = (x[m, k] . dequant(qweight)[n, k]^T) * scale[n]`` with f32
accumulation, the scale applied once per output, the result in x's dtype.
`qweight` is ``[n, k]`` int8, or for ``weight_dtype="int4"`` ``[n, k/2]``
halves-packed nibbles (`paddle_tpu_torch.nn.quant._pack_int4`).

`weight_only_matmul` launches ``csrc/weight_only.cu`` for CUDA tensors at
every ``m`` (the TPU kernel's block-shape cut-offs were VMEM tiling limits
and do not apply) and computes `weight_only_matmul_ref` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["weight_only_matmul", "weight_only_matmul_nd",
           "weight_only_matmul_ref", "unpack_int4"]


def unpack_int4(p):
    """[n, k/2] halves-packed int8 -> [n, k] int8: arithmetic shifts
    sign-extend both two's-complement nibbles."""
    p32 = p.to(torch.int32)
    high = p32 >> 4
    low = (p32 << 28) >> 28
    return torch.cat([low, high], dim=1).to(torch.int8)


def _check(x, qweight, scale, weight_dtype):
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    if x.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"x must be [m, k] and qweight [n, k(/2)], got "
                         f"{tuple(x.shape)} and {tuple(qweight.shape)}")
    m, k = x.shape
    n, kw = qweight.shape
    int4 = weight_dtype == "int4"
    if (int4 and kw * 2 != k) or (not int4 and kw != k):
        raise ValueError(
            f"weight_only_matmul: qweight width {kw} inconsistent with "
            f"k={k} for weight_dtype={weight_dtype!r}")
    if qweight.dtype != torch.int8:
        raise TypeError(f"qweight must be int8, got {qweight.dtype}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be [{n}] (per output channel), got "
                         f"{tuple(scale.shape)}")
    return m, n, k


def weight_only_matmul_ref(x, qweight, scale, weight_dtype="int8"):
    """Plain version: unpack, dequantize, f32 product, scale, cast."""
    _check(x, qweight, scale, weight_dtype)
    q = unpack_int4(qweight) if weight_dtype == "int4" else qweight
    out = x.to(torch.float32) @ q.to(torch.float32).t()
    return (out * scale.to(torch.float32)).to(x.dtype)


def weight_only_matmul(x, qweight, scale, weight_dtype="int8"):
    """x [m, k] f32/bf16/f16; qweight [n, k] int8 or [n, k/2] packed int4;
    scale [n] f32 -> [m, n] in x's dtype. A CPU input takes the plain
    version; a CUDA input launches the kernel (or raises)."""
    m, n, k = _check(x, qweight, scale, weight_dtype)
    if x.device.type == "cpu":
        return weight_only_matmul_ref(x, qweight, scale, weight_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"weight_only_matmul: no kernel for device "
                           f"{x.device}")
    for name, t in (("qweight", qweight), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"x must be f32/bf16/f16, got {x.dtype}")
    x = x.contiguous()
    if not (qweight.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qweight and scale must be contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.ptt_weight_only_matmul(
            x.data_ptr(), qweight.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, n, k, _build.dtype_code(x.dtype),
            int(weight_dtype == "int4"),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "weight_only_matmul")
    weight_only_matmul.launches += 1
    return out


weight_only_matmul.launches = 0


def weight_only_matmul_nd(x, qweight, scale, weight_dtype="int8"):
    """Rank-N wrapper: flattens the leading dims of x to m."""
    lead = x.shape[:-1]
    out = weight_only_matmul(x.reshape(-1, x.shape[-1]), qweight, scale,
                             weight_dtype)
    return out.reshape(*lead, qweight.shape[0])
