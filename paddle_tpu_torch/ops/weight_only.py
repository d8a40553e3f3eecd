"""Weight-only int8 / int4 matrix product (counterpart of
paddle_tpu/ops/pallas/weight_only.py).

``out[m, n] = (x[m, k] . dequant(qweight)[n, k]^T) * scale[n]`` with f32
accumulation, the scale applied once per output, the result in x's dtype.
`qweight` is ``[n, k]`` int8, or for ``weight_dtype="int4"`` ``[n, k/2]``
halves-packed nibbles (`paddle_tpu_torch.nn.quant._pack_int4`).

`weight_only_matmul` launches ``csrc/weight_only.cu`` for CUDA tensors at
every ``m`` (the TPU kernel's block-shape cut-offs were VMEM tiling limits
and do not apply) and computes `weight_only_matmul_ref` for CPU tensors,
through the operator ``paddle_tpu_torch::weight_only_matmul``
(`weight_only_matmul_op`, see `_library`), so an exported program that
reaches it dispatches by the device it runs on.
`weight_only_route` names the kernel a CUDA call takes: the wgmma GEMM of
prefill chunks (m > 16), the row-stable tensor-core GEMV of the decode
buckets (m <= 16), or, for what neither admits (f32 x, unaligned x,
k % 64 != 0), the CUDA-core GEMV.

`row_gemv` is the float-weight GEMV of the decode buckets (``m <= 16``):
``x[m, k] . w[n, k]^T + bias`` with x, w and bias of one float dtype, the
kernel's rows each summed in one order whatever m is, so a decode row is
bit-identical in every batch (cuBLAS may choose its reduction by m). It
is not the port of a TPU kernel; it keeps the JAX engine's bit-identity
across batch sizes. `row_gemv_route` names its body: the tensor-core body
(bf16 / f16, k % 64 == 0, a 16-byte aligned weight) or the CUDA-core one.
Its plain version is `row_gemv_ref`.
"""
from __future__ import annotations

import torch

from . import _build, _library
from ._counts import count

__all__ = ["weight_only_matmul", "weight_only_matmul_op",
           "weight_only_matmul_nd",
           "weight_only_matmul_ref", "weight_only_route", "unpack_int4",
           "row_gemv", "row_gemv_ref", "row_gemv_route", "ROW_GEMV_MAX_M",
           "ROUTE_GEMV", "ROUTE_DECODE", "ROUTE_PREFILL", "ROW_CUDA_CORE",
           "ROW_MMA"]

#: the largest m `row_gemv` is for: the decode buckets
ROW_GEMV_MAX_M = 16
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
#: route codes of ``csrc/weight_only.cu``'s entry
ROUTE_GEMV, ROUTE_DECODE, ROUTE_PREFILL = 0, 1, 2
#: body codes of ``ptt_row_gemv``: the CUDA-core and the tensor-core GEMV
ROW_CUDA_CORE, ROW_MMA = 0, 1


def weight_only_route(m, k, dtype, aligned=True):
    """The kernel a CUDA call of `weight_only_matmul` takes for x of
    ``m`` rows, ``k`` columns and `dtype`, with ``aligned`` telling whether
    x and qweight start on 16 bytes: ROUTE_PREFILL (the wgmma GEMM) for
    m > 16 and ROUTE_DECODE (the row-stable tensor-core GEMV) for m <= 16
    when x is bf16 or f16, aligned and k % 64 == 0; ROUTE_GEMV (the
    CUDA-core GEMV) otherwise. The decision never depends on m within the
    decode buckets, so their rows stay bit-identical across batch sizes."""
    if dtype in (torch.bfloat16, torch.float16) and aligned and k % 64 == 0:
        return ROUTE_DECODE if m <= ROW_GEMV_MAX_M else ROUTE_PREFILL
    return ROUTE_GEMV


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


def _wo_cuda(x, qweight, scale, weight_dtype):
    """The operator's CUDA implementation: the kernel's launch."""
    m, n, k = _check(x, qweight, scale, weight_dtype)
    dev = x.device
    if qweight.device != dev or scale.device != dev:
        raise ValueError(f"qweight is on {qweight.device} and scale on "
                         f"{scale.device}, x on {dev}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"x must be f32/bf16/f16, got {x.dtype}")
    x = x.contiguous()
    if not (qweight.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qweight and scale must be contiguous")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    xp, wp = x.data_ptr(), qweight.data_ptr()
    route = weight_only_route(m, k, x.dtype, xp % 16 == 0 and wp % 16 == 0)
    lib = _build.lib()
    ctx, stream = _build.launch_on(dev)
    with ctx:
        err = lib.ptt_weight_only_matmul(
            xp, wp, scale.data_ptr(), out.data_ptr(), m, n, k,
            _build.dtype_code(x.dtype), int(weight_dtype == "int4"), route,
            stream)
    _build.check(err, "weight_only_matmul")
    count(weight_only_matmul, route)
    return out


def _wo_fake(x, qweight, scale, weight_dtype):
    return x.new_empty((x.shape[0], qweight.shape[0]))


def _wo_vmap(info, in_dims, x, qweight, scale, weight_dtype):
    """vmap folds the mapped axis of x into its rows, and each example
    keeps the route its own call takes (`weight_only_route` reads m): an
    example of at most ROW_GEMV_MAX_M rows is served by the decode GEMV
    over the fold in launches of at most that many rows (a row's bits do
    not depend on the rows beside it), a larger one by one launch of the
    whole fold (the wgmma GEMM, as its own call)."""
    if in_dims[1] is not None or in_dims[2] is not None:
        raise ValueError("weight_only_matmul maps over x only: the weight "
                         "and its scales are shared")
    n = info.batch_size
    d = in_dims[0]
    x = x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
    rows = x.reshape(-1, x.shape[-1])
    if x.shape[1] <= ROW_GEMV_MAX_M < rows.shape[0]:
        out = torch.cat([weight_only_matmul_op(c, qweight, scale,
                                               weight_dtype)
                         for c in rows.split(ROW_GEMV_MAX_M)])
    else:
        out = weight_only_matmul_op(rows, qweight, scale, weight_dtype)
    return out.unflatten(0, (n, -1)), 0


def _wo_setup(ctx, inputs, output):
    x, qweight, scale, weight_dtype = inputs
    ctx.save_for_backward(qweight, scale)
    ctx.weight_dtype, ctx.x_dtype = weight_dtype, x.dtype


def _wo_backward(ctx, grad):
    """dx of the plain version's f32 arithmetic, rounded to x's dtype."""
    qweight, scale = ctx.saved_tensors
    q = unpack_int4(qweight) if ctx.weight_dtype == "int4" else qweight
    dx = (grad.to(torch.float32) * scale.to(torch.float32)) \
        @ q.to(torch.float32)
    return dx.to(ctx.x_dtype), None, None, None


#: ``paddle_tpu_torch::weight_only_matmul`` (`_library`): the CUDA launch,
#: the plain version on the CPU, the shape on fake tensors
weight_only_matmul_op = _library.define(
    "weight_only_matmul",
    "(Tensor x, Tensor qweight, Tensor scale, str weight_dtype) -> Tensor",
    cpu=weight_only_matmul_ref, cuda=_wo_cuda, fake=_wo_fake, vmap=_wo_vmap,
    backward=_wo_backward, setup_context=_wo_setup)


def weight_only_matmul(x, qweight, scale, weight_dtype="int8"):
    """x [m, k] f32/bf16/f16; qweight [n, k] int8 or [n, k/2] packed int4;
    scale [n] f32 -> [m, n] in x's dtype, through the
    `weight_only_matmul_op` operator: a CPU input takes the plain
    version, a CUDA input launches the kernel (or raises)."""
    _check(x, qweight, scale, weight_dtype)
    return weight_only_matmul_op(x, qweight, scale, weight_dtype)


weight_only_matmul.launches = 0
#: launches of each route (`weight_only_route`'s codes)
weight_only_matmul.routes = {ROUTE_GEMV: 0, ROUTE_DECODE: 0, ROUTE_PREFILL: 0}


def weight_only_matmul_nd(x, qweight, scale, weight_dtype="int8"):
    """Rank-N wrapper: flattens the leading dims of x to m."""
    lead = x.shape[:-1]
    out = weight_only_matmul(x.reshape(-1, x.shape[-1]), qweight, scale,
                             weight_dtype)
    return out.reshape(*lead, qweight.shape[0])


def row_gemv_ref(x, weight, bias=None):
    """Plain version of `row_gemv`: an f32 product plus the bias, rounded
    once to x's dtype."""
    out = x.float() @ weight.float().t()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def row_gemv_route(x, weight):
    """The body a CUDA call of `row_gemv` takes for x [..., k] and weight
    [n, k]: ROW_MMA (the tensor-core GEMV) when both are bf16 or both f16,
    k % 64 == 0 and the weight starts on 16 bytes; ROW_CUDA_CORE
    otherwise. It reads neither m nor x's address (the wrapper copies a
    misaligned x), so every decode bucket of a Linear takes one body and
    its rows stay bit-identical across batch sizes."""
    if (x.dtype in (torch.bfloat16, torch.float16)
            and weight.dtype == x.dtype and x.shape[-1] % 64 == 0
            and weight.data_ptr() % 16 == 0):
        return ROW_MMA
    return ROW_CUDA_CORE


def row_gemv(x, weight, bias=None):
    """x [..., k] and weight [n, k] (bias [n]) of one float dtype ->
    [..., n]: the row-stable GEMV kernel for CUDA tensors (at most
    `ROW_GEMV_MAX_M` rows; the body `row_gemv_route` names), the plain
    version for CPU ones."""
    if x.shape[-1] != weight.shape[-1] or weight.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} do not chain")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be [{weight.shape[0]}], got "
                         f"{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return row_gemv_ref(x, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"row_gemv: no kernel for device {x.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"row_gemv takes f32/bf16/f16, got {x.dtype}")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    m, n = x2.shape[0], weight.shape[0]
    if m > ROW_GEMV_MAX_M:
        raise ValueError(f"row_gemv is for at most {ROW_GEMV_MAX_M} rows, "
                         f"got {m}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel():
        w = weight.contiguous()
        b = bias.contiguous() if bias is not None else None
        route = row_gemv_route(x2, w)
        if route == ROW_MMA and x2.data_ptr() % 16:
            x2 = x2.clone()
        ctx, stream = _build.launch_on(x.device)
        with ctx:
            err = _build.lib().ptt_row_gemv(
                x2.data_ptr(), w.data_ptr(),
                b.data_ptr() if b is not None else None, out.data_ptr(), m,
                n, k, _build.dtype_code(x.dtype), route, stream)
        _build.check(err, "row_gemv")
        count(row_gemv, route)
    return out.reshape(*lead, n)


row_gemv.launches = 0
#: launches of each body (`row_gemv_route`'s codes)
row_gemv.routes = {ROW_CUDA_CORE: 0, ROW_MMA: 0}
