"""Batched gather LoRA matmul, BGMV (counterpart of
paddle_tpu/ops/pallas/bgmv.py).

One call applies every sequence's own low-rank adapter:

    delta[b] = (x[b] @ A[ids[b]]) @ B[ids[b]]

with the adapter stacks A ``[slots, d_in, r]`` / B ``[slots, r, d_out]``
(f32, slot 0 all zeros = "no adapter", B pre-scaled by alpha/r) and f32
accumulation; the result is f32 ``[batch, s, d_out]``.

`lora_delta` takes ``ids`` as the JAX function does:

* a scalar (one adapter for the whole call: a prefill chunk) — a plain
  gather and two `torch.matmul`s, as the JAX package computes it outside
  any Pallas kernel;
* ``[batch]`` (one slot per row: the batched decode step) — on a CUDA
  tensor the hand-written kernel ``csrc/bgmv.cu`` in the body
  `bgmv_route` names (s = 1: one launch of a thread block cluster a
  sequence; s > 1: shrink then expand), each output row reduced in an
  order fixed by the shape alone, never by the batch; on a CPU tensor its
  plain version `lora_delta_ref`;
* any other shape raises ValueError.

`lora_delta.launches` counts the kernel calls, `lora_delta.routes` the
calls of each body (one launch on the cluster body, two on the other).
"""
from __future__ import annotations

import torch

from . import _build
from ._counts import count

__all__ = ["lora_delta", "lora_delta_ref", "bgmv_route",
           "bgmv_cluster_plan", "ROUTE_TWO_LAUNCH", "ROUTE_CLUSTER"]

#: the bodies of ``csrc/bgmv.cu``'s entry: shrink then expand (two
#: launches), and one launch of a thread block cluster a sequence (s = 1)
ROUTE_TWO_LAUNCH, ROUTE_CLUSTER = 0, 1
MAX_RANK = 128


def bgmv_cluster_plan(d_in, r, d_out):
    """The cluster body's cut of one sequence's work: (KC CTAs a
    cluster, rows of d_in a CTA, columns of d_out a CTA, a multiple of 4).
    A pure function of (d_in, r, d_out), never of the batch or the ids,
    so each output row is summed in the same order at every batch size:
    16 CTAs (a non-portable cluster size) where a slot's A and B hold at
    least 256 KB, else 8."""
    kc = 16 if (d_in + d_out) * r >= 1 << 16 else 8
    rows = -(-d_in // kc)
    cols = -(-(-(-d_out // kc)) // 4) * 4
    return kc, rows, cols


def bgmv_route(x, r, d_in, d_out):
    """The body a CUDA call of `lora_delta` with [batch] ids takes for x
    [batch, s, d_in]: ROUTE_CLUSTER for a decode step (s = 1), else
    ROUTE_TWO_LAUNCH. It reads neither the batch size nor the ids, so a
    row's bits do not depend on its batchmates. (d_in, r and d_out fix the
    cluster body's plan, `bgmv_cluster_plan`.)"""
    if x.shape[1] == 1 and 1 <= r <= MAX_RANK and d_in >= 1 and d_out >= 1:
        return ROUTE_CLUSTER
    return ROUTE_TWO_LAUNCH


def lora_delta_ref(x, A, B, ids):
    """Plain version of the batched path: gather the slots in f32, two
    einsums."""
    a = A[ids.long()].to(torch.float32)                   # [b, d_in, r]
    b = B[ids.long()].to(torch.float32)                   # [b, r, d_out]
    h = torch.einsum("bsd,bdr->bsr", x.to(torch.float32), a)
    return torch.einsum("bsr,bro->bso", h, b)


def lora_delta(x, A, B, ids):
    """x [batch, s, d_in] f32/bf16; A [slots, d_in, r] f32; B [slots, r,
    d_out] f32; ids an int32 scalar or [batch] tensor on x's device ->
    f32 [batch, s, d_out]."""
    if not torch.is_tensor(ids):
        ids = torch.as_tensor(ids, dtype=torch.int32, device=x.device)
    if ids.dim() == 0:
        a = A[ids.long()].to(torch.float32)               # [d_in, r]
        b = B[ids.long()].to(torch.float32)               # [r, d_out]
        return torch.matmul(torch.matmul(x.to(torch.float32), a), b)
    if x.dim() != 3:
        raise ValueError(f"x must be [batch, s, d_in], got {tuple(x.shape)}")
    bsz, s, d_in = x.shape
    slots, a_in, r = A.shape
    d_out = B.shape[-1]
    if tuple(ids.shape) != (bsz,):
        raise ValueError(f"ids must be scalar or [batch], got "
                         f"{tuple(ids.shape)} for batch {bsz}")
    if a_in != d_in or tuple(B.shape[:2]) != (slots, r):
        raise ValueError(f"A {tuple(A.shape)} / B {tuple(B.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lora_delta_ref(x, A, B, ids)
    if x.device.type != "cuda":
        raise RuntimeError(f"lora_delta: no kernel for device {x.device}")
    for name, t in (("A", A), ("B", B), ("ids", ids)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"A and B must be float32 slot stacks, got "
                        f"{A.dtype} / {B.dtype}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("A and B must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32/bf16, got {x.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"the kernel takes rank 1..{MAX_RANK}, got {r}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    ids = ids.contiguous()
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((bsz, s, d_out), dtype=torch.float32, device=x.device)
    if bsz == 0 or s == 0 or d_out == 0:
        return out
    route = bgmv_route(x, r, d_in, d_out)
    plan, h = (0, 0, 0), None
    if route == ROUTE_CLUSTER:
        plan = bgmv_cluster_plan(d_in, r, d_out)
    else:
        h = torch.empty((bsz, s, r), dtype=torch.float32, device=x.device)
    lib = _build.lib()
    ctx, stream = _build.launch_on(x.device)
    with ctx:
        err = lib.ptt_bgmv(
            x.data_ptr(), x.stride(0), x.stride(1), A.data_ptr(),
            B.data_ptr(), ids.data_ptr(), None if h is None else h.data_ptr(),
            out.data_ptr(), bsz, s, d_in, r, d_out, slots,
            _build.dtype_code(x.dtype), route, *plan, stream)
    _build.check(err, "lora_delta")
    count(lora_delta, route)
    return out


lora_delta.launches = 0
#: calls of each body (`bgmv_route`'s codes)
lora_delta.routes = {ROUTE_TWO_LAUNCH: 0, ROUTE_CLUSTER: 0}
