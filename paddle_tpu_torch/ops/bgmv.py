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
  tensor the hand-written kernel ``csrc/bgmv.cu`` (shrink then expand,
  each output row reduced in an order that does not depend on the batch),
  on a CPU tensor its plain version `lora_delta_ref`;
* any other shape raises ValueError.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["lora_delta", "lora_delta_ref"]


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
    if not 1 <= r <= 128:
        raise ValueError(f"the kernel takes rank 1..128, got {r}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    ids = ids.contiguous()
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((bsz, s, d_out), dtype=torch.float32, device=x.device)
    if bsz == 0 or s == 0 or d_out == 0:
        return out
    h = torch.empty((bsz, s, r), dtype=torch.float32, device=x.device)
    lib = _build.lib()
    ctx, stream = _build.launch_on(x.device)
    with ctx:
        err = lib.ptt_bgmv(
            x.data_ptr(), x.stride(0), x.stride(1), A.data_ptr(),
            B.data_ptr(), ids.data_ptr(), h.data_ptr(), out.data_ptr(), bsz,
            s, d_in, r, d_out, slots, _build.dtype_code(x.dtype), stream)
    _build.check(err, "lora_delta")
    lora_delta.launches += 1
    return out


lora_delta.launches = 0
