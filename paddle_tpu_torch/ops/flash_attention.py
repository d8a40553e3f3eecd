"""FlashAttention-2 forward and backward (counterpart of
paddle_tpu/ops/pallas/flash_attention.py, its `_fwd` / `_bwd` kernels and
the differentiable `flash_attention`).

Three kernels in ``csrc/flash_attention.cu``, each behind a wrapper with
a ``.launches`` counter:

* `flash_attention_fwd` — ``(O, lse)``: online softmax in f32, P cast to
  the input dtype before PV, lse ``[B, H, S]`` f32 for the backward;
* `flash_attention_bwd_dq` — ``dQ`` over K blocks;
* `flash_attention_bwd_dkv` — ``(dK, dV)`` over Q blocks.

`flash_attention` ties them together in a `torch.autograd.Function`; the
backward's ``delta = rowsum(dO * O)`` is a PyTorch f32 rowsum, as the TPU
version computes it outside Pallas. Tensors are ``[B, S, H, D]`` and are
read through their strides (a unit stride along D), so the model's
fused-QKV views reach the kernels without a copy; a ragged S and any
D <= 256 are masked inside the kernels instead of padded.

A CUDA input launches the kernels (bf16 or f32; any other dtype raises
`TypeError`); a CPU input computes the plain versions,
`flash_attention_ref`, `flash_attention_bwd_dq_ref` and
`flash_attention_bwd_dkv_ref` — f32 math with the kernels' casts.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_supported",
           "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv_ref",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "attention_delta"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_FWD, _DQ, _DKV = 0, 1, 2


def _ceil_to(x, m):
    return (x + m - 1) // m * m


def flash_attention_supported(q_shape, causal=True):
    """The JAX package's routing predicate, unchanged: S >= 128, D <= 256
    and the 128-padded S times D within 2**20."""
    b, s, h, d = q_shape
    s_pad = _ceil_to(max(s, 128), 128)
    return s >= 128 and d <= 256 and s_pad * d <= (1 << 20)


def _mask(sq, sk, causal, device):
    """[sq, sk] bool: keys a query row may see (global indices)."""
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None]
    return rows >= torch.arange(sk, device=device)[None, :]


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_ref(q, k, v, *, causal=True, scale=None):
    """Plain version of the forward: f32 scores and softmax, the
    probabilities cast to q's dtype before PV (the kernels' cast).
    q [B, Sq, H, D]; k, v [B, Sk, Hkv, D] with H % Hkv == 0; the causal
    mask is ``row >= col`` on global indices. Returns (out [B, Sq, H, D]
    in q's dtype, lse [B, H, Sq] f32). Differentiable by autograd."""
    scale = _scale(q, scale)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _mask(q.shape[1], k.shape[1], causal, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, do, lse, delta, causal, scale):
    """What both backward kernels recompute: P = exp(s - lse) masked
    after the exp, and dS = P (dP - delta) scale cast to the input
    dtype; f32 otherwise."""
    scale = _scale(q, scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    keep = _mask(q.shape[1], k.shape[1], causal, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return qf, kf, dof, p, ds


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=True,
                               scale=None):
    """Plain version of the dq kernel: dQ = dS K, f32 accumulation,
    in q's dtype. lse, delta [B, H, S] f32."""
    _, kf, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal=True,
                                scale=None):
    """Plain version of the dkv kernel: dV = P^T dO with P in the input
    dtype, dK = dS^T Q; f32 accumulation, in q's dtype."""
    qf, _, dof, p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, do, lse, delta, *, causal=True,
                            scale=None):
    """Plain version of the whole backward: (dq, dk, dv) in q's dtype."""
    kw = dict(causal=causal, scale=scale)
    return (flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
            *flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))


def _check(q, *others):
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"shapes differ: {tuple(q.shape)} vs "
                             f"{tuple(t.shape)}")
    if q.shape[-1] > 256:
        raise ValueError(f"head dim {q.shape[-1]} > 256 is not supported")


def _cuda_operands(q, *others):
    """Device / dtype checks of a kernel launch; returns the operands with
    a unit stride along D (a copy only where the caller's has none)."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: no kernel for device "
                           f"{q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    out = []
    for t in (q, *others):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"operands must share q's device and dtype "
                             f"({q.device}, {q.dtype}), got {t.device}, "
                             f"{t.dtype}")
        out.append(t if t.stride(-1) == 1 else t.contiguous())
    return out


def _launch(kind, q, k, v, dout, lse, delta, out0, out1, lse_out, causal,
            scale):
    B, S, H, D = q.shape
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *(dout.stride()[:3] if dout is not None else (0, 0, 0))]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention(
            kind, ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta),
            ptr(out0), ptr(out1), ptr(lse_out), B, S, H, D, *strides,
            _build.dtype_code(q.dtype), scale, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")[kind])


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """q, k, v [B, S, H, D] -> (O [B, S, H, D] in q's dtype, lse
    [B, H, S] f32)."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    q, k, v = _cuda_operands(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _launch(_FWD, q, k, v, None, None, None, out, None, lse, causal, scale)
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_rows(q, lse, delta):
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, H, S] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return lse.contiguous(), delta.contiguous()


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           scale=None):
    """dQ [B, S, H, D] from the forward's lse and delta = rowsum(dO * O),
    both [B, H, S] f32."""
    _check(q, k, v, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                          causal=causal, scale=scale)
    q, k, v, do = _cuda_operands(q, k, v, do)
    lse, delta = _bwd_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    _launch(_DQ, q, k, v, do, lse, delta, dq, None, None, causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            scale=None):
    """(dK, dV) [B, S, H, D] from the forward's lse and delta."""
    _check(q, k, v, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                           causal=causal, scale=scale)
    q, k, v, do = _cuda_operands(q, k, v, do)
    lse, delta = _bwd_rows(q, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dk, dv
    _launch(_DKV, q, k, v, do, lse, delta, dk, dv, None, causal, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B, S, H, D] -> [B, H, S]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = attention_delta(out, do)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Differentiable flash attention on [B, S, H, D] (q, k and v of one
    shape; k and v are cast to q's dtype, as in the JAX version)."""
    _check(q, k, v)
    k, v = k.to(q.dtype), v.to(q.dtype)
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale))
