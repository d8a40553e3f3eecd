"""Short-sequence attention with attention-probability dropout inside the
kernels (counterpart of paddle_tpu/ops/pallas/short_attention.py: its
`short_attention`, `supported` and `supports_p`).

Two kernel wrappers over ``csrc/short_attention.cu``, each with a
``.launches`` counter:

* `short_attention_fwd` — ``(O, lse)``: replaces the TPU kernel
  `_fwd_kernel` (short_attention.py:73, through `_fwd_call`); bf16 inputs
  that the flash forward's Hopper body takes (32 < D <= 128, views TMA
  can describe) run that body with the dropout drawn inside, the rest the
  mma.sync body — `short_fwd_route` decides, ``.routes`` counts;
* `short_attention_bwd` — ``(dQ, dK, dV)``: replaces `_bwd_kernel`
  (:87, through `_bwd_rule`). One call is two launches, and its counter
  counts both: the dQ kernel, which first forms the row term
  ``D_i = sum_j P Z dP`` and stores it, then the dK/dV kernel, which
  reads it. The inputs the forward's Hopper body takes (and S <= 512)
  run the flash backward's Hopper bodies with the dropout replayed
  inside, the rest the mma.sync bodies — `short_bwd_route` decides,
  ``.routes`` counts launches by body.

`short_attention` ties them together in a `torch.autograd.Function`. The
dropout mask is never stored: it is a pure function of ``(seed, b, h, i,
j)`` (`_dropout_rng`), drawn inside the forward and replayed by the
backward. The backward keeps q, k, v, the seed and the forward's
``[B, H, S]`` f32 lse, nothing else. Tensors are ``[B, S, H, D]``, read
through their strides (a unit stride along D), so the model's fused-QKV
views reach the kernels without a transpose or a copy.

A CUDA input launches the kernels (bf16 or f32, any S with S % 8 == 0 and
S <= 512, D % 8 == 0 and D <= 256; anything else raises); a CPU input
computes the plain versions `short_attention_ref` and
`short_attention_bwd_ref` — f32 math with the kernels' casts and the same
mask.
"""
from __future__ import annotations

import math

import torch

from . import _build, _dropout_rng

__all__ = ["short_attention", "short_attention_fwd", "short_attention_bwd",
           "short_attention_ref", "short_attention_bwd_ref",
           "composed_attention", "supported", "supports_p",
           "short_fwd_route", "FWD_MMA", "FWD_WGMMA", "short_bwd_route",
           "BWD_MMA", "BWD_WGMMA"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_FWD = 0
#: the forward's two bodies, as kinds of ``csrc/short_attention.cu``
FWD_MMA, FWD_WGMMA = _FWD, 3
#: the backward's two bodies (`short_bwd_route`); the kinds that launch
#: each body's dQ then dK/dV kernels in one call
BWD_MMA, BWD_WGMMA = 0, 1
_BWD_KIND = (6, 7)
_KIND_NAMES = {0: "short_attention_fwd", 3: "short_attention_fwd",
               6: "short_attention_bwd", 7: "short_attention_bwd"}
MAX_S = 512
MAX_D = 256
_NEG = -1e30                    # the TPU kernel's causal mask value


def supported(q_shape, attn_mask=None, dtype=None) -> bool:
    """The JAX package's shape rule (S <= 512, S % 8 == 0, D % 8 == 0, no
    additive mask), plus what the card's kernels take: D <= 256 and, when
    a dtype is given, f32 or bf16."""
    B, S, H, D = q_shape
    return (S <= MAX_S and S % 8 == 0 and D % 8 == 0 and D <= MAX_D
            and attn_mask is None
            and (dtype is None or dtype in _KERNEL_DTYPES))


def supports_p(p) -> bool:
    """p = 1 would divide by zero in the keep scale; the composed path
    takes that case."""
    return 0.0 <= p < 1.0


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def _z(seed, s, p):
    """The dropout factor f32 in the shape of the scores `s` (None when
    p = 0)."""
    if p == 0.0:
        return None
    return _dropout_rng.dropout_mask(seed.to(s.device), *s.shape, p)


def _scores(q, k, causal, bias=None):
    """f32 s = (q . k) * scale [B, H, Sq, Sk], causal entries at -1e30,
    plus the additive `bias` (broadcast to [B, H, Sq, Sk]) in f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(q)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, torch.full((), _NEG, device=q.device))
    if bias is not None:
        if bias.dtype == torch.bool:
            raise TypeError("attn_mask must be an additive float bias "
                            "(0 where attended, a large negative value "
                            "where not), got a bool tensor")
        s = s + bias.to(device=q.device, dtype=torch.float32)
    return s


def composed_attention(q, k, v, bias=None, causal=False, p=0.0, seed=None):
    """Plain attention on [B, S, H, D] (the TPU kernel's `_fwd_kernel`,
    and the JAX package's `_sdpa_dropout` / `_sdpa_mask_impl`): f32
    scores with the causal mask and the additive `bias`, f32 softmax, the
    probabilities times the dropout factor of stream `seed` (when p > 0)
    cast to q's dtype, the product with V accumulated in f32. k and v may
    have fewer heads (GQA) or another length. Returns (out in q's dtype,
    lse [B, H, Sq] f32). Differentiable by autograd."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = _scores(q, k, causal, bias)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.softmax(s, dim=-1)
    z = _z(seed, s, p)
    if z is not None:
        probs = probs * z
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype), lse


def short_attention_ref(q, k, v, seed, p=0.0, causal=False):
    """Plain version of the forward: `composed_attention` with no bias.
    Returns (out [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    return composed_attention(q, k, v, None, causal, p, seed)


def short_attention_bwd_ref(q, k, v, do, lse, seed, p=0.0, causal=False):
    """Plain version of the backward (the TPU kernel's `_bwd_kernel`, with
    the probabilities from the forward's lse): dV = (P Z)^T dO, the row
    term D = rowsum(P Z dP), dS = P (dP Z - D) * scale cast to q's dtype,
    dQ = dS K, dK = dS^T Q; f32 accumulation, results in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(q.dtype).float()
    probs = torch.exp(_scores(q, k, causal) - lse[..., None])
    z = _z(seed, probs, p)
    pz = probs if z is None else probs * z
    dv = torch.einsum("bhqk,bqhd->bkhd", pz.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dpz = dp if z is None else dp * z
    row = (dpz * probs).sum(-1, keepdim=True)
    ds = (probs * (dpz - row) * _scale(q)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q, *others):
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"shapes differ: {tuple(q.shape)} vs "
                             f"{tuple(t.shape)}")


def _check_p(p):
    if not supports_p(p):
        raise ValueError(f"dropout p={p} outside [0, 1)")


def _check_cuda(q, seed, *others):
    """The launch's checks of the operands and of the seed (one int64 on
    q's device: contiguous in any shape)."""
    if q.device.type != "cuda":
        raise RuntimeError(f"short attention: no kernel for device "
                           f"{q.device}")
    dev, dt = q.device, q.dtype
    if not supported(q.shape, None, dt):
        raise ValueError(
            f"short attention kernels take f32 or bf16 [B, S, H, D] with "
            f"S <= {MAX_S}, S % 8 == 0, D % 8 == 0 and D <= {MAX_D}; got "
            f"{tuple(q.shape)} {dt}")
    for t in others:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"operands must share q's device and dtype "
                             f"({dev}, {dt}), got {t.device}, {t.dtype}")
    if seed.device != dev or seed.dtype != torch.int64 \
            or seed.numel() != 1:
        raise ValueError(f"seed must be one int64 on {q.device}, got "
                         f"{tuple(seed.shape)} {seed.dtype} on "
                         f"{seed.device}")


def short_fwd_route(q, k, v):
    """How a CUDA call of `short_attention_fwd` launches on q, k, v; the
    wrapper launches exactly what this returns: (route, ops, ptrs,
    strides). The route is FWD_WGMMA (the flash forward's Hopper body
    with the dropout drawn inside) where `_build.hopper_plan` admits the
    operands (bf16, 32 < D <= 128, D % 8 == 0, TMA-describable views) and
    S <= 512, FWD_MMA (the mma.sync body) otherwise. ops, ptrs and strides
    are the operands as launched (`_build.attention_views`)."""
    hopper, *views = _build.hopper_plan((q, k, v), _scale(q))
    return (FWD_WGMMA if hopper and q.shape[1] <= MAX_S else FWD_MMA,
            *views)


def short_bwd_route(q, k, v, do):
    """How a CUDA call of `short_attention_bwd` launches on q, k, v and
    dO; the wrapper launches exactly what this returns: (route, ops, ptrs,
    strides). The route is BWD_WGMMA (the flash backward's Hopper bodies
    with the keep bits replayed inside and the row term formed by the dQ
    kernel) where `_build.hopper_plan` admits the four operands (bf16,
    32 < D <= 128, D % 8 == 0, TMA-describable views) and S <= 512,
    BWD_MMA (the mma.sync bodies) otherwise: f32, D <= 32, D > 128 and
    views TMA cannot describe."""
    hopper, *views = _build.hopper_plan((q, k, v, do), _scale(q))
    return (BWD_WGMMA if hopper and q.shape[1] <= MAX_S else BWD_MMA,
            *views)


def _launch(kind, q, ptrs, strides, seed, lse, delta, out0, out1, p, causal,
            scale):
    """One call on the operands q, k, v (and dout for a backward) whose
    pointers and strides `_build.attention_views` fetched: one launch, or
    the backward's two (kinds 6 and 7: dQ, dK and dV into out0, a
    [3, B, S, H, D] tensor)."""
    dims = _build.attention_dims(q.shape, strides)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _build.lib()
    ctx, stream = _build.launch_on(q.device)
    with ctx:
        err = lib.ptt_short_attention(
            kind, ptrs[0], ptrs[1], ptrs[2], ptrs[3] if len(ptrs) > 3
            else None, seed.data_ptr(), ptr(lse), ptr(delta), ptr(out0),
            ptr(out1), dims, _build.dtype_code(q.dtype), scale,
            _dropout_rng.keep_scale(p), _dropout_rng.keep_threshold(p),
            int(p > 0.0), int(bool(causal)), stream)
    _build.check(err, _KIND_NAMES.get(kind, f"short attention kind {kind}"))


def short_attention_fwd(q, k, v, seed, p=0.0, causal=False):
    """q, k, v [B, S, H, D], seed int64 [1] -> (O [B, S, H, D] in q's
    dtype, lse [B, H, S] f32)."""
    _check(q, k, v)
    _check_p(p)
    if q.device.type == "cpu":
        return short_attention_ref(q, k, v, seed, p, causal)
    _check_cuda(q, seed, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    route, ops, ptrs, strides = short_fwd_route(q, k, v)
    _launch(route, ops[0], ptrs, strides, seed, lse, None, out, None, p,
            causal, _scale(q))
    short_attention_fwd.launches += 1
    short_attention_fwd.routes[route] += 1
    return out, lse


def short_attention_bwd(q, k, v, do, lse, seed, p=0.0, causal=False):
    """(dQ, dK, dV) [B, S, H, D] from the forward's lse [B, H, S] f32 and
    the same seed (the mask is replayed, not read)."""
    _check(q, k, v, do)
    _check_p(p)
    if q.device.type == "cpu":
        return short_attention_bwd_ref(q, k, v, do, lse, seed, p, causal)
    _check_cuda(q, seed, k, v, do)
    B, S, H, D = q.shape
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be [B, H, S] float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")
    lse = lse.contiguous()
    grads = torch.empty((3, B, S, H, D), dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return grads.unbind(0)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    route, ops, ptrs, strides = short_bwd_route(q, k, v, do)
    # one call launches dQ (which stores the row term), then dK/dV
    _launch(_BWD_KIND[route], ops[0], ptrs, strides, seed, lse, delta, grads,
            None, p, causal, _scale(q))
    short_attention_bwd.launches += 2
    short_attention_bwd.routes[route] += 2
    return grads.unbind(0)


short_attention_fwd.launches = 0
#: launches of each forward body (`short_fwd_route`'s codes)
short_attention_fwd.routes = {FWD_MMA: 0, FWD_WGMMA: 0}
short_attention_bwd.launches = 0
#: launches of each backward body (`short_bwd_route`'s codes; two a call)
short_attention_bwd.routes = {BWD_MMA: 0, BWD_WGMMA: 0}


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, p, causal):
        out, lse = short_attention_fwd(q, k, v, seed, p, causal)
        ctx.save_for_backward(q, k, v, seed, lse)
        ctx.p, ctx.causal = p, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed, lse = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, do.to(q.dtype), lse, seed,
                                         ctx.p, ctx.causal)
        return dq, dk, dv, None, None, None


def short_attention(q, k, v, seed, p=0.0, causal=False):
    """Differentiable short attention on [B, S, H, D] with dropout `p`
    drawn from the stream `seed` (an int64 tensor of one element; k and
    v are cast to q's dtype). Returns [B, S, H, D]."""
    _check(q, k, v)
    _check_p(p)
    k, v = k.to(q.dtype), v.to(q.dtype)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=q.device).reshape(1)
    return _ShortAttention.apply(q, k, v, seed, float(p), bool(causal))
