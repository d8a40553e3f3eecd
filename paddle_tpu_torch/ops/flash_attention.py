"""FlashAttention-2 forward and backward (counterpart of
paddle_tpu/ops/pallas/flash_attention.py, its `_fwd` / `_bwd` kernels and
the differentiable `flash_attention`).

Three kernels in ``csrc/flash_attention.cu``, each behind a wrapper with
a ``.launches`` counter:

* `flash_attention_fwd` — ``(O, lse)``: online softmax in f32, P cast to
  the input dtype before PV, lse ``[B, H, S]`` f32 for the backward; bf16
  inputs with 32 < D <= 128 take the Hopper body (TMA-fed wgmma, P in
  registers), the rest the mma.sync body — `flash_fwd_route` decides;
* `flash_attention_bwd_dq` — ``dQ`` over K blocks;
* `flash_attention_bwd_dkv` — ``(dK, dV)`` over Q blocks; on the same
  inputs as the forward's Hopper body, both run Hopper bodies of their own
  (dS and P^T in registers) — `flash_bwd_route` decides, and the
  wrappers' ``.routes`` count launches by body.

Three more kernels serve one step of ring attention
(`distributed.context_parallel`), the counterparts of the JAX package's
`flash_fwd_pos` and `flash_bwd_pos`: the causal mask compares explicit
int32 global positions (``q_pos[i] >= k_pos[j]``) instead of row and
column indices, because a zigzag shard's rows are not contiguous, and
``q`` and ``k`` may have different lengths:

* `flash_fwd_pos` — the UNMERGED partial ``(O, lse)`` of the local
  queries against one visiting K/V shard; a row that the mask hides
  throughout gives ``O = 0`` and ``lse = -1e30 + log(1e-30)`` (the TPU
  kernel's ``l_safe = max(l, 1e-30)``), so the merge gives it weight 0;
* `flash_bwd_pos_dq` and `flash_bwd_pos_dkv` (both in `flash_bwd_pos`) —
  one step's dQ and dK, dV from the GLOBAL merged lse and delta, each
  rounded to the input dtype as the TPU kernel's outputs are.

Where the whole-sequence kernels take their Hopper bodies and the two
shards are of one length (the ring's own case), these three run the same
Hopper bodies under a position-mask policy; otherwise (f32, head-dim tiles
32 and 256, Sq != Sk) the mma.sync bodies — `flash_pos_route` decides, and
the wrappers' ``.routes`` count launches by body.

The port keeps its [B, S, H, D] layout with lse [B, H, S] for these too
(JAX: [bh, s, d] and [bh, s, 1]).

`flash_attention` ties the first three together in a `torch.autograd.Function`; the
backward's ``delta = rowsum(dO * O)`` is a PyTorch f32 rowsum, as the TPU
version computes it outside Pallas. Tensors are ``[B, S, H, D]`` and are
read through their strides (a unit stride along D), so the model's
fused-QKV views reach the kernels without a copy; a ragged S and any
D <= 256 are masked inside the kernels instead of padded.

A CUDA input launches the kernels (bf16 or f32; any other dtype raises
`TypeError`); a CPU input computes the plain versions,
`flash_attention_ref`, `flash_attention_bwd_dq_ref`,
`flash_attention_bwd_dkv_ref`, `flash_fwd_pos_ref` and
`flash_bwd_pos_ref` — f32 math with the kernels' casts.

The forward is the operator ``paddle_tpu_torch::flash_fwd`` (`flash_fwd`,
see `_library`): its CUDA implementation is the launch, its CPU one the
plain version, so an exported program that reaches it dispatches by the
device it runs on. `flash_attention_fwd` checks the arguments and calls it.
"""
from __future__ import annotations

import math

import torch

from . import _build, _library
from ._counts import count

__all__ = ["flash_attention", "flash_attention_supported",
           "flash_fwd_route", "FWD_MMA", "FWD_WGMMA", "flash_bwd_route",
           "BWD_MMA", "BWD_WGMMA",
           "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv_ref",
           "flash_attention_fwd", "flash_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "attention_delta",
           "flash_pos_route", "flash_fwd_pos", "flash_bwd_pos",
           "flash_bwd_pos_dq",
           "flash_bwd_pos_dkv", "flash_fwd_pos_ref", "flash_bwd_pos_ref"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_FWD, _DQ, _DKV = 0, 1, 2
#: the forward's two bodies, as kinds of ``csrc/flash_attention.cu``
FWD_MMA, FWD_WGMMA = _FWD, 3
#: the backward's two bodies (`flash_bwd_route`); the kinds they launch
BWD_MMA, BWD_WGMMA = 0, 1
_DQ_KIND = (_DQ, 4)
_DKV_KIND = (_DKV, 5)
_NEG_INF = -1e30                 # the TPU kernels' mask value


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


def _bwd_probs(q, k, v, do, lse, delta, keep, scale):
    """What both backward kernels recompute: P = exp(s - lse) masked
    after the exp (`keep` [Sq, Sk] bool or None), and dS = P (dP - delta)
    scale cast to the input dtype; f32 otherwise."""
    scale = _scale(q, scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return qf, kf, dof, p, ds


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=True,
                               scale=None):
    """Plain version of the dq kernel: dQ = dS K, f32 accumulation,
    in q's dtype. lse, delta [B, H, S] f32."""
    keep = _mask(q.shape[1], k.shape[1], causal, q.device)
    _, kf, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, keep, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal=True,
                                scale=None):
    """Plain version of the dkv kernel: dV = P^T dO with P in the input
    dtype, dK = dS^T Q; f32 accumulation, in q's dtype."""
    keep = _mask(q.shape[1], k.shape[1], causal, q.device)
    return _dkv_from_probs(q, *_bwd_probs(q, k, v, do, lse, delta, keep,
                                          scale))


def _dkv_from_probs(q, qf, kf, dof, p, ds):
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


def _check_cuda(q, *others):
    """Device / dtype checks of a kernel launch."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: no kernel for device "
                           f"{q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    dev, dt = q.device, q.dtype
    for t in others:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"operands must share q's device and dtype "
                             f"({dev}, {dt}), got {t.device}, {t.dtype}")


def flash_fwd_route(q, k, v, scale=1.0):
    """How a CUDA call of `flash_attention_fwd` launches on q, k, v; the
    wrapper launches exactly what this returns: (route, ops, ptrs,
    strides). The route is FWD_WGMMA (the Hopper body: TMA tensor maps
    over the strides, wgmma) where `_build.hopper_plan` admits the
    operands, FWD_MMA (the mma.sync body) otherwise: f32, head-dim tiles
    32 and 256, and views TMA cannot describe. ops, ptrs and strides are
    the operands as launched (`_build.attention_views`)."""
    hopper, *views = _build.hopper_plan((q, k, v), scale)
    return (FWD_WGMMA if hopper else FWD_MMA, *views)


def flash_bwd_route(q, k, v, do, scale=1.0):
    """How a CUDA call of `flash_attention_bwd_dq` or
    `flash_attention_bwd_dkv` launches on q, k, v and dO; the wrappers
    launch exactly what this returns: (route, ops, ptrs, strides), the
    route BWD_WGMMA (their Hopper bodies) where `_build.hopper_plan`
    admits the four operands (the forward's conditions), BWD_MMA (the
    mma.sync bodies) otherwise."""
    hopper, *views = _build.hopper_plan((q, k, v, do), scale)
    return (BWD_WGMMA if hopper else BWD_MMA, *views)


def _launch(kind, q, ptrs, strides, lse, delta, out0, out1, lse_out, causal,
            scale):
    """One launch on the operands q, k, v (and dout for a backward) whose
    pointers and strides `_build.attention_views` fetched."""
    dims = _build.attention_dims(q.shape, strides)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _build.lib()
    ctx, stream = _build.launch_on(q.device)
    with ctx:
        err = lib.ptt_flash_attention(
            kind, ptrs[0], ptrs[1], ptrs[2], ptrs[3] if len(ptrs) > 3
            else None, ptr(lse), ptr(delta), ptr(out0), ptr(out1),
            ptr(lse_out), dims, _build.dtype_code(q.dtype), scale,
            int(bool(causal)), stream)
    _build.check(err, ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")[kind % 3])


def _fwd_cuda(q, k, v, causal, scale):
    """The operator's CUDA implementation: the kernel's launch."""
    _check_cuda(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    route, ops, ptrs, strides = flash_fwd_route(q, k, v, scale)
    _launch(route, ops[0], ptrs, strides, None, None, out, None, lse, causal,
            scale)
    count(flash_attention_fwd, route)
    return out, lse


def _fwd_cpu(q, k, v, causal, scale):
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)


def _fwd_fake(q, k, v, causal, scale):
    B, S, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, S), dtype=torch.float32)


def _fwd_vmap(info, in_dims, q, k, v, causal, scale):
    """vmap folds the mapped axis into B: one launch for every example."""
    n = info.batch_size

    def fold(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:])

    out, lse = flash_fwd(*(fold(t, d) for t, d in zip((q, k, v), in_dims)),
                         causal, scale)
    return (out.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


#: ``paddle_tpu_torch::flash_fwd`` (`_library`): the CUDA launch, the
#: plain version on the CPU, the shapes on fake tensors
flash_fwd = _library.define(
    "flash_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
    "-> (Tensor, Tensor)",
    cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake, vmap=_fwd_vmap)


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """q, k, v [B, S, H, D] -> (O [B, S, H, D] in q's dtype, lse
    [B, H, S] f32), through the `flash_fwd` operator."""
    _check(q, k, v)
    return flash_fwd(q, k, v, bool(causal), _scale(q, scale))


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
    _check_cuda(q, k, v, do)
    lse, delta = _bwd_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    route, ops, ptrs, strides = flash_bwd_route(q, k, v, do, scale)
    _launch(_DQ_KIND[route], ops[0], ptrs, strides, lse, delta, dq, None, None,
            causal, scale)
    count(flash_attention_bwd_dq, route)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            scale=None):
    """(dK, dV) [B, S, H, D] from the forward's lse and delta."""
    _check(q, k, v, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                           causal=causal, scale=scale)
    _check_cuda(q, k, v, do)
    lse, delta = _bwd_rows(q, lse, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dk, dv
    route, ops, ptrs, strides = flash_bwd_route(q, k, v, do, scale)
    _launch(_DKV_KIND[route], ops[0], ptrs, strides, lse, delta, dk, dv, None,
            causal, scale)
    count(flash_attention_bwd_dkv, route)
    return dk, dv


flash_attention_fwd.launches = 0
#: launches of each body (`flash_fwd_route`'s codes)
flash_attention_fwd.routes = {FWD_MMA: 0, FWD_WGMMA: 0}
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
#: launches of each backward body (`flash_bwd_route`'s codes)
flash_attention_bwd_dq.routes = {BWD_MMA: 0, BWD_WGMMA: 0}
flash_attention_bwd_dkv.routes = {BWD_MMA: 0, BWD_WGMMA: 0}


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


# --- one ring step: position-masked kernels ----------------------------------

def _pos_keep(q_pos, k_pos, causal):
    """[Sq, Sk] bool of the keys a query row may see, by global position."""
    if not causal:
        return None
    return q_pos.long()[:, None] >= k_pos.long()[None, :]


def flash_fwd_pos_ref(q, k, v, q_pos, k_pos, *, causal=True, scale=None):
    """Plain version of `flash_fwd_pos`, the TPU kernel's math over one
    K block: masked scores at -1e30, P = exp(s - max) cast to q's dtype
    before PV, divided by ``l_safe = max(l, 1e-30)``; lse = max +
    log(l_safe). Returns (O [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32)."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _pos_keep(q_pos, k_pos, causal)
    if keep is not None:
        s = torch.where(keep, s, torch.full((), _NEG_INF, device=s.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    out = (o / l_safe).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def flash_bwd_pos_ref(q, k, v, do, lse, delta, q_pos, k_pos, *, causal=True,
                      scale=None):
    """Plain version of `flash_bwd_pos`: (dq, dk, dv) of one step in q's
    dtype from the global lse and delta ([B, H, Sq] f32)."""
    keep = _pos_keep(q_pos, k_pos, causal)
    qf, kf, dof, p, ds = _bwd_probs(q, k, v, do, lse, delta, keep, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)
    return (dq, *_dkv_from_probs(q, qf, kf, dof, p, ds))


def _check_pos(q, k, v, q_pos, k_pos, do=None):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected [B, S, H, D] tensors, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if v.shape != k.shape or (k.shape[0], k.shape[2], k.shape[3]) != (
            q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"k, v must be [B, Sk, H, D] with q's B, H, D: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} differs from q "
                         f"{tuple(q.shape)}")
    if q.shape[-1] > 256:
        raise ValueError(f"head dim {q.shape[-1]} > 256 is not supported")
    for name, pos, n in (("q_pos", q_pos, q.shape[1]),
                         ("k_pos", k_pos, k.shape[1])):
        if pos.dim() != 1 or pos.shape[0] != n or pos.is_floating_point():
            raise ValueError(f"{name} must be [{n}] integers, got "
                             f"{tuple(pos.shape)} {pos.dtype}")


def _cuda_positions(q, *pos):
    out = []
    for p in pos:
        if p.device != q.device:
            raise ValueError(f"positions on {p.device}, q on {q.device}")
        out.append(p.to(torch.int32).contiguous())
    return out


def flash_pos_route(q, k, v, do=None, scale=1.0):
    """How a CUDA call of `flash_fwd_pos` (q, k, v) or of
    `flash_bwd_pos_dq` / `flash_bwd_pos_dkv` (and dO) launches; the
    wrappers launch exactly what this returns: (route, ops, ptrs,
    strides), as `flash_fwd_route` / `flash_bwd_route` — the route
    FWD_WGMMA / BWD_WGMMA (the Hopper bodies under the position mask)
    where `_build.hopper_plan` admits the operands and q and k have one
    length, FWD_MMA / BWD_MMA (the mma.sync bodies) otherwise."""
    ops = (q, k, v) if do is None else (q, k, v, do)
    hopper, *views = _build.hopper_plan(ops, scale)
    hopper = hopper and q.shape[1] == k.shape[1]
    if do is None:
        return (FWD_WGMMA if hopper else FWD_MMA, *views)
    return (BWD_WGMMA if hopper else BWD_MMA, *views)


def _launch_pos(kind, q, k, ptrs, strides, lse, delta, out0, out1, lse_out,
                q_pos, k_pos, causal, scale):
    """One launch of a ring-step kernel on the operands q, k, v (and dout)
    whose pointers and strides `flash_pos_route` fetched."""
    dims = _build.attention_dims(q.shape, strides)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _build.lib()
    ctx, stream = _build.launch_on(q.device)
    with ctx:
        err = lib.ptt_flash_attention_pos(
            kind, ptrs[0], ptrs[1], ptrs[2], ptrs[3] if len(ptrs) > 3
            else None, ptr(lse), ptr(delta), ptr(out0), ptr(out1),
            ptr(lse_out), q_pos.data_ptr(), k_pos.data_ptr(), dims,
            k.shape[1], _build.dtype_code(q.dtype), scale,
            int(bool(causal)), stream)
    _build.check(err, ("flash_fwd_pos", "flash_dq_pos",
                       "flash_dkv_pos")[kind % 3])


def flash_fwd_pos(q, k, v, q_pos, k_pos, *, causal=True, scale=None):
    """One ring step's forward: q [B, Sq, H, D] against a visiting k, v
    [B, Sk, H, D], masked by ``q_pos[i] >= k_pos[j]`` (int [Sq], [Sk];
    no mask when not causal). Returns the unmerged (O [B, Sq, H, D] in
    q's dtype, lse [B, H, Sq] f32)."""
    _check_pos(q, k, v, q_pos, k_pos)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_fwd_pos_ref(q, k, v, q_pos, k_pos, causal=causal,
                                 scale=scale)
    _check_cuda(q, k, v)
    q_pos, k_pos = _cuda_positions(q, q_pos, k_pos)
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    route, ops, ptrs, strides = flash_pos_route(q, k, v, scale=scale)
    _launch_pos(route, ops[0], ops[1], ptrs, strides, None, None, out, None,
                lse, q_pos, k_pos, causal, scale)
    count(flash_fwd_pos, route)
    return out, lse


def flash_bwd_pos_dq(q, k, v, do, lse, delta, q_pos, k_pos, *, causal=True,
                     scale=None):
    """One ring step's dQ [B, Sq, H, D] (q's dtype)."""
    _check_pos(q, k, v, q_pos, k_pos, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_pos_ref(q, k, v, do, lse, delta, q_pos, k_pos,
                                 causal=causal, scale=scale)[0]
    _check_cuda(q, k, v, do)
    q_pos, k_pos = _cuda_positions(q, q_pos, k_pos)
    lse, delta = _bwd_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    route, ops, ptrs, strides = flash_pos_route(q, k, v, do, scale)
    _launch_pos(_DQ_KIND[route], ops[0], ops[1], ptrs, strides, lse, delta,
                dq, None, None, q_pos, k_pos, causal, scale)
    count(flash_bwd_pos_dq, route)
    return dq


def flash_bwd_pos_dkv(q, k, v, do, lse, delta, q_pos, k_pos, *, causal=True,
                      scale=None):
    """One ring step's (dK, dV) [B, Sk, H, D] (q's dtype)."""
    _check_pos(q, k, v, q_pos, k_pos, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_pos_ref(q, k, v, do, lse, delta, q_pos, k_pos,
                                 causal=causal, scale=scale)[1:]
    _check_cuda(q, k, v, do)
    q_pos, k_pos = _cuda_positions(q, q_pos, k_pos)
    lse, delta = _bwd_rows(q, lse, delta)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if k.numel() == 0:
        return dk, dv
    route, ops, ptrs, strides = flash_pos_route(q, k, v, do, scale)
    _launch_pos(_DKV_KIND[route], ops[0], ops[1], ptrs, strides, lse, delta,
                dk, dv, None, q_pos, k_pos, causal, scale)
    count(flash_bwd_pos_dkv, route)
    return dk, dv


def flash_bwd_pos(q, k, v, do, lse, delta, q_pos, k_pos, *, causal=True,
                  scale=None):
    """One ring step's (dq, dk, dv) from the global merged lse and
    delta = rowsum(dO * O_merged), both [B, H, Sq] f32: two launches on
    the GPU (dQ, then dK/dV)."""
    kw = dict(causal=causal, scale=scale)
    if q.device.type == "cpu":
        _check_pos(q, k, v, q_pos, k_pos, do)
        return flash_bwd_pos_ref(q, k, v, do, lse, delta, q_pos, k_pos,
                                 **kw)
    return (flash_bwd_pos_dq(q, k, v, do, lse, delta, q_pos, k_pos, **kw),
            *flash_bwd_pos_dkv(q, k, v, do, lse, delta, q_pos, k_pos, **kw))


flash_fwd_pos.launches = 0
flash_bwd_pos_dq.launches = 0
flash_bwd_pos_dkv.launches = 0
#: launches of each body (`flash_pos_route`'s codes)
flash_fwd_pos.routes = {FWD_MMA: 0, FWD_WGMMA: 0}
flash_bwd_pos_dq.routes = {BWD_MMA: 0, BWD_WGMMA: 0}
flash_bwd_pos_dkv.routes = {BWD_MMA: 0, BWD_WGMMA: 0}
