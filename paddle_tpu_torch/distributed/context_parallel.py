"""Context parallelism: ring attention and Ulysses attention (counterpart
of paddle_tpu/distributed/context_parallel.py).

The JAX module runs inside `shard_map` on global arrays. The port runs
per rank, the way PyTorch writes SPMD code: every function here is called
in each rank of a cp mesh (`sharding.MeshConfig(cp=n).build()`) with that
rank's rows of the sequence, and the ring's hops are point-to-point
shifts over the mesh's process group (`distributed._ring.Transport`).

Placement. Rank p holds the global rows `zigzag_permutation(S, n)[0]
[p * S/n : (p + 1) * S/n]` — chunks (p, 2n - 1 - p) of size S/(2n) — when
the placement is balanced, else the contiguous rows [p S/n, (p + 1) S/n).
Balanced is the default for causal attention when S divides by 2n (the
JAX rule). The JAX module permutes global arrays around its shard_map;
here the caller's rows are already placed (the engine's model takes its
own rows, `models.gpt.GPTForCausalLM.loss`), and masking runs off the
rows' global positions (`_local_positions`), which rotate around the
ring with K and V.

* **ring**, two bodies: the plain one (`_ring_attention_local`, any
  shape, autograd through PyTorch ops and a differentiable shift) and the
  flash one (`_RingFlash`, one `torch.autograd.Function`): n
  `ops.flash_attention.flash_fwd_pos` calls merged by `_merge_partial`
  forward; backward, delta from the merged output, then n `flash_bwd_pos`
  calls with k, v, k_pos, dk and dv rotating together for n full hops, each
  step's dq, dk, dv (rounded to the input dtype by the kernels) summed in
  f32 in a fixed order. The flash body runs when the shard's shape passes
  `_ring_flash_shapes_ok` on CUDA (``impl=None``), or when asked for
  (``impl="flash"``; on the CPU the kernels' plain versions);
* **Ulysses**: two all-to-alls around the port's own dense attention
  (the flash kernels where `flash_attention_supported` admits the shape,
  else their plain version): [b, S/n, h, d] -> [b, S, h/n, d] -> back. Its
  rows arrive placed, so a balanced placement is put back in natural
  order around the causal attention (the JAX module never permutes for
  Ulysses because its arrays are global).

`context_parallel_guard` makes model-level `nn.functional.
scaled_dot_product_attention` calls route here, as in JAX.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from ..ops.flash_attention import (attention_delta, flash_attention,
                                   flash_attention_ref,
                                   flash_attention_supported, flash_bwd_pos,
                                   flash_fwd_pos)

__all__ = [
    "ring_attention",
    "ulysses_attention",
    "context_parallel_attention",
    "context_parallel_guard",
    "active_context_parallel",
    "zigzag_permutation",
    "balanced_default",
]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Placement helpers.
# ---------------------------------------------------------------------------


def zigzag_permutation(seq_len, n_shards):
    """Global row permutation for load-balanced causal placement: shard p
    receives chunks (p, 2n-1-p) of size seq_len/(2n). Returns (perm,
    inverse) index arrays; `x[:, perm]` places rows, `y[:, inverse]`
    restores the natural order."""
    if seq_len % (2 * n_shards):
        raise ValueError(f"zigzag placement needs seq_len divisible by "
                         f"2*n_shards, got {seq_len} / {n_shards}")
    c = seq_len // (2 * n_shards)
    perm = np.concatenate([
        np.concatenate([np.arange(p * c, (p + 1) * c),
                        np.arange((2 * n_shards - 1 - p) * c,
                                  (2 * n_shards - p) * c)])
        for p in range(n_shards)])
    return perm, np.argsort(perm)


def balanced_default(causal, n, seq_len):
    """The JAX rule: zigzag placement for causal attention on more than
    one shard when the sequence divides by 2n."""
    return bool(causal) and n > 1 and seq_len % (2 * n) == 0


def _local_positions(rank, n, s_loc, balanced, device=None):
    """Global positions of rank `rank`'s rows (int32 [s_loc]), matching
    `zigzag_permutation` when balanced else contiguous placement."""
    if balanced:
        c = s_loc // 2
        ar = torch.arange(c, dtype=torch.int32, device=device)
        return torch.cat([rank * c + ar, (2 * n - 1 - rank) * c + ar])
    return rank * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                       device=device)


def _ring_flash_shapes_ok(s_loc, d, balanced):
    """Whether the pos kernels take this per-shard problem (the JAX
    module's envelope, unchanged, on the LOCAL length)."""
    if balanced and s_loc % 2:
        return False
    return (s_loc >= 128 and s_loc % 128 == 0 and d <= 256
            and s_loc * d <= (1 << 20))


# ---------------------------------------------------------------------------
# The plain ring body.
# ---------------------------------------------------------------------------


class _Shift(torch.autograd.Function):
    """One ring hop (to rank p + 1) whose backward is the hop back."""

    @staticmethod
    def forward(ctx, transport, *tensors):
        ctx.transport = transport
        ctx.like = [(t.new_empty(0), t.shape) for t in tensors]
        # the received tensors share one buffer: give autograd its own
        return tuple(t.clone() for t in transport.shift(list(tensors), 1))

    @staticmethod
    def backward(ctx, *grads):
        grads = [t.new_zeros(shape) if g is None else g
                 for g, (t, shape) in zip(grads, ctx.like)]
        return (None, *ctx.transport.shift(grads, -1))


def _ring_attention_local(q, k, v, mesh, *, causal, scale, q_pos):
    """Flash-style streaming attention over K/V blocks rotating on the
    ring, in plain PyTorch (any shape): after t hops a rank holds the
    block that rank p - t owns; per block, masked scores update the
    online-softmax state (o, m, l) in f32."""
    n = mesh.size
    qf = (q.float() * scale).transpose(1, 2)                 # [b, h, s, d]
    b, h, s_loc, d = qf.shape

    def block_update(acc, k_blk, v_blk, k_pos):
        o, m, l = acc
        kf = k_blk.float().transpose(1, 2)
        vf = v_blk.float().transpose(1, 2)
        s_ = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        keep = None
        if causal:
            keep = (q_pos.long()[:, None] >= k_pos.long()[None, :])
            s_ = torch.where(keep, s_, torch.full((), _NEG_INF,
                                                  device=s_.device))
        m_new = torch.maximum(m, s_.amax(-1))
        p_ = torch.exp(s_ - m_new[..., None])
        if keep is not None:
            p_ = p_ * keep       # robust when a whole row is masked
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p_, vf)
        return o, m_new, l

    acc = (torch.zeros((b, h, s_loc, d), device=q.device),
           torch.full((b, h, s_loc), _NEG_INF, device=q.device),
           torch.zeros((b, h, s_loc), device=q.device))
    k_c, v_c, kp_c = k, v, q_pos
    for t in range(n):
        acc = block_update(acc, k_c, v_c, kp_c)
        if t < n - 1:
            k_c, v_c = _Shift.apply(mesh.transport, k_c, v_c)
            kp_c = mesh.transport.shift([kp_c])[0]
    o, _, l = acc
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# The flash ring body: the pos kernels under one autograd.Function.
# ---------------------------------------------------------------------------


def _merge_partial(out, lse, o_blk, lse_blk):
    """Online-softmax merge of one ring step's normalized partial: a
    fully-masked partial arrives as (0, ~-1e30) and gets weight 0. out
    [B, S, H, D] f32, lse [B, H, S] f32."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
    return out * w_old + o_blk.float() * w_blk, lse_new


def _ring_flash_fwd_impl(q, k, v, mesh, causal, scale, q_pos):
    """n `flash_fwd_pos` calls, K, V and k_pos rotating; each hop starts
    before the step's kernel and lands after it. Returns (out f32, lse)."""
    n, tr = mesh.size, mesh.transport
    b, s_loc, h, _ = q.shape
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_c, v_c, kp_c = k, v, q_pos
    for t in range(n):
        hop = tr.start_shift([k_c, v_c, kp_c]) if t < n - 1 else None
        o_blk, lse_blk = flash_fwd_pos(q, k_c, v_c, q_pos, kp_c,
                                       causal=causal, scale=scale)
        out, lse = _merge_partial(out, lse, o_blk, lse_blk)
        if hop is not None:
            k_c, v_c, kp_c = hop.wait()
    return out, lse


def _ring_flash_bwd_impl(q, k, v, out, lse, do, mesh, causal, scale, q_pos):
    """Ring backward: dq accumulates at home; (k, v, k_pos, dk, dv) rotate
    together for n full hops (the last one carries dk, dv alone), each
    visited rank adding its q shard's contribution, so after n hops the
    accumulated dk, dv are home. Every step is computable from the global
    merged lse and delta = rowsum(dO * O) (the FA-2 identity)."""
    n, tr = mesh.size, mesh.transport
    delta = attention_delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_c = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_c = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_c, v_c, kp_c = k, v, q_pos
    for t in range(n):
        dq_i, dk_i, dv_i = flash_bwd_pos(q, k_c, v_c, do, lse, delta, q_pos,
                                         kp_c, causal=causal, scale=scale)
        dq += dq_i.float()
        dk_c += dk_i.float()
        dv_c += dv_i.float()
        if t < n - 1:
            k_c, v_c, kp_c, dk_c, dv_c = tr.shift([k_c, v_c, kp_c, dk_c,
                                                    dv_c])
        else:
            dk_c, dv_c = tr.shift([dk_c, dv_c])
    return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale, q_pos):
        out, lse = _ring_flash_fwd_impl(q, k, v, mesh, causal, scale, q_pos)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, q_pos)
        ctx.mesh, ctx.causal, ctx.scale = mesh, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd_impl(q, k, v, out, lse,
                                          do.to(q.dtype).contiguous(),
                                          ctx.mesh, ctx.causal, ctx.scale,
                                          q_pos)
        return dq, dk, dv, None, None, None, None


def ring_serial(q, k, v, do, n, *, causal=True, scale=None, balanced=None,
                fwd=flash_fwd_pos, bwd=flash_bwd_pos, stats=None):
    """What the n ranks of the flash ring compute, run in turn in one
    process with no transport: step t of every rank, then step t + 1, each
    rank's partials merged by `_merge_partial` and its backward's dk, dv
    summed in the ring's order. q, k, v, do: [B, S, H, D] global in
    natural order. Returns (out, dq, dk, dv) in natural order and q's
    dtype, and the ranks' forward statistics [(out, lse)].

    It holds the pos kernels against the whole-sequence flash kernels on
    one device. `fwd` / `bwd` (the step functions) may be the kernels'
    plain versions, and `stats` another run's forward statistics, on which
    this run's backward then runs — to hold the backward kernels alone."""
    b, S, h, d = q.shape
    if S % n:
        raise ValueError(f"seq len {S} must divide by n={n}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if balanced is None:
        balanced = balanced_default(causal, n, S)
    pos = [_local_positions(r, n, S // n, balanced, q.device)
           for r in range(n)]
    qs, ks, vs, dos = ([x.index_select(1, p.long()).contiguous()
                        for p in pos] for x in (q, k, v, do))
    kw = dict(causal=causal, scale=scale)
    if stats is None:
        outs = [torch.zeros(qs[0].shape, device=q.device) for _ in range(n)]
        lses = [torch.full((b, h, S // n), _NEG_INF, device=q.device)
                for _ in range(n)]
        for t in range(n):
            for r in range(n):
                j = (r - t) % n
                o_blk, lse_blk = fwd(qs[r], ks[j], vs[j], pos[r], pos[j],
                                     **kw)
                outs[r], lses[r] = _merge_partial(outs[r], lses[r], o_blk,
                                                  lse_blk)
        stats = [(o.to(q.dtype), lse) for o, lse in zip(outs, lses)]
    deltas = [attention_delta(o, g) for (o, _), g in zip(stats, dos)]
    grads = [[torch.zeros(qs[0].shape, device=q.device) for _ in range(n)]
             for _ in range(3)]
    for t in range(n):
        for r in range(n):
            j = (r - t) % n
            dq_i, dk_i, dv_i = bwd(qs[r], ks[j], vs[j], dos[r], stats[r][1],
                                   deltas[r], pos[r], pos[j], **kw)
            grads[0][r] += dq_i.float()
            grads[1][j] += dk_i.float()
            grads[2][j] += dv_i.float()
    inv = torch.argsort(torch.cat(pos).long())
    return tuple(torch.cat(parts, 1).index_select(1, inv).to(q.dtype)
                 for parts in ([o for o, _ in stats], *grads)), stats


# ---------------------------------------------------------------------------
# Ulysses.
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transport, x, split_dim, concat_dim):
        ctx.args = (transport, split_dim, concat_dim)
        return transport.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        transport, split_dim, concat_dim = ctx.args
        return (None, transport.all_to_all(g.contiguous(), concat_dim,
                                           split_dim), None, None)


def _dense_attention(q, k, v, causal, scale):
    """The port's single-device attention: the flash kernels on CUDA
    where `flash_attention_supported` admits the shape, else their plain
    version."""
    if q.is_cuda and flash_attention_supported(tuple(q.shape), causal):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)[0]


def _ulysses_attention_local(q, k, v, mesh, *, causal, scale, balanced):
    """[b, S/n, h, d] -> [b, S, h/n, d] by one all-to-all per tensor,
    dense attention on the full sequence per head group, then the inverse
    exchange."""
    tr = mesh.transport
    q, k, v = (_AllToAll.apply(tr, x, 2, 1) for x in (q, k, v))
    inv = None
    if balanced:
        perm, inv = (torch.as_tensor(a, device=q.device)
                     for a in zigzag_permutation(q.shape[1], mesh.size))
        q, k, v = (x.index_select(1, inv) for x in (q, k, v))
    out = _dense_attention(q, k, v, causal, scale)
    if inv is not None:
        out = out.index_select(1, perm)
    return _AllToAll.apply(tr, out, 1, 2)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def context_parallel_attention(q, k, v, mesh, *, mode="ring", causal=True,
                               scale=None, impl=None, balanced=None):
    """Sequence-sharded self-attention over the cp axis of `mesh`, called
    in every rank of the mesh with that rank's rows.

    q/k/v: [batch, seq_local, heads, head_dim], the rank's rows of the
    global sequence (zigzag chunks when `balanced`, else contiguous);
    returns the rank's rows of the output. With mode="ulysses" the heads
    must divide by the mesh size.

    `impl` selects the ring step body: "einsum" (the plain body, any
    shape), "flash" (the pos kernels, their plain versions on the CPU;
    the shard length must be 128-aligned), or None/"auto" — flash on CUDA
    when the shapes qualify, einsum otherwise. `mode="ring_flash"` is
    shorthand for mode="ring", impl="flash". `balanced` defaults to
    `balanced_default(causal, n, seq)`: it must say how the caller placed
    its rows."""
    n = mesh.size
    b, s_loc, h, d = q.shape
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"context-parallel attention takes self-attention "
                         f"shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mode == "ring_flash":
        mode, impl = "ring", "flash"
    if balanced is None:
        balanced = balanced_default(causal, n, s_loc * n)
    if balanced and s_loc % 2:
        raise ValueError(f"balanced placement needs an even shard length, "
                         f"got {s_loc}")
    if n == 1:
        return _dense_attention(q, k, v, causal, scale)
    if mode == "ring":
        if impl in (None, "auto"):
            impl = "flash" if (q.is_cuda and _ring_flash_shapes_ok(
                s_loc, d, balanced)) else "einsum"
        q_pos = _local_positions(mesh.rank, n, s_loc, balanced, q.device)
        if impl == "flash":
            if not _ring_flash_shapes_ok(s_loc, d, balanced):
                raise ValueError(
                    f"ring flash needs a 128-aligned per-shard length "
                    f"(and head_dim <= 256), got seq {s_loc * n} over "
                    f"cp={n} -> {s_loc}, head_dim {d}")
            k, v = k.to(q.dtype), v.to(q.dtype)
            return _RingFlash.apply(q, k, v, mesh, bool(causal),
                                    float(scale), q_pos)
        if impl == "einsum":
            return _ring_attention_local(q, k, v, mesh, causal=causal,
                                         scale=scale, q_pos=q_pos)
        raise ValueError(f"unknown ring impl {impl!r}")
    if mode == "ulysses":
        if h % n:
            raise ValueError(f"ulysses needs heads ({h}) divisible by "
                             f"cp={n}")
        return _ulysses_attention_local(q, k, v, mesh, causal=causal,
                                        scale=scale, balanced=balanced)
    raise ValueError(f"unknown context-parallel mode {mode!r}")


def ring_attention(q, k, v, mesh, *, causal=True, scale=None, impl=None,
                   balanced=None):
    """Ring attention (K/V rotation + online softmax), per rank."""
    return context_parallel_attention(
        q, k, v, mesh, mode="ring", causal=causal, scale=scale, impl=impl,
        balanced=balanced)


def ulysses_attention(q, k, v, mesh, *, causal=True, scale=None,
                      balanced=None):
    """Ulysses all-to-all sequence/head-parallel attention, per rank."""
    return context_parallel_attention(
        q, k, v, mesh, mode="ulysses", causal=causal, scale=scale,
        balanced=balanced)


# ---------------------------------------------------------------------------
# Routing state: the engine enables this around its loss so model-level
# `scaled_dot_product_attention` calls become context-parallel when the
# mesh has a "cp" axis > 1.
# ---------------------------------------------------------------------------


class _CPState(threading.local):
    def __init__(self):
        self.config = None  # (mesh, mode)


_cp_state = _CPState()


def active_context_parallel():
    """(mesh, mode) if a context_parallel_guard is active."""
    return _cp_state.config


@contextlib.contextmanager
def context_parallel_guard(mesh, mode="ring"):
    prev = _cp_state.config
    _cp_state.config = (mesh, mode)
    try:
        yield
    finally:
        _cp_state.config = prev
