"""Single-query decode attention (counterpart of
paddle_tpu/ops/pallas/decode_attn.py): the paged kernel of the decode
engine and, at the end of this module, `decode_attention` over a
contiguous cache.

The decode engine keeps each layer's KV cache as a pool of fixed-size
blocks and gives every sequence a block table: position ``p`` of sequence
``b`` lives in block ``tables[b, p // BS]``, row ``p % BS``.
`paged_decode_attention` attends one query per sequence over exactly its
own rows ``0 .. pos[b]``, reading the pool through the table.

The public layout is the JAX one, ``[N, Hkv, BS, D]`` (the "kernel
layout"), but any strides with a unit stride along D are accepted: the
engine passes ``pool.permute(0, 2, 1, 3)`` of its ``[N, BS, Hkv, D]`` pool,
a view, and the kernel addresses it by strides — the pool is never copied.

A CUDA input launches ``csrc/paged_decode_attn.cu``; a CPU input computes
`paged_decode_attention_ref` (gather, f32 masked softmax, PV — the JAX
package's XLA path). The kernel file has two bodies: the ring body
(``PAGED_RING``: a CTA per sequence, KV head and token split computes all
the KV head's query heads, rows streamed by cp.async through per-warp
rings) for rows of 64-512 bytes on 16-byte boundaries, and the first body
(``PAGED_SCALAR``) for the rest; `paged_route` decides, and each
wrapper's ``.routes`` counts launches by body.
"""
from __future__ import annotations

import struct

import torch

from . import _build
from ._counts import count

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "decode_attention", "decode_attention_ref", "paged_route",
           "PAGED_SCALAR", "PAGED_RING"]

#: the kernel's bodies, as ``ptt_paged_decode_attention``'s routes: the
#: first (scalar) body and the ring body
PAGED_SCALAR, PAGED_RING = 0, 1
_RING_ROW_BYTES = (64, 128, 256, 512)


def paged_route(kq, vq):
    """The body a CUDA call launches on the cache kq / vq (pool views or a
    contiguous cache, any strides with a unit stride along D): PAGED_RING
    where a row is 64, 128, 256 or 512 bytes (256 at most for int8: bf16
    D = 32-256, int8 D = 64-256, f32 D = 16-128) and every row starts on a
    16-byte boundary (aligned bases, strides whole 16-byte multiples),
    PAGED_SCALAR otherwise."""
    elt = kq.element_size()
    ok = (kq.shape[-1] * elt in _RING_ROW_BYTES[:4 if elt > 1 else 3]
          and not (kq.data_ptr() % 16 or vq.data_ptr() % 16)
          and all(st * elt % 16 == 0 for st in kq.stride()[:3]))
    return PAGED_RING if ok else PAGED_SCALAR


def _scales_3d(s):
    """[N, Hkv, BS, 1] or [N, Hkv, BS] scales -> a 3-D view (or None)."""
    if s is None:
        return None
    return s.squeeze(-1) if s.dim() == 4 else s


def _check(q, kq, ks, vq, vs, tables, pos):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D] (q_len == 1), got "
                         f"{tuple(q.shape)}")
    B, _, H, D = q.shape
    if kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(f"kq/vq must be equal [N, Hkv, BS, D], got "
                         f"{tuple(kq.shape)} / {tuple(vq.shape)}")
    N, Hkv, BS, Dk = kq.shape
    if Dk != D:
        raise ValueError(f"head dim {Dk} of the pool != query's {D}")
    if H % Hkv:
        raise ValueError(
            f"num_heads {H} must be a multiple of kv heads {Hkv}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B, NB], got {tuple(tables.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be [B], got {tuple(pos.shape)}")
    if (ks is None) != (vs is None):
        raise ValueError("pass both scales (int8 pool) or neither")
    for name, s in (("ks", ks), ("vs", vs)):
        if s is not None and tuple(s.shape) != (N, Hkv, BS):
            raise ValueError(f"{name} must be [N, Hkv, BS(, 1)], got "
                             f"{tuple(s.shape)}")
    return B, H, D, N, Hkv, BS, tables.shape[1]


def paged_decode_attention_ref(q, kq, ks, vq, vs, tables, pos):
    """Plain version: dense per-sequence view through the table, f32
    masked softmax with the int8 scales folded into score / probability
    space, then PV. Returns [B, 1, H, D] in q's dtype."""
    ks, vs = _scales_3d(ks), _scales_3d(vs)
    B, H, D, N, Hkv, BS, NB = _check(q, kq, ks, vq, vs, tables, pos)
    rep, T = H // Hkv, NB * BS
    tables = tables.long()

    def view(pool):                      # [N, Hkv, BS, *] -> [B, Hkv, T, *]
        g = pool[tables]                 # [B, NB, Hkv, BS, *]
        g = g.transpose(1, 2)
        return g.reshape(B, Hkv, T, *pool.shape[3:])

    kf = view(kq).to(torch.float32)
    vf = view(vq).to(torch.float32)
    qf = q.transpose(1, 2).to(torch.float32)                 # [B, H, 1, D]
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    scores = qf @ kf.transpose(-1, -2)                      # [B, H, 1, T]
    if ks is not None:
        ksf = view(ks).repeat_interleave(rep, dim=1)         # [B, H, T]
        scores = scores * ksf[:, :, None, :]
    scores = scores * (1.0 / D ** 0.5)
    t_idx = torch.arange(T, device=q.device)
    mask = t_idx[None, None, None, :] <= pos.long()[:, None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        vsf = view(vs).repeat_interleave(rep, dim=1)
        probs = probs * vsf[:, :, None, :]
    out = probs @ vf                                         # [B, H, 1, D]
    return out.transpose(1, 2).to(q.dtype)


def _check_cuda_cache(q, kq, ks, vq, vs, *others):
    """What the CUDA kernel takes of a cache (pool or contiguous): every
    tensor on q's device, K and V of one dtype sharing strides with a unit
    stride along D, f32 scales (3-D views, or None) sharing strides, and
    D <= 512."""
    for name, t in (("kq", kq), ("vq", vq), ("ks", ks), ("vs", vs),
                    *others):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kq.dtype != vq.dtype:
        raise TypeError(f"kq {kq.dtype} and vq {vq.dtype} differ")
    if kq.stride() != vq.stride() or kq.stride(-1) != 1:
        raise ValueError(
            f"kq/vq must share strides with a unit stride along D, got "
            f"{kq.stride()} / {vq.stride()}")
    if ks is not None:
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("scales must be float32")
        if ks.stride() != vs.stride():
            raise ValueError("ks/vs must share strides")
    if q.shape[-1] > 512:
        raise ValueError(f"head dim {q.shape[-1]} > 512 is not supported")


def paged_decode_attention(q, kq, ks, vq, vs, tables, pos):
    """q [B, 1, H, D]; kq/vq [N, Hkv, BS, D] pool views (int8 or float;
    any strides, unit stride along D); ks/vs [N, Hkv, BS(, 1)] f32 dequant
    scales of an int8 pool, or None for a float pool; tables [B, NB] int32
    (tail entries past a sequence's last block point at reserved block 0
    and are never read); pos [B] int32, the query's position. Returns
    [B, 1, H, D] in q's dtype."""
    ks, vs = _scales_3d(ks), _scales_3d(vs)
    B, H, D, N, Hkv, BS, NB = _check(q, kq, ks, vq, vs, tables, pos)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, kq, ks, vq, vs, tables, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: no kernel for device "
                           f"{q.device}")
    _check_cuda_cache(q, kq, ks, vq, vs, ("tables", tables), ("pos", pos))
    if (kq.dtype == torch.int8) != (ks is not None):
        raise ValueError("an int8 pool needs scales; a float pool takes "
                         "none")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    return _launch_paged(q, kq, ks, vq, vs, tables, pos,
                         paged_decode_attention)


#: the kernel's split count by (table width, block size), asked once
_SPLITS = {}
#: the packed sizes of a launch (`ptt_paged_decode_attention`'s dims)
_DIMS = struct.Struct("<16q")


def _launch_paged(q, kq, ks, vq, vs, tables, pos, wrapper, route=None):
    """One launch of csrc/paged_decode_attn.cu on checked CUDA operands,
    counted on `wrapper` (none for an empty batch) by route (`paged_route`
    unless one is given). tables None: sequence b reads block b (a
    contiguous cache); pos an int: every sequence's position."""
    B, _, H, D = q.shape
    Hkv, BS = kq.shape[1], kq.shape[2]
    NB = 1 if tables is None else tables.shape[1]
    sc_strides = ks.stride() if ks is not None else (0, 0, 0)
    q = q.contiguous()
    tables = None if tables is None else tables.contiguous()
    pos_all = pos if isinstance(pos, int) else 0
    pos = None if isinstance(pos, int) else pos.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    if route is None:
        route = paged_route(kq, vq)
    lib = _build.lib()
    splits = _SPLITS.get((NB, BS))
    if splits is None:
        splits = _SPLITS[NB, BS] = lib.ptt_paged_decode_splits(NB, BS)
    partial = torch.empty((B, H, splits, D + 2), dtype=torch.float32,
                          device=q.device) if splits > 1 else None
    dims = _DIMS.pack(B, H, Hkv, D, BS, NB, *kq.stride()[:3], *sc_strides,
                      _build.dtype_code(q.dtype), _build.dtype_code(kq.dtype),
                      route, pos_all)
    ctx, stream = _build.launch_on(q.device)
    with ctx:
        err = lib.ptt_paged_decode_attention(
            q.data_ptr(), kq.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vq.data_ptr(), vs.data_ptr() if vs is not None else None,
            None if tables is None else tables.data_ptr(),
            None if pos is None else pos.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, dims,
            1.0 / D ** 0.5, stream)
    _build.check(err, wrapper.__name__)
    count(wrapper, route)
    return out


paged_decode_attention.launches = 0
#: launches of each body (`paged_route`'s codes)
paged_decode_attention.routes = {PAGED_SCALAR: 0, PAGED_RING: 0}


# ---------------------------------------------------------------------------
# dense (contiguous-cache) decode attention
# ---------------------------------------------------------------------------
#
# `decode_attention` is the reference's single-position kernel over a
# contiguous cache in its "kernel layout": kq / vq [B, Hkv, T, D] (int8 or
# float) with f32 scales [B, Hkv, T, 1] (ones for a float cache; always
# applied), one position `pos` for every sequence (keys past it masked).
# The reference wires it into no model: only its tests call it. The cache
# is the paged pool with one block of T rows a sequence, so a CUDA q
# launches the paged kernel with no table (sequence b reads block b) and
# pos as one scalar argument for every sequence (reading stops at pos,
# where the TPU kernel reads all T rows and masks); a CPU q computes
# `decode_attention_ref`.


def _check_dense(q, kq, ks, vq, vs, pos):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    B, s, H, D = q.shape
    if s != 1:
        raise ValueError("decode_attention handles q_len == 1 only")
    if kq.dim() != 4 or kq.shape != vq.shape or kq.shape[0] != B \
            or kq.shape[3] != D:
        raise ValueError(f"kq/vq must be equal [B={B}, Hkv, T, D={D}], got "
                         f"{tuple(kq.shape)} / {tuple(vq.shape)}")
    Hkv, T = kq.shape[1], kq.shape[2]
    if H % Hkv:
        raise ValueError(
            f"num_heads {H} must be a multiple of kv heads {Hkv} (an "
            "uneven ratio has no query-to-KV head mapping)")
    for name, t in (("ks", ks), ("vs", vs)):
        if tuple(t.shape) not in ((B, Hkv, T, 1), (B, Hkv, T)):
            raise ValueError(f"{name} must be [B, Hkv, T, 1], got "
                             f"{tuple(t.shape)}")
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    return B, H, D, Hkv, T, pos


def decode_attention_ref(q, kq, ks, vq, vs, pos):
    """Plain version: f32 throughout — scores q . k * ks * scale, keys past
    pos at -inf, softmax, PV with the probabilities times vs; query head h
    reads KV head h // (H / Hkv). Returns [B, 1, H, D] in q's dtype."""
    B, H, D, Hkv, T, pos = _check_dense(q, kq, ks, vq, vs, pos)
    rep = H // Hkv
    qf = q[:, 0].to(torch.float32)                           # [B, H, D]
    kf = kq.to(torch.float32).repeat_interleave(rep, dim=1)  # [B, H, T, D]
    vf = vq.to(torch.float32).repeat_interleave(rep, dim=1)
    ksf = ks.reshape(B, Hkv, T).to(torch.float32).repeat_interleave(rep, 1)
    vsf = vs.reshape(B, Hkv, T).to(torch.float32).repeat_interleave(rep, 1)
    scores = (kf @ qf[..., None])[..., 0] * ksf * (1.0 / D ** 0.5)
    live = torch.arange(T, device=q.device) <= pos
    scores = scores.masked_fill(~live, float("-inf"))
    p = torch.softmax(scores, dim=-1)                        # [B, H, T]
    out = ((p * vsf)[:, :, None, :] @ vf)[:, :, 0]           # [B, H, D]
    return out[:, None].to(q.dtype)


def decode_attention(q, kq, ks, vq, vs, pos):
    """q [B, 1, H, D]; kq/vq [B, Hkv, T, D] (int8 or float; any strides
    with a unit stride along D); ks/vs [B, Hkv, T, 1] f32 scales (ones for
    a float cache); pos an int (or a 0-d tensor), the query's position.
    Returns [B, 1, H, D] in q's dtype."""
    B, H, D, Hkv, T, pos = _check_dense(q, kq, ks, vq, vs, pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, kq, ks, vq, vs, pos)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for device "
                           f"{q.device}")
    ks3, vs3 = ks.reshape(B, Hkv, T), vs.reshape(B, Hkv, T)
    _check_cuda_cache(q, kq, ks3, vq, vs3)
    # the cache is the pool with one block of T rows a sequence, block b
    # for sequence b (no table), pos for every sequence
    return _launch_paged(q, kq, ks3, vq, vs3, None, pos, decode_attention)


decode_attention.launches = 0
#: launches of each body (`paged_route`'s codes)
decode_attention.routes = {PAGED_SCALAR: 0, PAGED_RING: 0}
