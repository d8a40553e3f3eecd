"""Paged single-query decode attention (counterpart of the paged half of
paddle_tpu/ops/pallas/decode_attn.py).

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
package's XLA path).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]


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
    for name, t in (("kq", kq), ("vq", vq), ("ks", ks), ("vs", vs),
                    ("tables", tables), ("pos", pos)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kq.dtype != vq.dtype:
        raise TypeError(f"kq {kq.dtype} and vq {vq.dtype} differ")
    if kq.stride() != vq.stride() or kq.stride(-1) != 1:
        raise ValueError(
            f"kq/vq must share strides with a unit stride along D, got "
            f"{kq.stride()} / {vq.stride()}")
    if (kq.dtype == torch.int8) != (ks is not None):
        raise ValueError("an int8 pool needs scales; a float pool takes "
                         "none")
    if ks is not None:
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("scales must be float32")
        if ks.stride() != vs.stride():
            raise ValueError("ks/vs must share strides")
        sc_strides = ks.stride()
    else:
        sc_strides = (0, 0, 0)
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    if D > 512:
        raise ValueError(f"head dim {D} > 512 is not supported")
    q = q.contiguous()
    tables = tables.contiguous()
    pos = pos.contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.lib()
    splits = lib.ptt_paged_decode_splits(NB, BS)
    partial = torch.empty((B, H, splits, D + 2), dtype=torch.float32,
                          device=q.device) if splits > 1 else None
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_decode_attention(
            q.data_ptr(), kq.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vq.data_ptr(), vs.data_ptr() if vs is not None else None,
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, Hkv, D, BS, NB, *kq.stride()[:3], *sc_strides,
            _build.dtype_code(q.dtype), _build.dtype_code(kq.dtype),
            1.0 / D ** 0.5,
            partial.data_ptr() if partial is not None else None,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
