"""Decoder-only transformer LM, GPT and LLaMA variants (counterpart of
paddle_tpu/models/gpt.py).

Parameter names follow the JAX package exactly
(``transformer.layers.<i>.attn.qkv_proj.weight`` ...), so weights move
between the two with `paddle_tpu_torch.convert` (which transposes Linear
weights: ``[in, out]`` there, ``[out, in]`` here).

Three attention paths:

* `forward` (and `loss`, the training path) — full causal attention
  through `nn.functional.flash_attention`: the FlashAttention-2 kernels
  on the GPU at the shapes the JAX package's predicate admits, the plain
  version otherwise;
* `decode_step` — the contiguous per-layer cache ``[B, T, Hkv, D]``
  (bf16/f32 pairs or int8 quads), written IN PLACE at ``pos`` (PyTorch
  tensors are mutable; the JAX version returns updated copies) and
  returned as the "new" caches so the call reads the same;
* `decode_step_paged` — the decode engine's block pool (`PagedBatch`).
  A decode step writes each sequence's new K/V row into its block and
  attends through the block table with the paged flash-decoding kernel
  (`ops.decode_attn.paged_decode_attention`), reading the pool in place.
  A prefill chunk writes its rows block by block and attends in plain
  PyTorch over the sequence's gathered rows, as the JAX engine does.
  On the GPU a decode step's float Linears (qkv, out, the MLP's and the
  vocab projection, tied or not) go through the row-stable GEMV
  (`ops.weight_only.row_gemv`), so a sequence's logits are bit-identical
  in every decode bucket; prefill chunks keep cuBLAS.

Under an active context-parallel guard (`distributed.context_parallel`)
`loss` is the rank's share of the global loss: it takes its rows of the
global batch, embeds them at their global positions and takes its
targets from the global next-token shift (see `loss`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.functional import apply_rotary_pos_emb, gelu, silu
from ..nn.functional.loss import cross_entropy_share
from ..nn.layer.norm import LayerNorm, RMSNorm
from ..ops.decode_attn import paged_decode_attention
from ..ops.weight_only import ROW_GEMV_MAX_M, row_gemv

__all__ = ["GPTConfig", "CONFIGS", "gpt", "GPTAttention", "GPTMLP",
           "GPTBlock", "GPTModel", "GPTForCausalLM", "CacheQuantError",
           "PagedBatch", "flops_per_token"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0            # 0 -> = num_heads (MHA); >0 -> GQA
    intermediate_size: int = 0       # 0 -> 4*hidden (gelu) or 8/3*hidden
    max_position_embeddings: int = 1024
    rope: bool = False               # rotary (LLaMA) vs learned positions
    rope_theta: float = 10000.0
    swiglu: bool = False             # LLaMA MLP
    rms_norm: bool = False           # LLaMA norm
    tie_word_embeddings: bool = True
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size == 0:
            if self.swiglu:
                self.intermediate_size = int(
                    128 * math.ceil(8 * self.hidden_size / 3 / 128))
            else:
                self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


CONFIGS = {
    "gpt_tiny": dict(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128),
    "gpt_base": dict(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024),
    "gpt3_1p3b": dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                      num_heads=32, max_position_embeddings=2048),
    "llama2_7b": dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                      num_heads=32, intermediate_size=11008,
                      max_position_embeddings=4096, rope=True, swiglu=True,
                      rms_norm=True, tie_word_embeddings=False),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class CacheQuantError(ValueError):
    """Unknown KV-cache quantization mode (a ValueError, raised for any
    unrecognised `quant=` argument or `cache_quant` attribute)."""


#: spellings of "no quantization"; an explicit "bf16" overrides a
#: model-level cache_quant attribute
_NO_QUANT = (None, "", "none", "bf16")


_DECODE = threading.local()       # .on: inside a paged decode step


@contextlib.contextmanager
def _decode_rows(on):
    prev = getattr(_DECODE, "on", False)
    _DECODE.on = bool(on)
    try:
        yield
    finally:
        _DECODE.on = prev


def _row_stable(x, weight):
    """Whether a product of x with a float weight takes the row-stable
    GEMV: inside a paged decode step, on the GPU, at the decode buckets'
    row counts."""
    return (getattr(_DECODE, "on", False) and x.is_cuda
            and x.dtype == weight.dtype
            and x.numel() <= ROW_GEMV_MAX_M * x.shape[-1])


class _DecodeLinear(nn.Linear):
    """`nn.Linear` whose decode-step calls on the GPU go through the
    row-stable GEMV (forward hooks still see the call)."""

    def forward(self, x):
        if _row_stable(x, self.weight):
            return row_gemv(x, self.weight, self.bias)
        return super().forward(x)


class _Init:
    """Seeded initialisation shared by one model's constructors."""

    def __init__(self, cfg, device, dtype, generator):
        self.cfg, self.device, self.dtype, self.g = cfg, device, dtype, \
            generator

    def linear(self, fan_in, fan_out, bias, std):
        lin = _DecodeLinear(fan_in, fan_out, bias=bias, device=self.device,
                            dtype=self.dtype)
        with torch.no_grad():
            lin.weight.normal_(0.0, std, generator=self.g)
            if bias:
                lin.bias.zero_()
        return lin

    def embedding(self, num, dim):
        emb = nn.Embedding(num, dim, device=self.device, dtype=self.dtype)
        with torch.no_grad():
            emb.weight.normal_(0.0, self.cfg.initializer_range,
                               generator=self.g)
        return emb

    def norm(self):
        cfg = self.cfg
        if cfg.rms_norm:
            return RMSNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                           device=self.device, dtype=self.dtype)
        return LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                         device=self.device, dtype=self.dtype)


class PagedBatch:
    """Index tensors of one paged dispatch, built once and shared by every
    layer. ``decode``: B sequences, one new token each at ``pos[b]``.
    ``prefill``: one sequence, tokens at ``[start, start + n)``."""

    def __init__(self, mode, *, tables=None, pos=None, write_blk=None,
                 write_off=None, read_blk=None, read_off=None, start=0):
        self.mode = mode
        self.tables, self.pos = tables, pos
        self.write_blk, self.write_off = write_blk, write_off
        self.read_blk, self.read_off = read_blk, read_off
        self.start = start

    @classmethod
    def decode(cls, tables, pos, block_size):
        """tables [B, NB] int32, pos [B] int32 (on the model's device)."""
        rows = torch.arange(tables.shape[0], device=tables.device)
        p = pos.long()
        blk = tables.long()[rows, p // block_size]
        return cls("decode", tables=tables, pos=pos,
                   write_blk=blk, write_off=p % block_size)

    @classmethod
    def prefill(cls, table, start, n, block_size):
        """table [>= ceil((start+n)/BS)] int (the sequence's blocks)."""
        table = table.long()
        t = torch.arange(start + n, device=table.device)
        blk, off = table[t // block_size], t % block_size
        return cls("prefill", write_blk=blk[start:],
                   write_off=off[start:], read_blk=blk, read_off=off,
                   start=start)


def _quant_kv(x):
    """Per-(row, head) symmetric int8 over the head dim: scale =
    amax/127. Returns (int8 values, f32 scales without the head dim)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _cached_attn_core(q, kk, vv, pos, num_heads, k_scale=None,
                      v_scale=None):
    """GQA repeat, causal mask over global positions (query i of the
    chunk sits at ``pos + i``), f32 softmax, PV. q [B, s, H, D]; kk/vv
    [B, T, Hkv, D]; optional [B, T, Hkv] int8 scales fold into score and
    probability space."""
    hkv = kk.shape[2]
    if hkv != num_heads:
        rep = num_heads // hkv
        kk = kk.repeat_interleave(rep, dim=2)
        vv = vv.repeat_interleave(rep, dim=2)
        if k_scale is not None:
            k_scale = k_scale.repeat_interleave(rep, dim=2)
            v_scale = v_scale.repeat_interleave(rep, dim=2)
    s, t = q.shape[1], kk.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).to(torch.float32)
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, :]
    scores = scores * scale
    q_idx = pos + torch.arange(s, device=q.device)[:, None]
    mask = torch.arange(t, device=q.device)[None, :] <= q_idx
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, :]
    probs = probs.to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def _write_cache(cache, new, pos):
    cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)


def _cached_attn_impl(q, k_new, v_new, k_cache, v_cache, pos, *,
                      num_heads):
    """Contiguous cache: write this chunk at `pos` (in place), attend."""
    _write_cache(k_cache, k_new, pos)
    _write_cache(v_cache, v_new, pos)
    out = _cached_attn_core(q, k_cache, v_cache, pos, num_heads)
    return out, k_cache, v_cache


def _cached_attn_int8_impl(q, k_new, v_new, kq_c, ks_c, vq_c, vs_c, pos, *,
                           num_heads):
    """Contiguous int8 cache: quantize the chunk at write, attend with the
    scales folded into score / probability space."""
    knq, kns = _quant_kv(k_new)
    vnq, vns = _quant_kv(v_new)
    _write_cache(kq_c, knq, pos)
    _write_cache(ks_c, kns, pos)
    _write_cache(vq_c, vnq, pos)
    _write_cache(vs_c, vns, pos)
    out = _cached_attn_core(q, kq_c.to(q.dtype), vq_c.to(q.dtype), pos,
                            num_heads, k_scale=ks_c, v_scale=vs_c)
    return out, kq_c, ks_c, vq_c, vs_c


def _paged_attn(q, k, v, entry, batch, num_heads):
    """Write this dispatch's K/V rows into the layer's pool `entry`
    ((k, v) or (kq, ks, vq, vs), [N, BS, Hkv, D]) and attend."""
    int8 = len(entry) == 4
    blk, off = batch.write_blk, batch.write_off
    if batch.mode == "decode":
        k, v = k[:, 0], v[:, 0]                       # [B, Hkv, D]
    else:
        k, v = k[0], v[0]                             # [n, Hkv, D]
    if int8:
        kq_p, ks_p, vq_p, vs_p = entry
        knq, kns = _quant_kv(k)
        vnq, vns = _quant_kv(v)
        kq_p[blk, off] = knq
        ks_p[blk, off] = kns
        vq_p[blk, off] = vnq
        vs_p[blk, off] = vns
    else:
        k_p, v_p = entry
        k_p[blk, off] = k.to(k_p.dtype)
        v_p[blk, off] = v.to(v_p.dtype)
    if batch.mode == "decode":
        if int8:
            return paged_decode_attention(
                q, kq_p.permute(0, 2, 1, 3), ks_p.permute(0, 2, 1),
                vq_p.permute(0, 2, 1, 3), vs_p.permute(0, 2, 1),
                batch.tables, batch.pos)
        return paged_decode_attention(
            q, k_p.permute(0, 2, 1, 3), None, v_p.permute(0, 2, 1, 3), None,
            batch.tables, batch.pos)
    rb, ro = batch.read_blk, batch.read_off
    if int8:
        return _cached_attn_core(
            q, kq_p[rb, ro][None].to(q.dtype), vq_p[rb, ro][None].to(q.dtype),
            batch.start, num_heads, k_scale=ks_p[rb, ro][None],
            v_scale=vs_p[rb, ro][None])
    return _cached_attn_core(q, k_p[rb, ro][None].to(q.dtype),
                             v_p[rb, ro][None].to(q.dtype), batch.start,
                             num_heads)


class GPTAttention(nn.Module):
    """Fused-QKV causal self-attention."""

    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
        std = cfg.initializer_range
        bias = not cfg.rms_norm          # LLaMA-style stacks drop biases
        self.qkv_proj = init.linear(h, q_out + 2 * kv_out, bias, std)
        self.out_proj = init.linear(q_out, h, bias,
                                    std / math.sqrt(2 * cfg.num_layers))

    def forward(self, x, position_ids=None, cache=None, paged=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        hd = cfg.head_dim
        q_sz, kv_sz = cfg.num_heads * hd, cfg.num_kv_heads * hd
        q, k, v = torch.split(self.qkv_proj(x), [q_sz, kv_sz, kv_sz], -1)
        q = q.reshape(b, s, cfg.num_heads, hd)
        k = k.reshape(b, s, cfg.num_kv_heads, hd)
        v = v.reshape(b, s, cfg.num_kv_heads, hd)
        if cfg.rope:
            q, k = apply_rotary_pos_emb(q, k, position_ids,
                                        theta=cfg.rope_theta)
        if paged is not None:
            entry, batch = paged
            out = _paged_attn(q, k, v, entry, batch, cfg.num_heads)
            return self.out_proj(out.reshape(b, s, q_sz))
        if cache is not None:
            if len(cache) == 5:
                kq_c, ks_c, vq_c, vs_c, pos = cache
                out, *new = _cached_attn_int8_impl(
                    q, k, v, kq_c, ks_c, vq_c, vs_c, pos,
                    num_heads=cfg.num_heads)
            else:
                k_c, v_c, pos = cache
                out, *new = _cached_attn_impl(q, k, v, k_c, v_c, pos,
                                              num_heads=cfg.num_heads)
            return self.out_proj(out.reshape(b, s, q_sz)), tuple(new)
        if cfg.num_kv_heads != cfg.num_heads:
            rep = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out, _ = F.flash_attention(q, k, v, dropout=cfg.dropout, causal=True,
                                   training=self.training)
        return self.out_proj(out.reshape(b, s, q_sz))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        std = cfg.initializer_range
        bias = not cfg.rms_norm
        self.swiglu = cfg.swiglu
        if cfg.swiglu:
            self.gate_up_proj = init.linear(h, 2 * m, False, std)
        else:
            self.up_proj = init.linear(h, m, bias, std)
        self.down_proj = init.linear(m, h, bias,
                                     std / math.sqrt(2 * cfg.num_layers))

    def forward(self, x):
        if self.swiglu:
            gate, up = torch.chunk(self.gate_up_proj(x), 2, dim=-1)
            x = silu(gate) * up
        else:
            x = gelu(self.up_proj(x), approximate=True)
        return self.down_proj(x)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.ln_1 = init.norm()
        self.attn = GPTAttention(cfg, init)
        self.ln_2 = init.norm()
        self.mlp = GPTMLP(cfg, init)

    def forward(self, x, position_ids=None, cache=None, paged=None):
        if cache is not None:
            att, new_cache = self.attn(self.ln_1(x), position_ids, cache)
            x = x + att
            return x + self.mlp(self.ln_2(x)), new_cache
        x = x + self.attn(self.ln_1(x), position_ids, paged=paged)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    """Embeddings + N blocks + final norm."""

    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.wte = init.embedding(cfg.vocab_size, cfg.hidden_size)
        if not cfg.rope:
            self.wpe = init.embedding(cfg.max_position_embeddings,
                                      cfg.hidden_size)
        self.layers = nn.ModuleList(GPTBlock(cfg, init)
                                    for _ in range(cfg.num_layers))
        self.ln_f = init.norm()

    def _embed(self, input_ids, position_ids):
        x = self.wte(input_ids)
        if not self.cfg.rope:
            x = x + self.wpe(position_ids)
        return x

    def forward(self, input_ids, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device)[None].expand(b, s)
        x = self._embed(input_ids, position_ids)
        for blk in self.layers:
            x = blk(x, position_ids)
        return self.ln_f(x)

    def forward_step(self, input_ids, caches, pos):
        """Contiguous-cache decode of input_ids [B, s] at global positions
        [pos, pos + s); caches per layer (k, v) or (kq, ks, vq, vs),
        updated in place. Returns (hidden, caches)."""
        b, s = input_ids.shape
        pos = int(pos)
        position_ids = (torch.arange(s, device=input_ids.device)
                        + pos)[None].expand(b, s)
        x = self._embed(input_ids, position_ids)
        new_caches = []
        for blk, entry in zip(self.layers, caches):
            x, nc = blk(x, position_ids, cache=(*entry, pos))
            new_caches.append(nc)
        return self.ln_f(x), new_caches

    def forward_paged(self, input_ids, pool_layers, batch: PagedBatch):
        b, s = input_ids.shape
        if batch.mode == "decode":
            position_ids = batch.pos.long()[:, None]
        else:
            position_ids = (torch.arange(s, device=input_ids.device)
                            + batch.start)[None]
        x = self._embed(input_ids, position_ids)
        for blk, entry in zip(self.layers, pool_layers):
            x = blk(x, position_ids, paged=(entry, batch))
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head on the trunk; `forward` returns logits."""

    def __init__(self, cfg: GPTConfig, *, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {cfg.dtype!r}")
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        init = _Init(cfg, dev, _DTYPES[cfg.dtype], g)
        self.cfg = cfg
        self.transformer = GPTModel(cfg, init)
        self.lm_head = None if cfg.tie_word_embeddings else init.linear(
            cfg.hidden_size, cfg.vocab_size, False, cfg.initializer_range)

    @property
    def device(self):
        return self.transformer.wte.weight.device

    def _project(self, hidden):
        if self.lm_head is None:
            wte = self.transformer.wte.weight
            if _row_stable(hidden, wte):
                return row_gemv(hidden, wte)
            return hidden @ wte.t()
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None):
        return self._project(self.transformer(input_ids, position_ids))

    def loss(self, input_ids, labels=None, position_ids=None):
        """Causal LM loss (mean over the shifted tokens). labels default to
        input_ids. The shift slices the hidden states before the vocab
        projection, so the full [B, S, V] logits are never copied.

        Under an active context-parallel guard with cp > 1 the arguments
        are the GLOBAL batch (every rank gets the same, as JAX gets global
        arrays) and the result is this rank's share of the global loss:
        the rank takes its rows of the sequence (zigzag when S divides by
        2 cp, else contiguous — the attention's placement rule), embeds
        them at their global positions, takes each row's target from the
        global next-token shift (`ignore_index` at the last global
        position, which has none) and
        divides its f32 sum by the global count B (S - 1); the engine sums
        the shares over the mesh."""
        if labels is None:
            labels = input_ids
        from ..distributed.context_parallel import active_context_parallel
        cp = active_context_parallel()
        if cp is not None and cp[0].size > 1:
            if position_ids is not None:
                raise NotImplementedError(
                    "position_ids under context parallelism: the rank's "
                    "rows take their global positions")
            return self._cp_loss(input_ids, labels, cp[0])
        hidden = self.transformer(input_ids, position_ids)[:, :-1, :]
        logits = self._project(hidden)
        return F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               labels[:, 1:].reshape(-1))

    def _cp_loss(self, input_ids, labels, mesh):
        from ..distributed.context_parallel import (_local_positions,
                                                    balanced_default)
        b, s = input_ids.shape
        n = mesh.size
        if s % n:
            raise ValueError(f"seq len {s} must divide the cp axis size "
                             f"{n}")
        pos = _local_positions(mesh.rank, n, s // n,
                               balanced_default(True, n, s),
                               input_ids.device).long()
        hidden = self.transformer(input_ids[:, pos],
                                  pos[None].expand(b, -1))
        # the global shift: row p's target is token p + 1; the last global
        # position has none and is ignored
        targets = labels[:, (pos + 1).clamp_max(s - 1)].masked_fill(
            pos[None] == s - 1, -100)
        logits = self._project(hidden)
        return cross_entropy_share(logits.reshape(-1, self.cfg.vocab_size),
                                   targets.reshape(-1), b * (s - 1))

    def _resolve_cache_quant(self, quant):
        """An explicit `quant=` wins over the model's `cache_quant`
        attribute; only `quant=None` falls back to it. Returns None
        (unquantized) or "int8"; anything else raises CacheQuantError."""
        if quant is None:
            quant = getattr(self, "cache_quant", None)
        key = quant.lower() if isinstance(quant, str) else quant
        if key in _NO_QUANT:
            return None
        if key == "int8":
            return "int8"
        raise CacheQuantError(
            f"unsupported cache quant {quant!r} (supported: 'int8', or "
            f"'bf16'/None for the unquantized layout)")

    def init_cache(self, batch_size, max_length, dtype=None, quant=None):
        """Zeroed per-layer contiguous caches [B, T, Hkv, D] on the
        model's device: (k, v) of the parameter dtype, or int8
        (kq, ks, vq, vs) with [B, T, Hkv] f32 scales."""
        cfg = self.cfg
        quant = self._resolve_cache_quant(quant)
        dtype = dtype or self.transformer.wte.weight.dtype
        shape = (batch_size, int(max_length), cfg.num_kv_heads, cfg.head_dim)
        dev = self.device

        def z(shp, dt):
            return torch.zeros(shp, dtype=dt, device=dev)

        if quant == "int8":
            return [(z(shape, torch.int8), z(shape[:-1], torch.float32),
                     z(shape, torch.int8), z(shape[:-1], torch.float32))
                    for _ in range(cfg.num_layers)]
        return [(z(shape, dtype), z(shape, dtype))
                for _ in range(cfg.num_layers)]

    def init_block_pool(self, num_blocks, block_size, dtype=None,
                        quant=None, name=None):
        """Paged twin of `init_cache`: a `BlockKVCache` on the model's
        device with this model's cache-entry order and dtypes."""
        from ..inference.decode.block_pool import BlockKVCache

        cfg = self.cfg
        quant = self._resolve_cache_quant(quant)
        dtype = dtype or self.transformer.wte.weight.dtype
        suffix = (cfg.num_kv_heads, cfg.head_dim)
        if quant == "int8":
            layer = ((suffix, torch.int8), ((cfg.num_kv_heads,),
                                            torch.float32),
                     (suffix, torch.int8), ((cfg.num_kv_heads,),
                                            torch.float32))
        else:
            layer = ((suffix, dtype), (suffix, dtype))
        return BlockKVCache(num_blocks, block_size,
                            [layer] * cfg.num_layers, quant=quant,
                            name=name, device=self.device)

    def decode_step(self, input_ids, caches, pos):
        """Contiguous-cache step: logits for input_ids at offset `pos`
        plus the (in-place updated) caches."""
        hidden, new_caches = self.transformer.forward_step(input_ids, caches,
                                                           pos)
        return self._project(hidden), new_caches

    def decode_step_paged(self, input_ids, pool_layers, batch: PagedBatch):
        """Paged step (engine): input_ids [B, 1] (decode) or [1, n]
        (prefill chunk); writes the new K/V rows into `pool_layers` in
        place. Returns logits [B, 1, V]: each decode row's, or the
        prefill chunk's last row (the only one the engine reads)."""
        with _decode_rows(batch.mode == "decode"):
            hidden = self.transformer.forward_paged(input_ids, pool_layers,
                                                    batch)
            return self._project(hidden[:, -1:])


def gpt(name="gpt_base", *, device=None, seed=0, **overrides):
    """Build a named config with seeded random weights on `device`
    (default: the GPU; raises when there is none)."""
    d = dict(CONFIGS[name])
    d.update(overrides)
    return GPTForCausalLM(GPTConfig(**d), device=device, seed=seed)


def flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (forward + backward: 6 N plus
    the attention term), the MFU numerator of the JAX package."""
    n_params = (
        cfg.vocab_size * cfg.hidden_size
        * (1 if cfg.tie_word_embeddings else 2)
        + cfg.num_layers * (
            cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads)
            * cfg.head_dim
            + cfg.num_heads * cfg.head_dim * cfg.hidden_size
            + cfg.hidden_size * cfg.intermediate_size
            * (3 if cfg.swiglu else 2)))
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq_len
    return 6.0 * n_params + attn
