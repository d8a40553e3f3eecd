"""Greedy autoregressive generation over the contiguous KV cache
(counterpart of paddle_tpu/models/generation.py, greedy path). It is the
dense reference the paged decode engine's tokens are held against."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate", "GenerationConfig"]


class GenerationConfig:
    """Greedy decoding settings (sampling is not ported yet)."""

    def __init__(self, max_new_tokens=32, eos_token_id=None, pad_token_id=0):
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)


@torch.no_grad()
def generate(model, input_ids, generation_config=None, **kwargs):
    """Greedy decoding. input_ids [B, S] (tensor or array). Returns
    [B, S + max_new_tokens] int32 on the model's device, padded with
    pad_token_id after eos: one prefill over the prompt, then one cached
    step per token."""
    cfg = generation_config or GenerationConfig(**kwargs)
    dev = model.device
    ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(
        input_ids) else input_ids).to(device=dev, dtype=torch.long)
    b, s = ids.shape
    total = s + cfg.max_new_tokens
    if cfg.max_new_tokens <= 0:
        return ids.to(torch.int32)
    was_training = model.training
    model.eval()
    try:
        buf = torch.full((b, total), cfg.pad_token_id, dtype=torch.long,
                         device=dev)
        buf[:, :s] = ids
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        logits, caches = model.decode_step(ids, model.init_cache(b, total), 0)
        for i in range(s, total):
            nxt = logits[:, -1].to(torch.float32).argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id),
                              nxt)
            buf[:, i] = nxt
            done = done | (nxt == eos)
            if i + 1 < total:
                logits, caches = model.decode_step(buf[:, i:i + 1], caches,
                                                   i)
        return buf.to(torch.int32)
    finally:
        if was_training:
            model.train()
