"""Autoregressive generation (counterpart of paddle_tpu/models/generation.py):
greedy, top-k / top-p sampling, KV-cached or uncached. Greedy cached
decoding is the dense reference the paged decode engine's tokens are held
against.

* **Cached** (``use_cache=True`` and a model with `decode_step`): one
  prefill over the prompt, then one single-token step per new token
  against the contiguous per-layer caches.
* **Uncached** (``use_cache=False``, or a model without `decode_step`):
  each new token re-runs `model.forward` over the tokens so far and reads
  the logits of the last one. The reference runs its whole padded buffer
  and reads position ``i - 1``; causal attention makes the padding after
  it irrelevant, so the port runs ``buf[:, :i]``.
* **Sampling** draws as the reference's split-key loop does, with the
  port's threefry (`inference._threefry`): ``PRNGKey(seed)``, then
  ``key, sub = split(key)`` before every draw (the prefill's included)
  and ``categorical(sub, logits)`` of one key over the ``[B, V]`` logits.
  Top-k and top-p are `inference.sampling`'s filters, the engine's
  semantics. `import paddle_tpu` switches JAX to its "rbg" PRNG, so the
  JAX package draws these same tokens only under ``PADDLE_TPU_PRNG=
  threefry`` (or ``jax_default_prng_impl = threefry2x32``); a drawn token
  may differ from JAX's at a near-tie of the Gumbel-perturbed logits (the
  last bit of `log` differs between XLA and PyTorch).

Nothing is compiled, so the reference's per-structure program cache has
no counterpart: every call runs the model as it stands (after
`apply_lora`, `merge_lora` or a quantization alike).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate", "GenerationConfig"]


class GenerationConfig:
    """Decoding settings, the reference's arguments: ``do_sample=False``
    is greedy (argmax); otherwise the logits are divided by
    ``max(temperature, 1e-6)``, filtered by `top_k` (when > 0) and
    `top_p` (when < 1) and drawn from `seed`'s key stream. Tokens after
    `eos_token_id` are `pad_token_id`."""

    def __init__(self, max_new_tokens=32, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, pad_token_id=0,
                 seed=0, use_cache=True):
        self.max_new_tokens = int(max_new_tokens)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.seed = int(seed)
        self.use_cache = bool(use_cache)


def _sample_logits(logits, key, cfg):
    """The next token of each row of `logits` [B, V] f32: the argmax, or
    a draw under `key` (one key for the batch)."""
    # lazy import: models do not pull the serving stack at import time
    from ..inference import _threefry
    from ..inference import sampling as _samp

    if not cfg.do_sample:
        return logits.argmax(-1)
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        logits = _samp.apply_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _samp.apply_top_p(logits, cfg.top_p)
    return _threefry.categorical(key, logits)


@torch.no_grad()
def generate(model, input_ids, generation_config=None, **kwargs):
    """Greedy / top-k / top-p decoding. input_ids [B, S] (tensor or
    array). Returns [B, S + max_new_tokens] int32 on the model's device,
    padded with pad_token_id after eos. The model decodes in eval mode
    and is put back in training mode after, if it was."""
    from ..inference import _threefry

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
        key = _threefry.prng_key(torch.tensor(cfg.seed, device=dev)) \
            if cfg.do_sample else None
        cached = cfg.use_cache and hasattr(model, "decode_step")
        if cached:
            logits, caches = model.decode_step(
                ids, model.init_cache(b, total), 0)
        for i in range(s, total):
            if not cached:
                logits = model(buf[:, :i])
            sub = None
            if key is not None:
                key, sub = _threefry.split(key)
            nxt = _sample_logits(logits[:, -1].to(torch.float32), sub, cfg)
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id),
                              nxt)
            buf[:, i] = nxt
            done = done | (nxt == eos)
            if cached and i + 1 < total:
                logits, caches = model.decode_step(buf[:, i:i + 1], caches,
                                                   i)
        return buf.to(torch.int32)
    finally:
        if was_training:
            model.train()
