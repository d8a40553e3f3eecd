"""A tiny decode-engine factory for harnesses and tests (counterpart of
paddle_tpu/inference/decode/demo.py): the same geometry (a LLaMA-style
model with rope, GQA and SwiGLU; 32-token window, 8-token blocks) with
the port's own seeded init, seeded by `generation` so a weight swap is
visible in the tokens. Tests that need the JAX demo's exact weights
convert them with `paddle_tpu_torch.convert.load_jax_state`.

    from paddle_tpu_torch.inference.decode.demo import tiny_engine
    eng = tiny_engine(generation=0, device="cpu")
    tokens = eng.generate(demo_prompt(5, 8), 8)

Not a serving surface: a deterministic fixture factory.
"""
from __future__ import annotations

import time

import numpy as np

VOCAB = 97          # prime, matching no bucket size
MAX_LENGTH = 32
BLOCK_SIZE = 8
#: the demo model's config overrides of gpt_tiny
TINY = dict(vocab_size=VOCAB, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)


def tiny_model(generation=0, device=None):
    """The demo model of `generation`: random weights from seed
    ``7 + generation`` (two generations decode different tokens)."""
    from ...models import gpt

    m = gpt("gpt_tiny", device=device, seed=7 + int(generation), **TINY)
    m.eval()
    return m


def tiny_engine(generation=0, model=None, **over):
    """A `DecodeEngine` over `tiny_model(generation)` (or `model`) with
    the small test geometry. The prefill buckets reach past the prompt
    length, so a failover's resume prompt (prompt + committed tokens)
    still admits, and 8 stays the chunk. Keyword overrides (``device``
    among them) pass to the engine."""
    from .engine import DecodeEngine

    kw = dict(max_length=MAX_LENGTH, block_size=BLOCK_SIZE,
              decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 24),
              default_timeout=30.0, step_timeout=30.0, step_retries=2,
              hang_grace=0.05, supervise_interval=0.01)
    kw.update(over)
    if model is None:
        model = tiny_model(generation, device=kw.get("device"))
    return DecodeEngine(model, **kw)


def tiny_engine_slow(generation=0, model=None, **over):
    """`tiny_engine` slowed through the fault hook (about 20 ms a step),
    so a harness can kill, wedge or swap a replica while a stream is in
    flight. Same weights, same tokens."""

    def _throttle(tag, ids, info):
        time.sleep(0.02)

    over.setdefault("fault_hook", _throttle)
    return tiny_engine(generation, model=model, **over)


def demo_prompt(seed, length):
    """Deterministic prompt ids for `seed`."""
    return np.random.RandomState(int(seed)).randint(
        0, VOCAB, (int(length),)).astype(np.int32)
