"""Port parity: `paddle_tpu_torch.models` (GPT and LLaMA variants,
contiguous-cache decode, greedy generation, weight-only quantized models)
against the JAX package's `models/gpt.py` and `generation.py`, with the
JAX weights loaded through `paddle_tpu_torch.convert`. Everything runs in
float32 on the CPU; tolerances are stated per check."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GenerationConfig
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.quant import quantize_for_inference as jquantize

from paddle_tpu_torch.convert import load_jax_state, params_from_jax
from paddle_tpu_torch.models import CacheQuantError, generate, gpt
from paddle_tpu_torch.models.gpt import PagedBatch
from paddle_tpu_torch.nn.quant import WeightOnlyLinear, quantize_for_inference

# the LLaMA-style config of tests/test_decode_engine.py (rope + GQA +
# SwiGLU + RMSNorm, untied head) and the GPT-style gpt_tiny (LayerNorm,
# GELU, learned positions, biases, tied head)
TINY_LLAMA = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
                  num_layers=2, rope=True, swiglu=True, rms_norm=True,
                  max_position_embeddings=64, tie_word_embeddings=False)
VARIANTS = {"llama": TINY_LLAMA, "gpt": dict(num_layers=2)}

# f32 through two layers with products summed in another order
LOGIT_ATOL = 1e-4


def _named(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(variant, seed=7):
    paddle.seed(seed)
    jm = jgpt("gpt_tiny", **VARIANTS[variant])
    jm.eval()
    tm = gpt("gpt_tiny", device="cpu", **VARIANTS[variant])
    load_jax_state(tm, _named(jm))
    return jm, tm


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return (request.param,) + _pair(request.param)


def _ids(seed, b=2, s=7, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def test_convert_transposes_linear_weights_only(pair):
    variant, jm, tm = pair
    named = _named(jm)
    conv = params_from_jax(named)
    for name, arr in named.items():
        t = conv[name].numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            np.testing.assert_array_equal(t, arr.T)
        else:                      # embeddings, norms, biases as they are
            np.testing.assert_array_equal(t, arr)
    assert set(named) == set(dict(tm.named_parameters()))


def test_forward_logits_match(pair):
    variant, jm, tm = pair
    ids = _ids(1)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_step_matches_jax(pair, quant):
    """Prefill 5 tokens, then two single-token steps, on both sides."""
    variant, jm, tm = pair
    ids = _ids(2, s=7)
    jc = jm.init_cache(2, 12, quant=quant)
    tc = tm.init_cache(2, 12, quant=quant)
    for lo, hi in ((0, 5), (5, 6), (6, 7)):
        jl, jc = jm.decode_step(paddle.to_tensor(ids[:, lo:hi]), jc,
                                paddle.to_tensor(np.int32(lo)))
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(ids[:, lo:hi]).long(),
                                    tc, lo)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   atol=LOGIT_ATOL)
    if quant == "int8":             # the cache contents agree too
        np.testing.assert_array_equal(tc[0][0][:, :7].numpy(),
                                      np.asarray(jc[0][0].numpy())[:, :7])


def test_greedy_generate_tokens_equal(pair):
    variant, jm, tm = pair
    ids = _ids(3, s=6)
    ref = np.asarray(jgenerate(jm, ids, GenerationConfig(
        max_new_tokens=10)).numpy())
    got = generate(tm, ids, max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, ref)
    if variant == "llama":     # its random init emits varied tokens
        assert len(set(got[0, 6:].tolist())) > 3


@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_quantized_model_matches_jax(wdt):
    """min_features=0 on both sides (the default 256 quantizes nothing at
    these widths); quantized buffers are byte-equal and logits agree."""
    jm, tm = _pair("llama", seed=11)
    jquantize(jm, wdt, min_features=0)
    quantize_for_inference(tm, wdt, min_features=0)
    assert isinstance(tm.transformer.layers[0].attn.qkv_proj,
                      WeightOnlyLinear)
    named = _named(jm)
    for name, buf in tm.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), named[name])
    ids = _ids(4)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)
    # and a quantized model loads from the JAX quantized state directly
    tm2 = quantize_for_inference(gpt("gpt_tiny", device="cpu", seed=3,
                                     **TINY_LLAMA), wdt, min_features=0)
    load_jax_state(tm2, named)
    with torch.no_grad():
        np.testing.assert_allclose(tm2(torch.from_numpy(ids).long()).numpy(),
                                   ref, atol=LOGIT_ATOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_step_matches_contiguous_step(quant):
    """The engine's paged path (blocks scattered through a table, kernel's
    plain version) equals the contiguous-cache decode step."""
    _, tm = _pair("llama", seed=5)
    ids = torch.from_numpy(_ids(6, b=1, s=9)).long()
    pool = tm.init_block_pool(8, 4, quant=quant)
    table = torch.tensor([5, 2, 7], dtype=torch.int64)
    cache = tm.init_cache(1, 12, quant=quant)
    with torch.no_grad():
        # prefill 8 tokens in two chunks of 4, then one decode step
        for lo in (0, 4):
            tm.decode_step_paged(ids[:, lo:lo + 4], pool.tensors,
                                 PagedBatch.prefill(table, lo, 4, 4))
        ref, cache = tm.decode_step(ids[:, :8], cache, 0)
        got = tm.decode_step_paged(
            ids[:, 8:9], pool.tensors,
            PagedBatch.decode(table[None].int(), torch.tensor([8],
                              dtype=torch.int32), 4))
        ref, _ = tm.decode_step(ids[:, 8:9], cache, 8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_cache_quant_precedence_and_typed_error():
    tm = gpt("gpt_tiny", device="cpu", **TINY_LLAMA)
    assert len(tm.init_cache(1, 4)[0]) == 2
    tm.cache_quant = "int8"
    assert len(tm.init_cache(1, 4)[0]) == 4          # attribute applies
    assert len(tm.init_cache(1, 4, quant="bf16")[0]) == 2   # argument wins
    with pytest.raises(CacheQuantError):
        tm.init_cache(1, 4, quant="fp4")
    with pytest.raises(CacheQuantError):
        tm.init_block_pool(4, 4, quant="int3")


def test_seeded_init_is_reproducible():
    a = gpt("gpt_tiny", device="cpu", seed=1, **TINY_LLAMA)
    b = gpt("gpt_tiny", device="cpu", seed=1, **TINY_LLAMA)
    c = gpt("gpt_tiny", device="cpu", seed=2, **TINY_LLAMA)
    wa, wb, wc = (m.transformer.wte.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.transformer.wte.weight.std().item() == pytest.approx(0.02,
                                                                  rel=0.2)
