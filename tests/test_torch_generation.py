"""Port parity of `paddle_tpu_torch.models.generation.generate` (greedy and
sampled, KV-cached and uncached) and of the one-key threefry draws it
makes, against `paddle_tpu.models.generate` and `jax.random`, on a
2-layer LLaMA-style gpt_tiny (rope, SwiGLU, vocab 128; f32, CPU) with the
same weights (`convert`).

Exactness: keys, split keys, bits and uniforms are bitwise JAX's; the
Gumbel noise goes through `log`, whose last bit may differ between XLA
and PyTorch, and the logits are f32 sums in another order, so a token may
differ only at a near-tie. Every test that compares tokens first checks
that its draws have none: at every step the winner leads the runner-up by
more than `TIE` (the argmax of the logits, or of the Gumbel-perturbed
filtered logits for a draw), so equal tokens are the only outcome.

`import paddle_tpu` switches JAX's default PRNG to "rbg"; the JAX side
runs here with ``jax_default_prng_impl = threefry2x32``, the stream the
port reproduces."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GenerationConfig as JConfig
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import _threefry as tf
from paddle_tpu_torch.inference import sampling as samp
from paddle_tpu_torch.models import GenerationConfig, generate, gpt
from paddle_tpu_torch.nn.lora import LoRAConfig, apply_lora, merge_lora

TINY = dict(num_layers=2, rope=True, swiglu=True, vocab_size=128,
            max_position_embeddings=64)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=10, top_p=0.9)
#: the least lead of a winner that makes both sides pick it (f32 logits
#: agree to ~1e-6 here)
TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threefry_default():
    from paddle_tpu.ops import random as prandom

    old, key = jax.config.jax_default_prng_impl, prandom._gen.key
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)
    # a root key drawn under threefry (paddle.seed here) does not fit the
    # restored impl: later modules get the key they had
    prandom._gen.key = key


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jgpt("gpt_tiny", **TINY)
    jm.eval()
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def _ids(seed, b=3, s=7):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int32)


def _jax_tokens(jm, ids, **cfg):
    return np.asarray(jgenerate(jm, paddle.to_tensor(ids),
                                JConfig(**cfg)).numpy())


def _jkey_ints(key):
    return np.asarray(key, np.uint32).astype(np.int64).tolist()


def _tkey_ints(key):
    return [int(key[0]), int(key[1])]


# ---------------------------------------------------------------------------
# threefry: split and one key over a [B, V] shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 77, 2 ** 31 - 1])
def test_split_chain_equals_jax(seed):
    """The cached path's schedule, 6 splits deep: every kept key and
    every subkey bitwise JAX's."""
    jk = jax.random.PRNGKey(seed)
    tk = tf.prng_key(torch.tensor(seed))
    assert _tkey_ints(tk) == _jkey_ints(jk)
    for _ in range(6):
        jk, jsub = jax.random.split(jk)
        tk, tsub = tf.split(tk)
        assert _tkey_ints(tk) == _jkey_ints(jk)
        assert _tkey_ints(tsub) == _jkey_ints(jsub)
    three = tf.split(tk, 3)
    assert [_tkey_ints(k) for k in three] == [
        _jkey_ints(k) for k in jax.random.split(jk, 3)]


@pytest.mark.parametrize("shape", [(3, 77), (8, 128), (1, 5), (2, 3, 4)])
def test_bits_and_uniform_of_a_shape_equal_jax(shape):
    tiny = np.finfo(np.float32).tiny
    for seed in (0, 9, 2 ** 32 - 1):
        jk = jax.random.split(jax.random.PRNGKey(seed))[1]
        tk = tf.split(tf.prng_key(torch.tensor(seed)))[1]
        jb = np.asarray(jax.random.bits(jk, shape), np.uint32).astype(
            np.int64)
        assert np.array_equal(tf.random_bits(tk, shape).numpy(), jb)
        ju = np.asarray(jax.random.uniform(jk, shape, minval=tiny))
        assert np.array_equal(tf.uniform(tk, shape, tf._TINY).numpy(), ju)
        jg = np.asarray(jax.random.gumbel(jk, shape))
        np.testing.assert_allclose(tf.gumbel(tk, shape).numpy(), jg,
                                   rtol=1e-6, atol=1e-6)


def test_one_key_over_rows_is_not_row_keys():
    """One key over [B, V] draws B * V counters of that key: row 1 of it
    is not what a row key of the same value draws (the engine's
    sampler)."""
    k = tf.prng_key(torch.tensor(3))
    shared = tf.random_bits(k, (2, 16))
    rows = tf.random_bits((k[0].reshape(1).expand(2),
                           k[1].reshape(1).expand(2)), 16)
    assert torch.equal(shared[0], rows[0])
    assert not torch.equal(shared[1], rows[1])
    assert torch.equal(shared.reshape(-1),
                       tf.random_bits(k, 32))


def _lead(x):
    """Winner minus runner-up of each row (finite entries)."""
    top = torch.topk(x, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@pytest.mark.parametrize("seed", [0, 1, 5, 123])
def test_categorical_of_one_key_equals_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 200) * 2.0).astype(np.float32)
    logits[2, ::4] = -np.inf
    jk = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = tf.split(tf.prng_key(torch.tensor(seed)))[1]
    t = torch.from_numpy(logits)
    noisy = tf.gumbel(tk, tuple(t.shape)) + t
    assert bool((_lead(noisy) > TIE).all())
    ref = np.asarray(jax.random.categorical(jk, logits))
    assert tf.categorical(tk, t).tolist() == ref.tolist()


# ---------------------------------------------------------------------------
# generate against the JAX package
# ---------------------------------------------------------------------------

@torch.no_grad()
def _step_logits(tm, out, s):
    """The logits each new token of `out` [B, S + n] was chosen from,
    [n, B, V] (one forward over all of it: causal)."""
    logits = tm(torch.from_numpy(out).long())
    return logits[:, s - 1:out.shape[1] - 1].transpose(0, 1).float()


def _assert_no_greedy_tie(tm, out, s):
    leads = _lead(_step_logits(tm, out, s))
    assert float(leads.min()) > TIE, float(leads.min())


def _assert_no_sampled_tie(tm, out, s, cfg):
    """Replay the reference's key schedule over the tokens' logits: the
    winner of every Gumbel-perturbed, filtered row leads by > TIE."""
    key = tf.prng_key(torch.tensor(cfg["seed"]))
    for logits in _step_logits(tm, out, s):
        key, sub = tf.split(key)
        l = logits / max(cfg["temperature"], 1e-6)
        l = samp.apply_top_p(samp.apply_top_k(l, cfg["top_k"]),
                             cfg["top_p"])
        noisy = tf.gumbel(sub, tuple(l.shape)) + l
        assert float(_lead(noisy).min()) > TIE


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_tokens_equal_jax(pair, use_cache):
    jm, tm = pair
    ids = _ids(3)
    ref = _jax_tokens(jm, ids, max_new_tokens=9, use_cache=use_cache)
    _assert_no_greedy_tie(tm, ref, 7)
    got = generate(tm, ids, max_new_tokens=9, use_cache=use_cache)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_eos_pads_like_jax(pair, use_cache):
    """eos is a token the greedy run emits mid-stream: the port pads after
    it exactly where JAX does."""
    jm, tm = pair
    ids = _ids(4)
    free = _jax_tokens(jm, ids, max_new_tokens=10)
    _assert_no_greedy_tie(tm, free, 7)
    eos = int(free[0, 7 + 3])
    ref = _jax_tokens(jm, ids, max_new_tokens=10, eos_token_id=eos,
                      pad_token_id=1, use_cache=use_cache)
    assert (ref[0, 7 + 4:] == 1).all()
    got = generate(tm, ids, GenerationConfig(
        max_new_tokens=10, eos_token_id=eos, pad_token_id=1,
        use_cache=use_cache)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_sampled_tokens_equal_jax(pair, use_cache, seed):
    jm, tm = pair
    ids = _ids(10 + seed)
    cfg = dict(SAMPLED, seed=seed)
    ref = _jax_tokens(jm, ids, max_new_tokens=8, use_cache=use_cache, **cfg)
    _assert_no_sampled_tie(tm, ref, 7, cfg)
    got = generate(tm, ids, max_new_tokens=8, use_cache=use_cache, **cfg)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampled_temperature_only_equals_jax(pair):
    """No filter: the temperature alone, at 1.3."""
    jm, tm = pair
    ids = _ids(21)
    cfg = dict(do_sample=True, temperature=1.3, top_k=0, top_p=1.0, seed=3)
    ref = _jax_tokens(jm, ids, max_new_tokens=6, **cfg)
    _assert_no_sampled_tie(tm, ref, 7, cfg)
    np.testing.assert_array_equal(
        generate(tm, ids, max_new_tokens=6, **cfg).numpy(), ref)


@pytest.mark.parametrize("sampled", [False, True])
def test_cached_equals_uncached(pair, sampled):
    _, tm = pair
    ids = _ids(30, b=2, s=12)
    cfg = dict(SAMPLED, seed=9) if sampled else {}
    a = generate(tm, ids, max_new_tokens=8, use_cache=True, **cfg)
    b = generate(tm, ids, max_new_tokens=8, use_cache=False, **cfg)
    assert torch.equal(a, b)


def test_sampled_reruns_equal_and_seeds_differ(pair):
    _, tm = pair
    ids = _ids(40)
    a = generate(tm, ids, max_new_tokens=10, seed=1, **SAMPLED)
    b = generate(tm, ids, max_new_tokens=10, seed=1, **SAMPLED)
    c = generate(tm, ids, max_new_tokens=10, seed=2, **SAMPLED)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_training_mode_restored_and_zero_new_tokens(pair):
    _, tm = pair
    ids = _ids(41)
    tm.train()
    try:
        out = generate(tm, ids, max_new_tokens=2)
        assert tm.training and out.shape == (3, 9)
    finally:
        tm.eval()
    assert torch.equal(generate(tm, ids, max_new_tokens=0),
                       torch.from_numpy(ids))


def test_tokens_unchanged_by_apply_lora_then_merge():
    """The JAX package's compiled-program cache test
    (tests/test_p2p_spawn.py): generate, then apply_lora (B = 0: a no-op),
    then merge_lora, and the same tokens each time."""
    m = gpt("gpt_tiny", device="cpu", seed=0)
    m.eval()
    prompt = np.zeros((1, 4), np.int32)
    cfg = GenerationConfig(max_new_tokens=4, do_sample=False, use_cache=True)
    out0 = generate(m, prompt, cfg)
    apply_lora(m, LoRAConfig(r=2))
    out1 = generate(m, prompt, cfg)
    merge_lora(m)
    out2 = generate(m, prompt, cfg)
    assert torch.equal(out0, out1) and torch.equal(out0, out2)
