"""Port parity of per-request sampling (`paddle_tpu_torch.inference.sampling`
and its threefry RNG) against `paddle_tpu.inference.sampling` and
`jax.random`, plus the engine-level sampling contract on the port:
temperature <= 0 is greedy bit for bit, a greedy row is untouched by a
sampled batchmate, a seeded stream is reproducible across engines, and
stop sequences truncate with the hold-back invariant.

Exactness: the random bits, keys and uniforms are bitwise equal to
JAX's threefry; the Gumbel noise goes through `log`, whose last bit may
differ between XLA and PyTorch, so a drawn token can differ only at a
near-tie (none in these draws).

`import paddle_tpu` switches JAX's default PRNG to "rbg" (XLA's
RngBitGenerator; `PADDLE_TPU_PRNG=threefry` keeps threefry), and the JAX
sampler builds its keys with the default. The port reproduces threefry,
so the JAX side runs here with `jax_default_prng_impl = threefry2x32`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import SamplingParams as JSamplingParams
from paddle_tpu.inference import sampling as jsamp

from paddle_tpu_torch.inference import DecodeEngine, SamplingParams
from paddle_tpu_torch.inference import _threefry as tf
from paddle_tpu_torch.inference import sampling as samp
from paddle_tpu_torch.models import gpt

SEEDS = (0, 1, 77, 2 ** 31 + 5, 2 ** 32 - 1)
CTRS = (0, 1, 5, 999, 2 ** 31 - 1)


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


def _jkey(seed, ctr):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)),
                              jnp.int32(ctr))


def _tkey(seed, ctr):
    return tf.fold_in(tf.prng_key(torch.tensor([seed])), torch.tensor([ctr]))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_equal_jax(seed):
    for ctr in CTRS:
        jk = np.asarray(_jkey(seed, ctr), np.uint32).astype(np.int64)
        tk = _tkey(seed, ctr)
        assert [int(tk[0][0]), int(tk[1][0])] == jk.tolist()
        for n in (1, 33, 1000):
            jb = np.asarray(jax.random.bits(_jkey(seed, ctr), (n,)),
                            np.uint32).astype(np.int64)
            assert np.array_equal(tf.random_bits(tk, n)[0].numpy(), jb)


def test_threefry_uniform_bitwise_and_gumbel_close():
    tiny = jnp.finfo(jnp.float32).tiny
    for seed in SEEDS:
        for ctr in CTRS[:3]:
            ju = np.asarray(jax.random.uniform(_jkey(seed, ctr), (257,),
                                               minval=tiny))
            tu = tf.uniform(_tkey(seed, ctr), 257, tf._TINY)[0].numpy()
            assert np.array_equal(ju, tu)
            jg = np.asarray(jax.random.gumbel(_jkey(seed, ctr), (257,)))
            tg = tf.gumbel(_tkey(seed, ctr), 257)[0].numpy()
            np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)


def _rows(seed, n=6, v=50):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 2.0).astype(np.float32)
    logits[1, ::3] = -np.inf                      # masked vocab entries
    logits[4, 10:] = -np.inf
    return logits


# per row: (greedy, temp, top_k, top_p, rep, seed)
KNOBS = ((0, 1.0, 0, 1.0, 1.0, 3), (0, 0.8, 10, 0.9, 1.0, 11),
         (1, 0.7, 5, 0.5, 1.3, 12), (0, 1.3, 0, 0.6, 1.2, 2 ** 32 - 2),
         (0, 0.5, 3, 1.0, 1.0, 0), (0, 1.0, 0, 0.95, 0.8, 99))


def test_sample_token_equals_jax_over_many_draws():
    """400+ draws: six rows with mixed knobs (a greedy row, -inf masked
    rows, repetition penalties above and below 1) over 70 counters."""
    logits = _rows(5)
    hist = np.full((len(KNOBS), 12), -1, np.int32)
    hist[2, :3] = [4, 7, 7]
    hist[3, :2] = [1, 2]
    hist[5, :4] = [0, 9, 30, 49]
    pack_t = {name: torch.tensor([k[i] for k in KNOBS], dtype=dt)
              for i, (name, dt) in enumerate(
                  (("greedy", torch.int32), ("temp", torch.float32),
                   ("top_k", torch.int64), ("top_p", torch.float32),
                   ("rep", torch.float32), ("seed", torch.int64)))}

    def jrow(lg, hrow, knob, ctr):
        g, t, k, p, r, s = knob
        sp = {"ctr": jnp.int32(ctr), "greedy": jnp.int32(g),
              "rep": jnp.float32(r), "seed": jnp.uint32(s),
              "temp": jnp.float32(t), "top_k": jnp.int32(k),
              "top_p": jnp.float32(p)}
        return int(jsamp.sample_token(jnp.asarray(lg), sp,
                                      jnp.asarray(hrow)))

    got, ref = [], []
    for ctr in range(70):
        pack = dict(pack_t, ctr=torch.full((len(KNOBS),), ctr,
                                           dtype=torch.int64))
        got += samp.sample_token(torch.from_numpy(logits), pack,
                                 torch.from_numpy(hist).long()).tolist()
        ref += [jrow(logits[i], hist[i], KNOBS[i], ctr)
                for i in range(len(KNOBS))]
    assert got == ref
    assert len(set(got[1::len(KNOBS)])) > 3          # the draws are live
    assert all(np.isfinite(logits[1][t]) for t in got[1::len(KNOBS)])
    assert all(t < 10 for t in got[4::len(KNOBS)])


@pytest.mark.parametrize("k", [0, 1, 2, 7, 50, 60])
def test_top_k_mask_equals_jax(k):
    logits = _rows(k)
    got = samp.apply_top_k(torch.from_numpy(logits), k).numpy()
    ref = np.stack([np.asarray(jsamp.apply_top_k(jnp.asarray(r), k))
                    for r in logits])
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.9, 1.0])
def test_top_p_mask_equals_jax(p):
    logits = _rows(int(p * 100))
    got = samp.apply_top_p(torch.from_numpy(logits), p).numpy()
    ref = np.stack([np.asarray(jsamp.apply_top_p(jnp.asarray(r),
                                                 jnp.float32(p)))
                    for r in logits])
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.array_equal(got[np.isfinite(got)], ref[np.isfinite(ref)])


@pytest.mark.parametrize("penalty", [1.0, 1.5, 0.7])
def test_repetition_penalty_equals_jax(penalty):
    logits = _rows(9)
    hist = np.full((logits.shape[0], 8), -1, np.int32)
    hist[0, :4] = [1, 1, 5, 49]
    hist[3, :1] = [0]
    got = samp.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(hist).long(),
        penalty).numpy()
    ref = np.stack([np.asarray(jsamp.apply_repetition_penalty(
        jnp.asarray(r), jnp.asarray(h), jnp.float32(penalty)))
        for r, h in zip(logits, hist)])
    assert np.array_equal(got, ref)


def test_params_validation_is_loud():
    for bad in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1),
                dict(repetition_penalty=0.0), dict(seed=2 ** 32),
                dict(stop_sequences=[()])):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
        with pytest.raises(ValueError):
            JSamplingParams(**bad)
    assert SamplingParams(temperature=0.0).is_greedy()
    assert not SamplingParams(temperature=0.5).is_greedy()


def test_params_wire_roundtrip_matches_jax():
    kw = dict(temperature=0.7, top_k=11, top_p=0.9, repetition_penalty=1.3,
              seed=42, stop_sequences=[(5, 6), [7]])
    sp = SamplingParams(**kw)
    rt = SamplingParams.from_dict(sp.to_dict())
    assert rt.to_dict() == sp.to_dict()
    assert rt.stop_sequences == ((5, 6), (7,))
    assert sp.to_dict() == JSamplingParams(**kw).to_dict()
    # the JAX wire form is accepted as it is
    assert SamplingParams.from_dict(
        JSamplingParams(**kw).to_dict()).to_dict() == sp.to_dict()


# ---------------------------------------------------------------------------
# the engine's sampling contract (port only)
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)
GEO = dict(max_length=32, block_size=8, decode_buckets=(1, 2),
           prefill_buckets=(8, 16), prefill_chunk=8, default_timeout=60.0,
           device="cpu")


@pytest.fixture(scope="module")
def model():
    return gpt("gpt_tiny", device="cpu", seed=7, **TINY)


@pytest.fixture(scope="module")
def eng(model):
    e = DecodeEngine(model, **GEO)
    yield e
    e.shutdown(drain_timeout=10.0)


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (n,)).astype(np.int32)


def test_temperature_zero_is_bitwise_greedy(eng):
    p = _prompt(0)
    ref = eng.generate(p, 10)
    got = eng.generate(p, 10, sampling=SamplingParams(
        temperature=0.0, top_k=3, top_p=0.4, repetition_penalty=2.0,
        seed=99))
    assert got == ref


def test_mixed_batch_leaves_greedy_untouched(eng):
    p = _prompt(0)
    ref = eng.generate(p, 10)
    g = eng.submit(p, 10)
    s = eng.submit(_prompt(1), 10, sampling=SamplingParams(
        temperature=0.9, top_k=8, seed=5))
    assert g.result() == ref
    assert len(s.result()) == 10
    assert eng.stats()["sampled"] >= 1


def test_seeded_stream_reproducible_across_engines(model, eng):
    """The draw is a pure function of (seed, output index): a second run,
    a batch with a mate and a fresh engine give the same stream."""
    p = _prompt(2, 12)
    sp = SamplingParams(temperature=0.9, top_k=12, top_p=0.95,
                        repetition_penalty=1.2, seed=123)
    first = eng.generate(p, 10, sampling=sp)
    assert eng.generate(p, 10, sampling=sp) == first
    a = eng.submit(p, 10, sampling=sp)
    b = eng.submit(_prompt(3), 10)
    assert a.result() == first and len(b.result()) == 10
    with DecodeEngine(model, **GEO) as e2:
        assert e2.generate(p, 10, sampling=sp) == first
    outs = {tuple(eng.generate(p, 10, sampling=SamplingParams(
        temperature=1.5, seed=s))) for s in (1, 2, 3, 4)}
    assert len(outs) > 1


def test_stop_sequence_truncates_before_match(eng):
    p = _prompt(4)
    ref = eng.generate(p, 12)
    idx, stop = next(
        (i, tuple(ref[i:i + 2])) for i in range(1, len(ref) - 1)
        if tuple(ref[i:i + 2]) not in
        {tuple(ref[j:j + 2]) for j in range(i)})
    s = eng.submit(p, 12, sampling=SamplingParams(
        temperature=0.0, stop_sequences=[stop]))
    assert s.result() == ref[:idx]
    assert s.status == "completed"
    assert eng.stats()["stop_hits"] >= 1


def test_holdback_tail_flushes_on_completion(eng):
    p = _prompt(4)
    ref = eng.generate(p, 10)
    never = (int(ref[-1]), TINY["vocab_size"] + 7)
    got = eng.generate(p, 10, sampling=SamplingParams(
        temperature=0.0, stop_sequences=[never]))
    assert got == ref
