"""Port parity and semantics of multi-tenant LoRA serving
(`paddle_tpu_torch.inference.decode.adapter_pool` + the engine): the
matched layer names are the JAX pool's, a mixed-adapter batch is bitwise
equal to solo runs (f32, CPU), tokens with adapters equal one JAX adapter
engine run (greedy, and sampled with a fixed seed), the prefix cache
keys by adapter signature, and the pool's bookkeeping is the JAX pool's:
LRU eviction, `OutOfAdapterSlots`, the generation-stamped swap, typed
`AdapterNotLoaded`, loud shape and refcount misuse.

`import paddle_tpu` switches JAX's default PRNG to "rbg"; the sampled
JAX run uses threefry, the stream the port reproduces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import AdapterPool as JAdapterPool
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.inference import SamplingParams as JSamplingParams
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import (AdapterNotLoaded, AdapterPool,
                                        DecodeEngine, OutOfAdapterSlots,
                                        SamplingParams)
from paddle_tpu_torch.inference.decode.adapter_pool import adapter_context
from paddle_tpu_torch.models import gpt

TINY = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)
GEO = dict(max_length=32, block_size=8, decode_buckets=(1, 4),
           prefill_buckets=(8,), default_timeout=60.0)
RANK = 4


def _weights(layers, seed):
    """Random A/B per matched layer, small enough that adapted logits stay
    near (not equal to) the base model's."""
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(i, RANK).astype(np.float32) * 0.05,
                   rng.randn(RANK, o).astype(np.float32) * 0.05)
            for name, (i, o) in sorted(layers.items())}


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = jgpt("gpt_tiny", **TINY)
    jm.eval()
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pool(models):
    p = AdapterPool(models[1], rank=RANK, slots=4, device="cpu")
    p.load("t0", _weights(p.layers, 100))
    p.load("t1", _weights(p.layers, 101))
    yield p
    p.detach()


@pytest.fixture(scope="module")
def eng(models, pool):
    e = DecodeEngine(models[1], **GEO, adapters=pool, device="cpu")
    yield e
    e.shutdown(drain_timeout=10.0)


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (n,)).astype(np.int32)


def test_matched_layer_names_are_the_jax_pools(models, pool):
    jpool = JAdapterPool(models[0], rank=RANK, slots=4)
    try:
        jl = {k: (ab[0].shape[1], ab[1].shape[2])
              for k, ab in jpool.stacks().items()}
    finally:
        jpool.detach()
    assert pool.layers == jl
    assert len(jl) == 2 * TINY["num_layers"]


def test_slot0_rows_are_the_base_output_bitwise(models, pool):
    """The hook selects slot-0 rows back to the base projection output;
    adapted rows differ."""
    tm = models[1]
    name = sorted(pool.layers)[0]
    lin = tm.get_submodule(name)
    x = torch.randn(3, 1, lin.in_features, generator=torch.Generator()
                    .manual_seed(0))
    base = lin(x)
    slot = pool.stats()["adapters"]["t0"]["slot"]
    with adapter_context(pool.stacks(),
                         torch.tensor([0, slot, 0], dtype=torch.int32)):
        got = lin(x)
    assert torch.equal(got[0], base[0]) and torch.equal(got[2], base[2])
    assert not torch.equal(got[1], base[1])


def test_mixed_batch_bit_identical_to_solo(eng):
    prompts = [_prompt(i) for i in range(3)]
    tenants = [None, "t0", "t1"]
    solo = [eng.generate(p, 8, adapter=a) for p, a in zip(prompts, tenants)]
    assert len({tuple(s) for s in solo}) == 3
    streams = [eng.submit(p, 8, adapter=a) for p, a in zip(prompts, tenants)]
    assert [s.result() for s in streams] == solo
    st = eng.stats()["adapters"]
    assert st["refs"] == 0 and st["loaded"] == 2


def test_adapter_signature_keys_the_prefix_cache(eng):
    """The same prompt under the base model and under t0 gives different
    tokens; a resubmission hits only its own adapter's entry."""
    p = _prompt(10)
    base = eng.generate(p, 6)
    t0 = eng.generate(p, 6, adapter="t0")
    assert base != t0
    before = eng.stats()["prefix_cache"]["full_hits"]
    assert eng.generate(p, 6, adapter="t0") == t0
    assert eng.generate(p, 6) == base
    assert eng.stats()["prefix_cache"]["full_hits"] - before == 2


@pytest.fixture
def threefry():
    from paddle_tpu.ops import random as prandom

    old, key = jax.config.jax_default_prng_impl, prandom._gen.key
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)
    # a root key drawn under threefry (paddle.seed here) does not fit the
    # restored impl: later modules get the key they had
    prandom._gen.key = key


def test_tokens_match_one_jax_adapter_engine(models, pool, threefry,
                                             tmp_path, monkeypatch):
    """Greedy and seeded-sampled requests under base / t0 / t1 through one
    JAX engine with the same adapter weights (private compile cache)."""
    jm, tm = models
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    jpool = JAdapterPool(jm, rank=RANK, slots=4)
    jpool.load("t0", _weights(pool.layers, 100))
    jpool.load("t1", _weights(pool.layers, 101))
    reqs = [(_prompt(20), None, None), (_prompt(21), "t0", None),
            (_prompt(22, 5), "t1", None),
            (_prompt(23), "t0", dict(temperature=0.8, top_k=10, seed=77)),
            (_prompt(24, 6), "t1", dict(temperature=1.1, top_p=0.9,
                                         seed=5))]
    je = JDecodeEngine(jm, **GEO, num_blocks=18, prefix_cache=False,
                       adapters=jpool)
    try:
        js = [je.submit(p, 8, adapter=a,
                        sampling=None if s is None else JSamplingParams(**s))
              for p, a, s in reqs]
        ref = [s.result() for s in js]
    finally:
        je.shutdown()
        jpool.detach()
    with DecodeEngine(tm, **GEO, adapters=pool, device="cpu") as e:
        got = [e.submit(p, 8, adapter=a, sampling=s) for p, a, s in reqs]
        assert [s.result() for s in got] == ref
    assert len({tuple(r) for r in ref}) == len(ref)


# ---------------------------------------------------------------------------
# pool bookkeeping
# ---------------------------------------------------------------------------

def _mini_pool(slots=3):
    m = gpt("gpt_tiny", device="cpu", seed=3, vocab_size=31, hidden_size=16,
            num_heads=2, num_kv_heads=2, num_layers=1,
            max_position_embeddings=16)
    return AdapterPool(m, rank=RANK, slots=slots, device="cpu")


def test_refcount_misuse_is_loud():
    pool = _mini_pool()
    try:
        pool.load("a", _weights(pool.layers, 1))
        slot, gen = pool.acquire("a", "owner-1")
        with pytest.raises(ValueError, match="referenced"):
            pool.unload("a")
        with pytest.raises(ValueError, match="no reference"):
            pool.release(slot, "owner-2")
        pool.release(slot, "owner-1")
        with pytest.raises(ValueError, match="no reference"):
            pool.release(slot, "owner-1")
        assert pool.release_owned("owner-1") == 0
        pool.unload("a")
        with pytest.raises(AdapterNotLoaded):
            pool.unload("a")
    finally:
        pool.detach()


def test_lru_eviction_and_slot_backpressure():
    pool = _mini_pool(slots=3)            # 2 usable, slot 0 reserved
    try:
        pool.load("a", _weights(pool.layers, 1))
        pool.load("b", _weights(pool.layers, 2))
        pool.acquire("a", "s1")
        pool.acquire("b", "s2")
        with pytest.raises(OutOfAdapterSlots):
            pool.load("c", _weights(pool.layers, 3))
        pool.release_owned("s1")          # "a" idle -> the LRU victim
        pool.load("c", _weights(pool.layers, 3))
        st = pool.stats()
        assert st["evictions"] == 1 and st["loaded"] == 2
        with pytest.raises(AdapterNotLoaded):
            pool.acquire("a", "s3")
        pool.release_owned("s2")
    finally:
        pool.detach()


def test_generation_stamped_swap_pins_old_slot():
    pool = _mini_pool(slots=4)
    try:
        w1 = _weights(pool.layers, 1)
        pool.load("a", w1)
        old_slot, old_gen = pool.acquire("a", "s1")
        pool.load("a", _weights(pool.layers, 9))      # swap under load
        new_slot, new_gen = pool.acquire("a", "s2")
        assert new_slot != old_slot and new_gen > old_gen
        name = sorted(pool.layers)[0]
        a_old = pool.stacks()[name][0][old_slot]
        assert torch.equal(a_old, torch.from_numpy(w1[name][0]))
        st = pool.stats()
        assert st["swaps"] == 1 and st["pinned_anonymous"] == 1
        pool.release(old_slot, "s1")      # last holder frees the old slot
        st = pool.stats()
        assert st["pinned_anonymous"] == 0 and st["used"] == 1
        pool.release_owned("s2")
        assert pool.load("a", _weights(pool.layers, 10)) == new_slot
        assert pool.stats()["swaps"] == 1
    finally:
        pool.detach()


def test_adapter_not_loaded_is_a_typed_request_error(models, eng):
    assert issubclass(AdapterNotLoaded, ValueError)
    with pytest.raises(AdapterNotLoaded):
        eng.submit(_prompt(0), 4, adapter="nope")
    assert eng.stats()["adapters"]["refs"] == 0
    with DecodeEngine(models[1], **GEO, device="cpu") as plain:
        with pytest.raises(AdapterNotLoaded, match="no adapter pool"):
            plain.submit(_prompt(0), 4, adapter="t0")
    with pytest.raises(ValueError, match="AdapterPool"):
        DecodeEngine(models[1], **GEO, adapters=object(), device="cpu")


def test_load_shape_mismatch_is_loud():
    pool = _mini_pool()
    try:
        w = _weights(pool.layers, 1)
        bad = {k: (v[0][:, :-1], v[1]) for k, v in w.items()}
        with pytest.raises(ValueError, match="expected A"):
            pool.load("a", bad)
        first = next(iter(w))
        with pytest.raises(ValueError, match="missing weights"):
            pool.load("a", {k: v for k, v in w.items() if k != first})
        # a JAX adapter loads as it is
        jw = {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in w.items()}
        slot = pool.load("a", jw)
        assert torch.equal(pool.stacks()[first][0][slot],
                           torch.from_numpy(w[first][0]))
        with pytest.raises(ValueError, match="rank must be"):
            AdapterPool(gpt("gpt_tiny", device="cpu"), rank=0, device="cpu")
    finally:
        pool.detach()
