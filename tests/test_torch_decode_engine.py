"""Port parity and semantics of the paged decode engine
(`paddle_tpu_torch.inference.decode`): the block-pool allocator laws,
engine tokens against the JAX dense `generate()` and one JAX
`DecodeEngine` run (float32 and int8 KV), the port's determinism contract
(a sequence's tokens are the same alone and in a batch), iteration-level
scheduling, typed deadline / cancel / overload / shutdown semantics, and
the unported options raising. Runs on the CPU in float32."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models import GenerationConfig
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import (DeadlineExceeded, DecodeEngine,
                                        Overloaded, PoolClosed)
from paddle_tpu_torch.inference.decode.block_pool import (
    BlockKVCache, OutOfBlocks, RESERVED_BLOCKS)
from paddle_tpu_torch.models import gpt

TINY = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)
MIX = ((1, 6, 10), (2, 11, 4), (3, 17, 7))    # (seed, prompt len, new)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = jgpt("gpt_tiny", **TINY)
    jm.eval()
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _engine(tm, **kw):
    kw.setdefault("max_length", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("decode_buckets", (1, 2, 4))
    kw.setdefault("prefill_buckets", (8, 16, 32))
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("default_timeout", 60.0)
    kw.setdefault("device", "cpu")
    return DecodeEngine(tm, **kw)


@pytest.fixture(scope="module")
def eng(models):
    e = _engine(models[1])
    yield e
    e.shutdown(drain_timeout=10.0)


def _prompt(seed, n=6):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (n,)).astype(np.int32)


def _jax_dense(jm, prompt, new, quant=None):
    jm.cache_quant = quant
    try:
        out = jgenerate(jm, prompt[None], GenerationConfig(
            max_new_tokens=new)).numpy()
    finally:
        jm.cache_quant = None
    return list(np.asarray(out)[0, len(prompt):])


# ---------------------------------------------------------------------------
# block pool
# ---------------------------------------------------------------------------

def _pool(num_blocks=6, block_size=4):
    spec = (((2, 4), torch.float32), ((2, 4), torch.float32))
    return BlockKVCache(num_blocks, block_size, [spec])


def test_block_pool_alloc_free_conservation():
    pool = _pool()
    a = pool.alloc(2, owner="a")
    b = pool.alloc(3, owner="b")
    assert len(set(a) | set(b)) == 5 and 0 not in a + b
    s = pool.stats()
    assert s["allocated"] + s["free"] + s["reserved"] == s["total"]
    pool.free(a)
    assert pool.free_owned("b") == 3
    s = pool.stats()
    assert s["allocated"] == 0 and s["allocs"] == 5 and s["frees"] == 5
    assert pool.free_owned("b") == 0


def test_block_pool_all_or_nothing_exhaustion():
    pool = _pool(num_blocks=4)
    pool.alloc(2, owner="x")
    with pytest.raises(OutOfBlocks):
        pool.alloc(2, owner="y")
    s = pool.stats()
    assert s["free"] == 1 and s["failed_allocs"] == 1


def test_block_pool_double_free_and_refcounts():
    pool = _pool()
    blocks = pool.alloc(1, owner="x")
    pool.incref(blocks, owner="y")
    with pytest.raises(ValueError):
        pool.free(blocks)               # shared: must decref
    assert pool.decref(blocks, owner="y") == 0
    pool.free(blocks)
    with pytest.raises(ValueError):
        pool.free(blocks)               # double free
    with pytest.raises(ValueError):
        pool.free([0])                  # reserved id
    with pytest.raises(ValueError):
        pool.decref(blocks, owner="x")


def test_block_pool_geometry_and_copy():
    pool = _pool(num_blocks=6, block_size=4)
    assert pool.blocks_for(1) == 1 and pool.blocks_for(5) == 2
    assert pool.capacity_tokens == (6 - RESERVED_BLOCKS) * 4
    assert pool.tensors[0][0].shape == (6, 4, 2, 4)
    pool.tensors[0][0][2] = 3.0
    pool.copy_block(2, 4)
    assert torch.equal(pool.tensors[0][0][4], pool.tensors[0][0][2])


# ---------------------------------------------------------------------------
# engine vs the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
def test_mixed_batch_matches_jax_generate(models, quant):
    """A mixed batch (chunked prefill of a 17-token prompt included)
    through the port engine equals JAX dense greedy generate() per
    sequence."""
    jm, tm = models
    with _engine(tm, quant=quant) as e:
        streams = [e.submit(_prompt(s, n), k) for s, n, k in MIX]
        got = [s.result() for s in streams]
        assert e.stats()["prefill_chunks"] > len(MIX)   # chunking ran
    for (s, n, k), toks in zip(MIX, got):
        assert toks == _jax_dense(jm, _prompt(s, n), k, quant)
    assert len(set(got[0])) > 3


def test_matches_one_jax_engine_run(models, tmp_path, monkeypatch):
    """One JAX engine, one decode bucket; with 8-token chunks only the
    8-token prefill bucket is ever compiled (into a private cache)."""
    jm, tm = models
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    je = JDecodeEngine(jm, max_length=48, block_size=8, decode_buckets=(4,),
                       prefill_buckets=(8, 32), prefill_chunk=8,
                       default_timeout=120.0)
    try:
        js = [je.submit(_prompt(s, n), k) for s, n, k in MIX]
        ref = [s.result() for s in js]
    finally:
        je.shutdown()
    with _engine(tm) as e:
        got = [e.submit(_prompt(s, n), k) for s, n, k in MIX]
        assert [s.result() for s in got] == ref


# ---------------------------------------------------------------------------
# port semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
def test_solo_vs_batched_tokens_identical(models, quant):
    """The determinism contract: in f32 on the CPU a sequence's tokens do
    not depend on its batchmates or the bucket it ran in."""
    tm = models[1]
    with _engine(tm, quant=quant) as e:
        solo = [e.generate(_prompt(s, n), k) for s, n, k in MIX]
        batched = [e.submit(_prompt(s, n), k) for s, n, k in MIX]
        assert [s.result() for s in batched] == solo


def test_late_arrival_joins_running_batch(eng):
    base = eng.stats()
    long_ref = eng.generate(_prompt(1), 30)
    late_ref = eng.generate(_prompt(4), 4)
    long_s = eng.submit(_prompt(1), 30)
    next(iter(long_s))                       # it is running
    late_s = eng.submit(_prompt(4), 4)
    assert late_s.result() == late_ref
    assert not long_s.done(), "late arrival must not wait for a drain"
    assert long_s.result() == long_ref
    st = eng.stats()
    assert st["occupancy"] > 0 and st["blocks"]["allocated"] == 0
    assert st["completed"] - base["completed"] == 4
    assert st["ttft"]["count"] >= 4 and st["ttft"]["p50_s"] > 0


def test_streaming_and_logits_kept(eng):
    s = eng.submit(_prompt(5), 8, keep_logits=2)
    first = next(iter(s))
    rest = s.result()
    assert rest[0] == first and len(rest) == 8 and s.tokens == rest
    assert len(s.logits) == 2
    assert [int(l.argmax()) for l in s.logits] == rest[:2]
    assert s.ttft is not None and s.ttft > 0


def test_cancel_spares_batchmate(eng):
    base = eng.stats()["cancelled"]
    mate_ref = eng.generate(_prompt(8), 12)
    victim = eng.submit(_prompt(7), 40)
    mate = eng.submit(_prompt(8), 12)
    next(iter(victim))
    victim.cancel()
    with pytest.raises(PoolClosed):
        victim.result()
    assert victim.status == "cancelled"
    assert mate.result() == mate_ref
    st = eng.stats()
    assert st["cancelled"] - base == 1
    deadline = time.monotonic() + 5.0
    while eng.stats()["blocks"]["allocated"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.stats()["blocks"]["allocated"] == 0


def test_deadline_typed_and_blocks_freed(eng):
    base = eng.stats()["timed_out"]
    s = eng.submit(_prompt(6), 40, timeout=0.005)
    with pytest.raises(DeadlineExceeded):
        for _ in s:
            pass
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["timed_out"] - base == 1 and st["blocks"]["allocated"] == 0:
            break
        time.sleep(0.01)
    st = eng.stats()
    assert st["timed_out"] - base == 1 and st["blocks"]["allocated"] == 0


def test_overload_closed_and_drain(models):
    e = _engine(models[1], max_waiting=1, decode_buckets=(1,),
                default_timeout=None)
    running = e.submit(_prompt(9), 30)
    next(iter(running))
    e.submit(_prompt(10), 30)                 # fills the waiting queue
    with pytest.raises(Overloaded):
        e.submit(_prompt(11), 4)
    with pytest.raises(DeadlineExceeded):
        e.submit(_prompt(11), 4, timeout=-1.0)
    assert e.shutdown(drain_timeout=30.0)
    st = e.stats()
    assert st["blocks"]["allocated"] == 0
    assert st["admitted"] == st["completed"] + st["failed"] \
        + st["timed_out"] + st["cancelled"]
    with pytest.raises(PoolClosed):
        e.submit(_prompt(11), 4)


def test_submit_validation(eng):
    for bad in (np.zeros((3, 3), np.int32), np.array([0.5, 1.5]),
                np.zeros(0, np.int32), np.array([200], np.int32)):
        with pytest.raises(ValueError):
            eng.submit(bad, 4)
    with pytest.raises(ValueError):
        eng.submit(_prompt(1), 47)           # beyond max_length


@pytest.mark.parametrize("kw", [
    {"prefix_cache": True}, {"speculate_k": 2, "draft_model": object()},
    {"adapters": object()}, {"mesh": object()}, {"fault_hook": print},
    {"compile_cache": object()}])
def test_unported_engine_options_raise(models, kw):
    with pytest.raises(NotImplementedError):
        _engine(models[1], **kw)


@pytest.mark.parametrize("kw", [{"sampling": {"temperature": 0.7}},
                                {"adapter": "tenant-a"},
                                {"resume_committed": [1, 2]}])
def test_unported_submit_options_raise(eng, kw):
    with pytest.raises(NotImplementedError):
        eng.submit(_prompt(1), 4, **kw)
