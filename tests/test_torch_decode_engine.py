"""Port parity and semantics of the paged decode engine
(`paddle_tpu_torch.inference.decode`): the block-pool allocator laws,
engine tokens against the JAX dense `generate()` and one JAX
`DecodeEngine` run (float32 and int8 KV), the port's determinism contract
(a sequence's tokens are the same alone and in a batch), iteration-level
scheduling, typed deadline / cancel / overload / shutdown semantics, and
the engine options (the unported ones raising). Runs on the CPU in
float32. The prefix cache is on by default, so a quiesced engine holds
exactly the blocks its cache pins."""
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
from paddle_tpu_torch.inference import (AdapterNotLoaded, DeadlineExceeded,
                                        DecodeEngine, Overloaded, PoolClosed)
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


def _quiesced(st):
    """Blocks held beyond the prefix cache's pins (0 when nothing leaks)."""
    return st["blocks"]["allocated"] - st["prefix_cache"]["physical_blocks"]


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
    return BlockKVCache(num_blocks, block_size, [spec], device="cpu")


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
    assert st["occupancy"] > 0 and _quiesced(st) == 0
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
    while _quiesced(eng.stats()) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _quiesced(eng.stats()) == 0


def test_deadline_typed_and_blocks_freed(eng):
    base = eng.stats()["timed_out"]
    s = eng.submit(_prompt(6), 40, timeout=0.005)
    with pytest.raises(DeadlineExceeded):
        for _ in s:
            pass
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["timed_out"] - base == 1 and _quiesced(st) == 0:
            break
        time.sleep(0.01)
    st = eng.stats()
    assert st["timed_out"] - base == 1 and _quiesced(st) == 0


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


# options: the ported ones take their typed behaviour (a prefix-cache
# engine runs, a non-pool `adapters` and a draft that is no paged causal
# LM are refused, `adapter=` without a pool is `AdapterNotLoaded`, a
# `sampling` dict is the wire form); the rest still raise
# NotImplementedError
_ENGINE_OPTIONS = [
    ({"prefix_cache": True}, None),
    ({"speculate_k": 2, "draft_model": object()}, ValueError),
    ({"adapters": object()}, ValueError),
    ({"mesh": object()}, NotImplementedError),
    ({"fault_hook": print}, NotImplementedError),
    ({"compile_cache": object()}, NotImplementedError)]


@pytest.mark.parametrize("kw,error", _ENGINE_OPTIONS,
                         ids=[f"kw{i}" for i in range(len(_ENGINE_OPTIONS))])
def test_unported_engine_options_raise(models, kw, error):
    if error is None:
        with _engine(models[1], **kw) as e:
            assert len(e.generate(_prompt(1), 3)) == 3
            assert e.stats()["prefix_cache"]["enabled"]
        return
    with pytest.raises(error):
        _engine(models[1], **kw)


_SUBMIT_OPTIONS = [({"sampling": {"temperature": 0.7}}, None),
                   ({"adapter": "tenant-a"}, AdapterNotLoaded),
                   ({"resume_committed": [1, 2]}, NotImplementedError)]


@pytest.mark.parametrize("kw,error", _SUBMIT_OPTIONS,
                         ids=[f"kw{i}" for i in range(len(_SUBMIT_OPTIONS))])
def test_unported_submit_options_raise(eng, kw, error):
    if error is None:
        assert len(eng.submit(_prompt(1), 4, **kw).result()) == 4
        return
    with pytest.raises(error):
        eng.submit(_prompt(1), 4, **kw)


# ---------------------------------------------------------------------------
# step programs (static buffers; CUDA graphs on the GPU)
# ---------------------------------------------------------------------------

def _fill_pool(e, seed):
    g = torch.Generator().manual_seed(seed)
    for layer in e.pool.tensors:
        for t in layer:
            t.copy_(torch.randn(t.shape, generator=g))


def _step_inputs(e, n, bucket, seed, sampled):
    """n real rows of a decode step (pad rows after them): distinct blocks,
    ragged positions, slots 0-3; sampled rows alternate greedy, sampled,
    sampled with a repetition penalty over a short history."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        pos = int(rng.randint(0, e._nb * e.block_size - 1))
        nblk = pos // e.block_size + 1
        row = {"token": int(rng.randint(0, TINY["vocab_size"])),
               "pos": pos, "blocks": [1 + i * e._nb + j
                                      for j in range(nblk)],
               "slot": i % 4, "pack": dict(e._PACK_DEFAULTS), "hist": []}
        if sampled and i % 3:
            row["pack"].update(greedy=0, seed=100 + i, ctr=5 + i, temp=0.8,
                               top_k=20, top_p=0.9)
            if i % 3 == 2:
                row["pack"]["rep"] = 1.3
                row["hist"] = list(rng.randint(0, TINY["vocab_size"], 6))
        rows.append(row)
    return rows


def _program_step(e, prog, rows):
    a = prog.stage()
    for i, r in enumerate(rows):
        a["tokens"][i, 0] = r["token"]
        a["pos"][i] = r["pos"]
        a["tables"][i, :len(r["blocks"])] = r["blocks"]
        a["aids"][i] = r["slot"]
        if "hist" in a:
            for name, v in r["pack"].items():
                a[name][i] = v
            a["hist"][i, :len(r["hist"])] = r["hist"]
    out = prog.run()
    return out["logits"][:len(rows)].clone(), prog.fetch("next", len(rows))


def _eager_step(e, rows, bucket, sampled):
    """The decode step as the engine ran it before its step programs: the
    batch's tensors formed outside the model call, the real rows sampled
    (the history only where a row penalises)."""
    from paddle_tpu_torch.inference.sampling import PACK_FIELDS, sample_token
    from paddle_tpu_torch.models.gpt import PagedBatch

    tokens = np.zeros((bucket, 1), np.int64)
    positions = np.zeros(bucket, np.int32)
    tables = np.zeros((bucket, e._nb), np.int32)
    aids = np.zeros(bucket, np.int32)
    for i, r in enumerate(rows):
        tokens[i, 0], positions[i], aids[i] = r["token"], r["pos"], r["slot"]
        tables[i, :len(r["blocks"])] = r["blocks"]
    batch = PagedBatch.decode(torch.from_numpy(tables),
                              torch.from_numpy(positions), e.block_size)
    with e._adapter_scope(aids):
        logits = e.model.decode_step_paged(torch.from_numpy(tokens),
                                           e.pool.tensors, batch)
    out = logits[:len(rows), -1].to(torch.float32)
    if not sampled:
        return out, out.argmax(-1).tolist()
    pack = {name: torch.tensor([r["pack"][name] for r in rows], dtype=dt)
            for name, dt in PACK_FIELDS}
    hist = None
    if any(r["pack"]["rep"] != 1.0 for r in rows):
        h = np.full((len(rows), e.max_length), -1, np.int64)
        for i, r in enumerate(rows):
            h[i, :len(r["hist"])] = r["hist"]
        hist = torch.from_numpy(h)
    return out, sample_token(out, pack, hist).tolist()


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
@pytest.mark.parametrize("adapters", [False, True])
def test_step_program_equals_the_eager_step(models, kind, adapters):
    """The static-buffer step program gives the eager step's logits bit
    for bit and its tokens at every bucket, with pad rows, adapters (slot
    0 rows included) and sampled rows with and without a penalty."""
    from paddle_tpu_torch.inference import AdapterPool

    tm = models[1]
    pool = None
    if adapters:
        pool = AdapterPool(tm, rank=4, slots=4, device="cpu")
        g = torch.Generator().manual_seed(2)
        for name in ("a", "b", "c"):
            pool.load(name, {k: (torch.randn(i, 4, generator=g) * 0.3,
                                 torch.randn(4, o, generator=g) * 0.3)
                             for k, (i, o) in pool.layers.items()})
    try:
        with _engine(tm, adapters=pool, num_blocks=1 + 4 * 7) as e:
            _fill_pool(e, 1)
            for b in e.decode_buckets:
                prog = e._program(kind, b)
                for n in sorted({max(1, b - 1), b}):
                    rows = _step_inputs(e, n, b, 10 * b + n,
                                        kind == "sampled")
                    logits, toks = _program_step(e, prog, rows)
                    ref, ref_toks = _eager_step(e, rows, b,
                                                kind == "sampled")
                    assert torch.equal(logits, ref), (b, n)
                    assert toks == ref_toks, (b, n)
    finally:
        if pool is not None:
            pool.detach()


def test_warmup_builds_every_program_and_traffic_builds_none(models):
    """`warmup()` returns the buckets (the reference's shape) and builds
    a greedy and a sampled program per decode bucket, eager on the CPU;
    traffic of every kind and bucket builds no other, and the decode
    programs' runs add up to the engine's steps."""
    from paddle_tpu_torch.inference import SamplingParams

    with _engine(models[1]) as e:
        assert e.stats()["compiles"] == {"built": 0, "disk": 0}
        assert e.warmup() == {"decode": [1, 2, 4],
                              "prefill": [8, 16, 32]}
        built = e.stats()["compiles"]
        assert built == {"built": 6, "disk": 0}
        streams = [e.submit(_prompt(s, n), k, sampling=SamplingParams(
            temperature=0.9, seed=s) if s % 2 else None)
            for s, n, k in MIX + ((4, 9, 5), (5, 3, 6))]
        for s in streams:
            s.result()
        e.generate(_prompt(6), 4)
        st = e.stats()
        assert st["compiles"] == built
        progs = st["step_programs"]
        assert set(progs) == {f"{k}-b{b}" for k in ("greedy", "sampled")
                              for b in (1, 2, 4)}
        assert not any(p["graph"] for p in progs.values())
        assert sum(p["replays"] for p in progs.values()) == st["steps"]
    with pytest.raises(PoolClosed):
        e.warmup()
