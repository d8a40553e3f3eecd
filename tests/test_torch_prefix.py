"""Port parity and semantics of the decode engine's prefix cache with
copy-on-write sharing (`paddle_tpu_torch.inference.decode.engine`):
a sharing engine gives the same tokens as a private-copy engine
(`prefix_cache=False`) and as one JAX engine with `prefix_cache=True`,
in float32 and with int8 KV; chunk-boundary matching, full-prompt hits,
copy-on-write of a shared mid-block tail, the LRU block cap, eviction
under admission pressure, and block conservation (a quiesced engine
holds exactly the blocks its cache pins; a shut-down one holds none).
Runs on the CPU in float32."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import DecodeEngine, SamplingParams
from paddle_tpu_torch.models import gpt

TINY = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)
SYSTEM = np.random.RandomState(100).randint(0, 97, (16,)).astype(np.int32)
TAILS = (3, 9, 14, 5)          # prompt lengths 19, 25, 30, 21: mid-block


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


def _prompts():
    """A shared 16-token system prefix (two 8-token chunks) with unique
    tails, then an exact resubmission of the first (a full hit)."""
    out = [np.concatenate([SYSTEM, np.random.RandomState(t).randint(
        0, 97, (t,)).astype(np.int32)]) for t in TAILS]
    return out + [out[0].copy()]


def _run(e, prompts, new=6):
    """The first prompt alone (it publishes), then the rest together."""
    first = e.generate(prompts[0], new)
    streams = [e.submit(p, new) for p in prompts[1:]]
    return [first] + [s.result() for s in streams]


def _leak(st):
    return st["blocks"]["allocated"] - st["prefix_cache"]["physical_blocks"]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sharing_equals_private_and_conserves_blocks(models, quant):
    tm = models[1]
    prompts = _prompts()
    with _engine(tm, quant=quant, prefix_cache=False) as e:
        ref = _run(e, prompts)
        assert e.stats()["prefix_cache"]["hits"] == 0
    e = _engine(tm, quant=quant)
    got = _run(e, prompts)
    st = e.stats()
    assert got == ref
    pc = st["prefix_cache"]
    assert pc["hits"] >= len(prompts) - 1 and pc["full_hits"] >= 1
    assert pc["tokens_reused"] >= 16 * (len(prompts) - 1)
    # every prompt ends mid-block: its publisher (and the full hit) copy
    # the shared tail before their first private write
    assert st["cow_copies"] >= 2
    assert 0 < st["prefix_hit_rate"] <= 1
    assert _leak(st) == 0 and pc["physical_blocks"] > 0
    assert e.shutdown()
    b = e.stats()["blocks"]
    assert b["allocated"] == 0 and b["allocs"] == b["frees"]
    assert b["increfs"] + b["allocs"] == b["decrefs"]


def test_chunk_boundary_match_skips_shared_chunks(models):
    tm = models[1]
    prompts = _prompts()
    with _engine(tm) as e:
        e.generate(prompts[0], 4)                 # publishes 8, 16, full
        before = e.stats()
        e.generate(prompts[1], 4)                 # shares 16 tokens
        st = e.stats()
    assert st["prefix_cache"]["hits"] - before["prefix_cache"]["hits"] == 1
    assert st["prefix_cache"]["tokens_reused"] \
        - before["prefix_cache"]["tokens_reused"] == 16
    # 25 tokens: only [16, 25) is prefilled, as two chunks (8 + 1)
    assert st["prefill_chunks"] - before["prefill_chunks"] == 2


def test_full_hit_delivers_publishers_token_without_prefill(models):
    tm = models[1]
    p = _prompts()[2]
    with _engine(tm) as e:
        ref = e.generate(p, 8)
        before = e.stats()
        assert e.generate(p, 8) == ref
        st = e.stats()
    assert st["prefix_cache"]["full_hits"] \
        - before["prefix_cache"]["full_hits"] == 1
    assert st["prefill_chunks"] == before["prefill_chunks"]
    assert st["cow_copies"] > before["cow_copies"]


def test_sampled_and_logit_keeping_requests_skip_full_hits(models):
    """A full hit delivers the publisher's next token: a sampled request
    (and one that keeps logits) recomputes the last chunk instead, and a
    sampled request publishes no full-prompt entry."""
    tm = models[1]
    p = _prompts()[1]
    sp = SamplingParams(temperature=0.9, seed=3)
    with _engine(tm) as e:
        e.generate(p, 4)
        base = e.stats()["prefix_cache"]
        e.generate(p, 4, sampling=sp)
        s = e.submit(p, 4, keep_logits=1)
        s.result()
        assert len(s.logits) == 1
        pc = e.stats()["prefix_cache"]
        assert pc["full_hits"] == base["full_hits"]
        assert pc["hits"] - base["hits"] == 2          # chunk hits at 24
        entries = pc["entries"]
        e.generate(_prompts()[3], 4, sampling=sp)
        # its chunk boundaries (8, 16) already exist; no full entry
        assert e.stats()["prefix_cache"]["entries"] == entries


def test_block_aligned_prompt_needs_no_copy(models):
    tm = models[1]
    with _engine(tm) as e:
        e.generate(SYSTEM, 5)                     # 16 tokens: aligned
        st = e.stats()
    assert st["cow_copies"] == 0
    assert st["prefix_cache"]["entries"] == 2     # chunk entries 8, 16


def test_lru_block_cap(models):
    tm = models[1]
    rng = np.random.RandomState(5)
    with _engine(tm, prefix_cache_blocks=4) as e:
        for _ in range(4):
            e.generate(rng.randint(0, 97, (19,)).astype(np.int32), 3)
        st = e.stats()
    pc = st["prefix_cache"]
    assert pc["physical_blocks"] <= 4 and pc["evictions"] > 0
    assert pc["block_cap"] == 4


def test_eviction_under_admission_pressure(models):
    """A pool too small for the cache's pins plus a new worst case evicts
    LRU entries at admission; the requests still run and match a private
    engine."""
    tm = models[1]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 97, (30,)).astype(np.int32) for _ in range(3)]
    with _engine(tm, prefix_cache=False) as e:
        ref = [e.generate(p, 8) for p in prompts]
    with _engine(tm, num_blocks=12, decode_buckets=(1,),
                 prefix_cache_blocks=10) as e:
        got = [e.generate(p, 8) for p in prompts]
        st = e.stats()
    assert got == ref
    assert st["prefix_cache"]["evictions"] > 0
    assert _leak(st) == 0


def test_matches_one_jax_engine_with_prefix_cache(models, tmp_path,
                                                  monkeypatch):
    """One JAX engine (prefix cache on, 8-token chunks: only the 8-token
    prefill bucket compiles, into a private cache) on the same requests."""
    jm, tm = models
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    prompts = _prompts()
    je = JDecodeEngine(jm, max_length=48, block_size=8, decode_buckets=(4,),
                       prefill_buckets=(8, 32), prefill_chunk=8,
                       prefix_cache=True, default_timeout=120.0)
    try:
        ref = _run(je, prompts)
        jpc = je.stats()["prefix_cache"]
    finally:
        je.shutdown()
    with _engine(tm) as e:
        assert _run(e, prompts) == ref
        pc = e.stats()["prefix_cache"]
    assert jpc["hits"] >= 1 and pc["hits"] == jpc["hits"]
    assert pc["full_hits"] == jpc["full_hits"]
