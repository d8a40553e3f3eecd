"""Speculative decoding in the port's decode engine
(`paddle_tpu_torch.inference.decode`), held against the JAX package on the
CPU in float32: a draft model proposes K tokens a round (the propose
program), the target scores the K + 1 positions (the verify program: K + 1
runs of the plain decode step's body), greedy acceptance commits the
longest agreeing prefix plus the target's own token.

The bar is the reference's: speculative tokens equal plain greedy decoding
(`speculate_k=0`, and JAX's dense `generate()`), for a self-draft (every
proposal accepted), a perturbed draft (rejections and corrections), int8
KV, prefix sharing, EOS inside a round and the plain fallbacks; a JAX
`DecodeEngine` with the same draft and K commits the same tokens with the
same acceptance counters. Plus: both block pools conserved, admission
reserving draft blocks, no step program built after `warmup()`, and the
constructor's refusals."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import DecodeEngine as JDecodeEngine
from paddle_tpu.models import GenerationConfig
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import DecodeEngine
from paddle_tpu_torch.models import gpt

TINY = dict(vocab_size=97, hidden_size=48, num_heads=4, num_kv_heads=2,
            num_layers=2, rope=True, swiglu=True, rms_norm=True,
            max_position_embeddings=64, tie_word_embeddings=False)
#: the reference test file's geometry (tests/test_decode_spec.py)
GEO = dict(max_length=48, block_size=8, decode_buckets=(1, 2),
           prefill_buckets=(8,), default_timeout=60.0)
K = 3
#: speculative counters compared with the JAX engine's
COUNTERS = ("proposed", "accepted", "rejected", "bonus", "committed",
            "rounds")


def _port(jm):
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return tm


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX draft, port draft): the draft is the
    target with small noise on its last block's MLP, as in the reference
    tests, so it agrees often but not always."""
    paddle.seed(7)
    jm = jgpt("gpt_tiny", **TINY)
    jm.eval()
    paddle.seed(7)
    jd = jgpt("gpt_tiny", **TINY)
    jd.eval()
    rng = np.random.RandomState(11)
    perturbed = 0
    for name, p in jd.named_parameters():
        if "layers.1.mlp" in name:
            p._value = p._value + np.asarray(
                rng.normal(0, 2e-2, p.shape), p._value.dtype)
            perturbed += 1
    assert perturbed
    return jm, _port(jm), jd, _port(jd)


def _engine(model, **kw):
    return DecodeEngine(model, device="cpu", **{**GEO, **kw})


@pytest.fixture(scope="module")
def plain(models):
    e = _engine(models[1])
    yield e
    e.shutdown(drain_timeout=10.0)


@pytest.fixture(scope="module")
def spec(models):
    e = _engine(models[1], draft_model=models[3], speculate_k=K)
    e.warmup()
    yield e
    e.shutdown(drain_timeout=10.0)


def _prompt(seed, n=6):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (n,)).astype(np.int32)


def _jax_greedy(jm, prompt, new):
    out = jgenerate(jm, prompt[None], GenerationConfig(
        max_new_tokens=new)).numpy()
    return list(np.asarray(out)[0, len(prompt):])


def _quiesced(st):
    """Nothing held beyond the prefix cache's pins, on both pools."""
    leak = st["blocks"]["allocated"] - st["prefix_cache"]["physical_blocks"]
    if st["speculative"]["enabled"]:
        leak += st["draft_blocks"]["allocated"]
    return leak == 0


def _no_fallback(st):
    """Every round ran its propose and verify programs: no round fell back
    to plain isolated steps (their tokens would be plain greedy's too, so
    the token checks alone cannot see a failing program)."""
    sp = st["speculative"]
    return sp["fallbacks"] == 0 and st["isolation_rounds"] == 0 \
        and sp["rounds"] == sp["verify_dispatches"] > 0


# ---------------------------------------------------------------------------
# tokens against the JAX package and the plain engine
# ---------------------------------------------------------------------------

CASES = ((1, 12), (2, 6), (15, 38))


def test_self_draft_accepts_everything_and_equals_jax_greedy(models,
                                                             plain):
    """Draft == target: every proposal is accepted, rounds commit K + 1
    tokens (bonus rounds), and the tokens are JAX's greedy `generate()`
    and the plain engine's."""
    jm, tm = models[:2]
    with _engine(tm, draft_model=tm, speculate_k=K) as e:
        e.warmup()
        for seed, n in CASES:
            got = e.generate(_prompt(seed), n)
            assert got == plain.generate(_prompt(seed), n)
            assert got == _jax_greedy(jm, _prompt(seed), n)
        sp = e.stats()["speculative"]
        assert sp["enabled"] and sp["k"] == K
        assert sp["proposed"] > 0 and sp["rejected"] == 0
        assert sp["acceptance_rate"] == 1.0 and sp["bonus"] >= 1
        assert sp["accepted_per_dispatch"] > 1.0
        assert _quiesced(e.stats()) and _no_fallback(e.stats())


def test_perturbed_draft_equals_jax_greedy(models, spec, plain):
    """Rejected proposals roll back and the target's correction is
    committed: still JAX's greedy tokens and the plain engine's."""
    jm = models[0]
    for seed, n in ((3, 14), (4, 8), (5, 11)):
        got = spec.generate(_prompt(seed), n)
        assert got == plain.generate(_prompt(seed), n)
        assert got == _jax_greedy(jm, _prompt(seed), n)
    sp = spec.stats()["speculative"]
    assert sp["accepted"] > 0 and sp["rejected"] > 0
    assert 0.0 < sp["acceptance_rate"] < 1.0
    assert _no_fallback(spec.stats())


def test_counters_equal_the_jax_engines(models, tmp_path, monkeypatch):
    """A JAX `DecodeEngine` with the same draft and K, fed the same
    requests one at a time, commits the same tokens with the same
    proposed / accepted / rejected / bonus / committed counts and rounds."""
    jm, tm, jd, td = models
    reqs = ((3, 14), (4, 8), (15, 38), (9, 2))
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    je = JDecodeEngine(jm, **GEO, draft_model=jd, speculate_k=K)
    try:
        ref = [je.generate(_prompt(s), n) for s, n in reqs]
        jsp = je.stats()["speculative"]
    finally:
        je.shutdown()
    with _engine(tm, draft_model=td, speculate_k=K) as e:
        got = [e.generate(_prompt(s), n) for s, n in reqs]
        st = e.stats()
        sp = st["speculative"]
    assert got == ref and _no_fallback(st)
    assert {k: sp[k] for k in COUNTERS} == {k: jsp[k] for k in COUNTERS}
    assert sp["rejected"] > 0


def test_batched_speculation_equals_plain(spec, plain):
    """Sequences share propose and verify programs (bucketed): each keeps
    its solo tokens."""
    seeds = ((6, 10), (7, 7), (8, 12))
    refs = [plain.generate(_prompt(s), n) for s, n in seeds]
    streams = [spec.submit(_prompt(s), n) for s, n in seeds]
    assert [s.result() for s in streams] == refs
    assert _quiesced(spec.stats()) and _no_fallback(spec.stats())


def test_eos_mid_round_stops_like_plain(models, plain):
    """An EOS inside a round's commit stops delivery where plain greedy
    stops: nothing after it leaks out of the round."""
    tm, td = models[1], models[3]
    p = _prompt(9)
    eos = plain.generate(p, 16)[4]
    with _engine(tm, eos_token_id=eos) as pe:
        ref = pe.generate(p, 16)
    with _engine(tm, eos_token_id=eos, draft_model=td,
                 speculate_k=K) as e:
        e.warmup()
        got = e.generate(p, 16)
        assert got == ref and got[-1] == eos and len(got) < 16
        assert _quiesced(e.stats())


def test_int8_kv_speculation_equals_jax_greedy(models):
    """Both pools take the int8 layout (the draft's shares the engine's
    quant mode); the tokens are JAX's int8-cache greedy `generate()`."""
    jm, tm, _, td = models
    with _engine(tm, quant="int8", decode_buckets=(2,), prefix_cache=False,
                 draft_model=td, speculate_k=K) as e:
        e.warmup()
        assert e.pool.quant == "int8" and e.draft_pool.quant == "int8"
        jm.cache_quant = "int8"
        try:
            for seed, n in ((10, 9), (11, 12)):
                assert e.generate(_prompt(seed), n) \
                    == _jax_greedy(jm, _prompt(seed), n)
        finally:
            jm.cache_quant = None
        assert _quiesced(e.stats())


def test_speculation_composes_with_prefix_sharing(spec, plain):
    """Full-prompt hits skip the target's prefill, so their draft catches
    up over the committed tokens alone; the shared mid-block tail is
    copied before the first speculative write; tokens stay plain's."""
    p = _prompt(12, 6)             # 6 % 8: the tail ends mid-block
    ref = plain.generate(p, 10)
    base = spec.stats()
    assert spec.generate(p, 10) == ref            # publisher
    a, b = spec.submit(p, 10), spec.submit(p, 10)  # full hits
    assert a.result() == ref and b.result() == ref
    st = spec.stats()
    assert st["prefix_cache"]["full_hits"] \
        - base["prefix_cache"]["full_hits"] == 2
    assert st["cow_copies"] - base["cow_copies"] >= 3
    assert st["speculative"]["catchup_chunks"] \
        - base["speculative"]["catchup_chunks"] >= 3
    assert _quiesced(st)


def test_max_length_and_short_tail_take_plain_steps(models, plain):
    """Near max_length the verify rows no longer fit the table (plain
    steps), and a 1-token remainder is one plain step, never a round."""
    tm, td = models[1], models[3]
    p = _prompt(13, 8)
    n = GEO["max_length"] - len(p)
    with _engine(tm, draft_model=td, speculate_k=K) as e:
        e.warmup()
        assert e.generate(p, n) == plain.generate(p, n)
        before = e.stats()["speculative"]["rounds"]
        assert e.generate(_prompt(14), 2) == plain.generate(_prompt(14), 2)
        st = e.stats()
        assert st["steps"] >= 1
        assert st["speculative"]["rounds"] == before
        assert _quiesced(st)


def test_draft_prefill_rides_the_target_chunks(models):
    """With chunked prefill the draft prefills each of the target's chunks
    beside it (a 17-token prompt: chunks of 8, 8 and 1), so the first
    round needs no catch-up; a full hit, which skips the target's
    prefill, catches the draft up in one chunk."""
    tm, td = models[1], models[3]
    geo = dict(prefill_buckets=(8, 16, 32), prefill_chunk=8)
    p = _prompt(21, 17)
    with _engine(tm, **geo) as pe:
        ref = pe.generate(p, 12)
    with _engine(tm, **geo, draft_model=td, speculate_k=K) as e:
        assert e.generate(p, 12) == ref
        sp = e.stats()["speculative"]
        assert sp["catchup_chunks"] == 3 and sp["rounds"] > 0
        assert e.generate(p, 12) == ref          # a full hit
        st = e.stats()
        assert st["prefix_cache"]["full_hits"] == 1
        assert st["speculative"]["catchup_chunks"] == 4
        assert _quiesced(st)


# ---------------------------------------------------------------------------
# programs, reservation, stats, refusals
# ---------------------------------------------------------------------------

def test_no_program_built_after_warmup(spec):
    """After `warmup()` traffic at every bucket builds no step program:
    greedy, sampled, propose and verify of each bucket are built."""
    before = dict(spec.stats()["compiles"])
    assert before == {"built": 4 * len(GEO["decode_buckets"]), "disk": 0}
    streams = [spec.submit(_prompt(20 + i), 5) for i in range(3)]
    for s in streams:
        s.result()
    spec.generate(_prompt(24), 5)
    assert spec.stats()["compiles"] == before
    progs = spec.stats()["step_programs"]
    assert set(progs) == {f"{k}-b{b}" for k in ("greedy", "sampled",
                                                 "propose", "verify")
                          for b in GEO["decode_buckets"]}
    assert not any(p["graph"] for p in progs.values())


def test_infeasible_draft_worst_case_refused(models):
    """A request whose draft worst case can never fit the draft pool is
    refused synchronously."""
    tm, td = models[1], models[3]
    with _engine(tm, prefix_cache=False, draft_model=td, speculate_k=K,
                 draft_num_blocks=1 + 4) as e:
        with pytest.raises(ValueError, match="draft"):
            e.submit(_prompt(30, 8), 40)


def test_draft_reservation_gates_admission(models, plain):
    """A tight draft pool serializes admission instead of failing a
    round: two sequences of 3 worst-case draft blocks each on 4 blocks."""
    tm, td = models[1], models[3]
    with _engine(tm, decode_buckets=(2,), prefix_cache=False,
                 draft_model=td, speculate_k=K,
                 draft_num_blocks=1 + 4) as e:
        a = e.submit(_prompt(31, 8), 9)
        b = e.submit(_prompt(32, 8), 9)
        assert a.result() == plain.generate(_prompt(31, 8), 9)
        assert b.result() == plain.generate(_prompt(32, 8), 9)
        st = e.stats()
        assert st["failed"] == 0 and st["peak_resident"] == 1
        assert st["draft_blocks"]["failed_allocs"] == 0
        assert _quiesced(st)


def test_speculative_stats_and_conservation(spec):
    spec.generate(_prompt(40), 8)
    st = spec.stats()
    sp = st["speculative"]
    assert sp["proposed"] == sp["accepted"] + sp["rejected"]
    assert 0 < sp["committed"] <= sp["proposed"] + sp["proposed"] // K
    assert sp["verify_dispatches"] == sum(
        p["replays"] for n, p in st["step_programs"].items()
        if n.startswith("verify"))
    for key, name in (("blocks", "target"), ("draft_blocks", "draft")):
        bs = st[key]
        assert bs["name"] == name
        assert bs["allocated"] + bs["free"] + bs["reserved"] == bs["total"]
    assert st["admitted"] == st["completed"] + st["failed"] \
        + st["timed_out"] + st["cancelled"]


def test_speculate_k_zero_or_no_draft_is_plain(models):
    tm, td = models[1], models[3]
    for kw in ({"draft_model": td, "speculate_k": 0}, {"speculate_k": 3}):
        with _engine(tm, **kw) as e:
            assert e.draft_pool is None and e.draft_model is None
            assert e.warmup() == {"decode": [1, 2], "prefill": [8]}
            assert e.generate(_prompt(41), 6)
            st = e.stats()
            assert not st["speculative"]["enabled"]
            assert st["speculative"]["rounds"] == 0
            assert "draft_blocks" not in st
            assert st["compiles"]["built"] == 2 * 2
    with pytest.raises(ValueError):
        _engine(tm, draft_model=td, speculate_k=-1)


def test_catchup_after_a_fallback(models, plain, monkeypatch):
    """A failed verify falls back to plain isolated steps from the
    committed state; the draft's position stays at the last commit (in
    general mid-block), and the next round's catch-up starts there. With
    the draft == target, acceptance after recovery stays high (corrupted
    draft rows would collapse it)."""
    tm = models[1]
    e = _engine(tm, draft_model=tm, speculate_k=K)
    verify = e._dispatch_verify
    state = {"failed": 0}

    def flaky(seqs, props):
        if state["failed"] == 0:
            state["failed"] += 1
            raise RuntimeError("injected verify fault")
        return verify(seqs, props)

    monkeypatch.setattr(e, "_dispatch_verify", flaky)
    with e:
        p = _prompt(50)
        got = e.generate(p, 14)
        sp = e.stats()["speculative"]
        assert state["failed"] == 1 and sp["fallbacks"] == 1
        assert sp["catchup_chunks"] >= 2
        assert sp["proposed"] > 0 and sp["acceptance_rate"] > 0.5
        assert _quiesced(e.stats())
    assert got == plain.generate(p, 14)


def test_draft_vocab_mismatch_refused(models):
    other = gpt("gpt_tiny", device="cpu", **{**TINY, "vocab_size": 101})
    with pytest.raises(ValueError, match="vocab"):
        _engine(models[1], draft_model=other, speculate_k=K)


def test_unchunkable_catchup_config_refused(models):
    """No block-aligned prefill bucket and a largest bucket short of
    max_length - 1: catch-up might have to chunk and could not."""
    tm, td = models[1], models[3]
    with pytest.raises(ValueError, match="catch-up"):
        _engine(tm, prefill_buckets=(12,), draft_model=td, speculate_k=K)
    _engine(tm, prefill_buckets=(12, 47), draft_model=td,
            speculate_k=K).shutdown()


def test_mesh_still_refused_with_speculation(models):
    """`mesh` stays unported: a self-draft with a mesh raises
    NotImplementedError before anything is built."""
    tm = models[1]
    with pytest.raises(NotImplementedError, match="mesh"):
        _engine(tm, draft_model=tm, speculate_k=K, mesh=object())
