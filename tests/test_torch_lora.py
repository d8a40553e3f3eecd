"""Port parity of training-side LoRA (`paddle_tpu_torch.nn.lora`) against
`paddle_tpu.nn.lora`, on a 2-layer LLaMA-style gpt_tiny (rope, SwiGLU,
vocab 128; f32, CPU) whose base weights and adapters carry across through
`convert`.

Tolerances (f32): logits 1e-5 relative to the largest |logit| (sums in
another order); merged against unmerged 1e-4 (the delta folded into the
weight rounds once more); three AdamW steps at lr 1e-2: the loss 1e-5
relative, the adapters 1e-4 absolute (each entry moves by up to lr a
step; the largest gap read 1e-5), the frozen base bit for bit; exported
adapters 1e-6.

The JAX engine updates every parameter, frozen or not (ROADMAP Queue 3);
the port's engine is held to the JAX eager loop, and one test shows the
JAX engine moving the frozen base."""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu.inference import AdapterPool as JAdapterPool
from paddle_tpu.models import generate as jgenerate
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import lora as jlora
from paddle_tpu.nn.layer.common import Linear as JLinear
from paddle_tpu.nn.quant import WeightOnlyLinear as JWeightOnlyLinear
from paddle_tpu.nn.quant import quantize_for_inference as jquantize

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import (_is_linear_weight, load_jax_state,
                                      state_to_jax)
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.inference import AdapterPool, DecodeEngine
from paddle_tpu_torch.models import generate, gpt
from paddle_tpu_torch.nn import lora as tlora
from paddle_tpu_torch.nn.quant import WeightOnlyLinear, quantize_for_inference
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(num_layers=2, rope=True, swiglu=True, vocab_size=128,
            max_position_embeddings=64)
TARGETS = ("qkv", "out")
LR, STEPS = 1e-2, 3


def _named(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _ids(seed, b=4, s=16):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int32)


def _pair(seed=0, lora=True, perturb=None, **cfg):
    """The JAX model (LoRA-wrapped when `lora`) and the port's with its
    state; `perturb` seeds random adapters (else A random, B = 0)."""
    paddle.seed(seed)
    jm = jgpt("gpt_tiny", **TINY)
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    if lora:
        kw = dict(r=4, target_modules=TARGETS, **cfg)
        jlora.apply_lora(jm, jlora.LoRAConfig(**kw))
        tlora.apply_lora(tm, tlora.LoRAConfig(**kw))
        if perturb is not None:
            rng = np.random.RandomState(perturb)
            for p in jlora.lora_parameters(jm):
                p.set_value(rng.randn(*p.shape).astype(np.float32) * 0.05)
    load_jax_state(tm, _named(jm))
    return jm, tm


def _jlogits(jm, ids):
    jm.eval()
    return np.asarray(jm(paddle.to_tensor(ids)).numpy())


@torch.no_grad()
def _tlogits(tm, ids):
    tm.eval()
    return tm(torch.from_numpy(ids).long()).numpy()


def _close(got, ref, rel):
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(autouse=True)
def _restore_global_mesh():
    prev = dist.get_hybrid_communicate_group()
    yield
    dist.set_hybrid_communicate_group(prev)


# ---------------------------------------------------------------------------
# the wrapper and its surface
# ---------------------------------------------------------------------------

def test_parameters_match_jax_names_shapes_and_frozen():
    jm, tm = _pair()
    jp = {n: p for n, p in jm.named_parameters()}
    tp = dict(tm.named_parameters())
    assert sorted(jp) == sorted(tp)
    for n, p in tp.items():
        shape = tuple(jp[n].shape)
        if _is_linear_weight(n, p.detach()):
            shape = shape[::-1]                  # [in, out] -> [out, in]
        assert tuple(p.shape) == shape, n
        assert p.requires_grad == (not jp[n].stop_gradient), n
    assert sorted(n for n, p in tp.items() if p.requires_grad) == sorted(
        n for n in tp if n.endswith(("lora_A", "lora_B")))
    assert len(tlora.lora_parameters(tm)) == 4 * TINY["num_layers"]
    assert tnn.lora is tlora
    wrapped = [n for n, m in tm.named_modules()
               if isinstance(m, tlora.LoRALinear)]
    assert wrapped == [n for n, m in jm.named_sublayers()
                       if isinstance(m, jlora.LoRALinear)]


def test_state_converts_both_ways():
    """base.weight transposed, lora_A / lora_B as they are."""
    jm, tm = _pair(perturb=3)
    named = _named(jm)
    back = state_to_jax(tm)
    assert sorted(back) == sorted(named)
    for n, a in named.items():
        np.testing.assert_array_equal(back[n], a)
    a = named["transformer.layers.0.attn.qkv_proj.lora_A"]
    np.testing.assert_array_equal(
        tm.transformer.layers[0].attn.qkv_proj.lora_A.detach().numpy(), a)
    w = named["transformer.layers.0.attn.qkv_proj.base.weight"]
    np.testing.assert_array_equal(
        tm.transformer.layers[0].attn.qkv_proj.base.weight.detach().numpy(),
        w.T)


def test_zero_init_is_identity_and_a_is_kaiming_uniform():
    paddle.seed(0)
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    ids = _ids(1, b=2, s=8)
    ref = _tlogits(tm, ids)
    tlora.apply_lora(tm, r=4)
    _close(_tlogits(tm, ids), ref, 1e-5)
    for m in tm.modules():
        if isinstance(m, tlora.LoRALinear):
            in_f = m.base.weight.shape[1]
            assert m.lora_A.dtype == torch.float32 and m.lora_A.shape == (
                in_f, 4)
            assert float(m.lora_A.detach().abs().max()) <= 1 / np.sqrt(
                in_f)
            assert not m.lora_B.any()
    # a seeded generator draws the same adapters again
    a = gpt("gpt_tiny", device="cpu", **TINY)
    b = gpt("gpt_tiny", device="cpu", **TINY)
    tlora.apply_lora(a, r=4, generator=torch.Generator().manual_seed(5))
    tlora.apply_lora(b, r=4, generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(tlora.lora_parameters(a), tlora.lora_parameters(b)):
        assert torch.equal(pa, pb)


def test_adapted_logits_equal_jax_and_merge_unmerge():
    jm, tm = _pair(perturb=2)
    ids = _ids(1, b=2, s=8)
    ref = _jlogits(jm, ids)
    unmerged = _tlogits(tm, ids)
    _close(unmerged, ref, 1e-5)
    base = _tlogits(_pair(lora=False)[1], ids)
    assert not np.allclose(unmerged, base, atol=1e-3)
    weights = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tlora.merge_lora(tm)
    assert all(m.merged for m in tm.modules()
               if isinstance(m, tlora.LoRALinear))
    _close(_tlogits(tm, ids), unmerged, 1e-4)
    jlora.merge_lora(jm)
    _close(_tlogits(tm, ids), _jlogits(jm, ids), 1e-5)
    for m in tm.modules():
        if isinstance(m, tlora.LoRALinear):
            m.unmerge()
    for n, p in tm.named_parameters():
        torch.testing.assert_close(p, weights[n], rtol=0, atol=1e-6)
    _close(_tlogits(tm, ids), unmerged, 1e-5)


def test_export_equals_jax_and_requires_adapters():
    jm, tm = _pair(perturb=4)
    ref = jlora.export_lora_weights(jm)
    got = tlora.export_lora_weights(tm)
    assert sorted(got) == sorted(ref)
    for n, (a, b) in got.items():
        assert a.dtype == np.float32 and b.dtype == np.float32
        np.testing.assert_allclose(a, ref[n][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(b, ref[n][1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="no LoRALinear"):
        tlora.export_lora_weights(gpt("gpt_tiny", device="cpu", **TINY))
    with pytest.raises(ValueError, match="no LoRALinear"):
        jlora.export_lora_weights(jgpt("gpt_tiny", **TINY))


def test_bf16_base_promotes_like_jax():
    """bf16 base and input, f32 adapters: the reference's output is f32
    (JAX promotes bf16 @ f32); the port's too, with the same values up to
    the base product's bf16 rounding."""
    rng = np.random.RandomState(0)
    w = rng.randn(16, 24).astype(np.float32) * 0.1     # [in, out]
    a = rng.randn(16, 4).astype(np.float32) * 0.1
    b = rng.randn(4, 24).astype(np.float32) * 0.1
    x = rng.randn(3, 16).astype(np.float32)
    jl = JLinear(16, 24, bias_attr=False)
    jl.weight.set_value(w)
    jl.weight._value = jl.weight._value.astype("bfloat16")
    jw = jlora.LoRALinear(jl, r=4, lora_alpha=8)
    jw.lora_A.set_value(a)
    jw.lora_B.set_value(b)
    jx = paddle.to_tensor(x).astype("bfloat16")
    ref = jw(jx)
    tl = torch.nn.Linear(16, 24, bias=False, dtype=torch.bfloat16)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
    tw = tlora.LoRALinear(tl, r=4, lora_alpha=8)
    with torch.no_grad():
        tw.lora_A.copy_(torch.from_numpy(a))
        tw.lora_B.copy_(torch.from_numpy(b))
    got = tw(torch.from_numpy(x).to(torch.bfloat16))
    assert str(ref.dtype).endswith("float32") and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(ref.numpy()), rtol=0, atol=2e-2)


def test_adapter_dropout_keeps_its_share_and_eval_is_identity():
    """A = B = I, a zero base, scaling 1: the output is dropout(x). Over
    64k ones the dropped share is p within 5 sigma, the kept entries
    1 / (1 - p); in eval mode the output is x."""
    p, n = 0.25, 64
    base = torch.nn.Linear(n, n, bias=False)
    with torch.no_grad():
        base.weight.zero_()
    w = tlora.LoRALinear(base, r=n, lora_alpha=n, lora_dropout=p,
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        w.lora_A.copy_(torch.eye(n))
        w.lora_B.copy_(torch.eye(n))
    x = torch.ones(1024, n)
    y = w(x).detach()
    dropped = float((y == 0).float().mean())
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(dropped - p) <= 5 * sigma
    kept = y[y != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - p)))
    w.eval()
    assert torch.equal(w(x), x)


def test_apply_lora_skips_quantized_layers_and_wrappers():
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    quantize_for_inference(tm, "int8", min_features=0)
    tlora.apply_lora(tm, r=2)
    assert not any(isinstance(m, tlora.LoRALinear) for m in tm.modules())
    tm = gpt("gpt_tiny", device="cpu", **TINY)
    tlora.apply_lora(tm, r=2)
    n = sum(isinstance(m, tlora.LoRALinear) for m in tm.modules())
    tlora.apply_lora(tm, r=2)                # again: nothing double-wraps
    assert sum(isinstance(m, tlora.LoRALinear) for m in tm.modules()) == n
    assert not any(isinstance(m.base, tlora.LoRALinear)
                   for m in tm.modules() if isinstance(m, tlora.LoRALinear))


# ---------------------------------------------------------------------------
# training: eager and the engine against the JAX eager loop
# ---------------------------------------------------------------------------

def _jax_eager(jm, ids):
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jlora.lora_parameters(jm))
    losses = []
    jm.train()
    for _ in range(STEPS):
        loss = jm.loss(paddle.to_tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, _named(jm)


def _check_run(tm, losses, ref_losses, ref_state, before):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = state_to_jax(tm)
    for n, v in got.items():
        if n.endswith(("lora_A", "lora_B")):
            np.testing.assert_allclose(v, ref_state[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(v, before[n])


def test_eager_adapter_training_equals_jax_eager():
    jm, tm = _pair(seed=1)
    ids = _ids(5)
    before = _named(jm)
    ref_losses, ref_state = _jax_eager(jm, ids)
    opt = AdamW(learning_rate=LR, parameters=tlora.lora_parameters(tm))
    losses = []
    tm.train()
    for _ in range(STEPS):
        loss = tm.loss(torch.from_numpy(ids).long())
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert all(p.grad is None for n, p in tm.named_parameters()
               if not p.requires_grad)
    _check_run(tm, losses, ref_losses, ref_state, before)


@pytest.mark.parametrize("given", ["lora_parameters", "all"])
def test_engine_trains_only_adapters_like_jax_eager(given):
    jm, tm = _pair(seed=1)
    ids = _ids(5)
    before = _named(jm)
    ref_losses, ref_state = _jax_eager(jm, ids)
    params = (tlora.lora_parameters(tm) if given == "lora_parameters"
              else tm.parameters())
    eng = parallelize(tm, AdamW(learning_rate=LR, parameters=params))
    losses = [float(eng.train_batch(ids)) for _ in range(STEPS)]
    # the norm is the adapters' alone
    grads = [p.grad for p in tlora.lora_parameters(tm)]
    assert float(eng.last_grad_norm) == pytest.approx(
        float(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in grads]))), rel=1e-6)
    _check_run(tm, losses, ref_losses, ref_state, before)


def test_jax_engine_updates_the_frozen_base():
    """The recorded fault of the reference (ROADMAP Queue 3): its engine
    updates every parameter, `stop_gradient` and the optimizer's list
    notwithstanding. This test fails when the reference changes."""
    jm, _ = _pair(seed=1)
    before = _named(jm)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jlora.lora_parameters(jm))
    eng = dist.parallelize(
        jm, opt, mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]))
    eng.train_batch(paddle.to_tensor(_ids(5)))
    after = _named(jm)
    moved = [n for n in before if not np.array_equal(before[n], after[n])]
    frozen = [n for n, p in jm.named_parameters() if p.stop_gradient]
    assert "transformer.wte.weight" in moved
    assert set(frozen) <= set(moved)
    assert len(moved) == len(before)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_engine_rewinds_a_lora_model_bit_for_bit(compute_dtype):
    """Adapter dropout on (its generator is in the snapshot): a snapshot
    after step 1, two restores, each replaying steps 2-3 bit for bit;
    `state_dict` into a fresh engine continues bit for bit; the base
    stays bit-equal throughout."""
    _, tm = _pair(seed=2, lora_dropout=0.1)
    base = {n: p.detach().clone() for n, p in tm.named_parameters()
            if not p.requires_grad}
    ids = _ids(6)
    eng = parallelize(tm, AdamW(learning_rate=LR,
                                parameters=tlora.lora_parameters(tm)),
                      compute_dtype=compute_dtype)
    eng.train_batch(ids)
    snap = eng.snapshot()
    ref = [eng.train_batch(ids) for _ in range(2)]
    ref_state = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for _ in range(2):
        eng.restore(snap)
        again = [eng.train_batch(ids) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(again, ref))
        assert all(torch.equal(p, ref_state[n])
                   for n, p in tm.named_parameters())
    _, tm2 = _pair(seed=2, lora_dropout=0.1)
    eng2 = parallelize(tm2, AdamW(learning_rate=LR,
                                  parameters=tlora.lora_parameters(tm2)),
                       compute_dtype=compute_dtype)
    eng2.load_state_dict(eng.state_dict())
    tm.eval()
    tm2.eval()
    a = [eng.train_batch(ids) for _ in range(2)]
    b = [eng2.train_batch(ids) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for n, p in tm.named_parameters():
        assert torch.equal(p, dict(tm2.named_parameters())[n])
        if n in base:
            assert torch.equal(p, base[n])


def test_train_batches_on_a_lora_model():
    _, tm = _pair(seed=3)
    ids = _ids(7)
    eng = parallelize(tm, AdamW(learning_rate=LR,
                                parameters=tlora.lora_parameters(tm)))
    losses = eng.train_batches([(ids,)] * 4)
    assert losses.shape == (4,) and float(losses[-1]) < float(losses[0])
    assert eng.last_grad_norms.shape == (4,)


# ---------------------------------------------------------------------------
# serving: quantization, the adapter pool, the engine
# ---------------------------------------------------------------------------

def test_quantized_lora_model_matches_jax():
    """min_features=0 on both sides: the wrappers' bases are swapped (and
    nothing else of theirs), and the greedy tokens match."""
    jm, tm = _pair(seed=4, perturb=6)
    jquantize(jm, "int8", min_features=0)
    quantize_for_inference(tm, "int8", min_features=0)
    jq = sorted(n for n, m in jm.named_sublayers()
                if isinstance(m, JWeightOnlyLinear))
    tq = sorted(n for n, m in tm.named_modules()
                if isinstance(m, WeightOnlyLinear))
    assert tq == jq and "transformer.layers.0.attn.qkv_proj.base" in tq
    assert all(isinstance(m.base, WeightOnlyLinear) for m in tm.modules()
               if isinstance(m, tlora.LoRALinear))
    ids = _ids(8, b=2, s=6)
    jm.eval()
    ref = np.asarray(jgenerate(jm, paddle.to_tensor(ids),
                               max_new_tokens=6).numpy())
    np.testing.assert_array_equal(
        generate(tm, ids, max_new_tokens=6).numpy(), ref)


def test_adapter_pool_on_a_lora_model_raises_like_jax():
    jm, tm = _pair()
    with pytest.raises(ValueError, match="no sublayer matched"):
        JAdapterPool(jm, rank=4)
    with pytest.raises(ValueError, match="no sublayer matched"):
        AdapterPool(tm, rank=4, device="cpu")


def test_exported_adapter_serves_the_tuned_tokens():
    """Fine-tune, export, load into an AdapterPool over a model holding
    the same base weights unwrapped: the engine's greedy tokens for the
    tenant are `generate`'s on the unmerged LoRA model."""
    base = _pair(seed=5, lora=False)[1]
    _, tm = _pair(seed=5)
    ids = _ids(9)
    eng = parallelize(tm, AdamW(learning_rate=LR,
                                parameters=tlora.lora_parameters(tm)))
    eng.train_batches([(ids,)] * 3)
    tm.eval()
    prompts = _ids(10, b=3, s=6)
    ref = generate(tm, prompts, max_new_tokens=7).numpy()[:, 6:]
    pool = AdapterPool(base, rank=4, slots=2, alpha=16,
                       targets=("qkv_proj", "out_proj"), device="cpu")
    pool.load("tuned", tlora.export_lora_weights(tm))
    try:
        with DecodeEngine(base, max_length=32, block_size=8,
                          adapters=pool, device="cpu") as e:
            got = [e.generate(p, 7, adapter="tuned") for p in prompts]
            plain = [e.generate(p, 7) for p in prompts]
    finally:
        pool.detach()
    assert [list(r) for r in ref] == got
    assert got != plain
