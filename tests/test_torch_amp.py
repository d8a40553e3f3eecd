"""Port parity of AMP: `paddle_tpu_torch.amp` against `paddle_tpu.amp`.

* `auto_cast` O1 and O2, bf16 and fp16, on a small module of linear,
  matmul, softmax, add (both operands f32, and a low-precision one with
  an f32 one), layer_norm and exp: every op's output dtype equals the
  JAX package's, and its values agree within the AMP dtype's rounding,
  4 ulps of the largest magnitude (2**-8 each in bf16, 2**-11 in fp16),
  the ops' rounding in another order on each side.
* gpt_tiny's loss under O1 bf16 against JAX's, within 2e-2 relative.
* `GradScaler`'s scale trajectory with planted infs and NaNs against the
  JAX GradScaler's, with ``==``; skipped steps leave the parameters and
  the optimizer's step counter as they were.
* `decorate` O2, a bert_tiny O2 step under the scaler on the CPU, the
  policy's thread locality (a decode engine's scheduler thread runs
  outside the caller's `auto_cast`), and the arguments the reference
  ignores, which the port refuses.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import bert_for_sequence_classification, gpt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, AdamW

_TORCH_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
             "float32": torch.float32}
_ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def _inputs():
    rng = np.random.RandomState(0)
    return dict(x=rng.randn(4, 8), W=rng.randn(8, 16) * 0.3,
                b=rng.randn(16), M=rng.randn(16, 16) * 0.3,
                x2=rng.randn(4, 16), g=rng.randn(16))


def _jax_module(a):
    T = paddle.to_tensor
    h = JF.linear(T(a["x"]), T(a["W"]), T(a["b"]))
    m = paddle.matmul(h, T(a["M"]))
    s = JF.softmax(m, -1)
    add = s + T(a["x2"])
    mixed = m + T(a["x2"])
    n = JF.layer_norm(add, [16], T(a["g"]), T(a["b"]))
    return [h, m, s, add, mixed, n, paddle.exp(n)]


def _torch_module(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    h = torch.nn.functional.linear(t["x"], t["W"].t(), t["b"])
    m = torch.matmul(h, t["M"])
    s = torch.softmax(m, -1)
    add = s + t["x2"]
    mixed = m + t["x2"]
    n = TF.layer_norm(add, t["g"], t["b"], 1e-5)
    return [h, m, s, add, mixed, n, torch.exp(n)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_op_dtypes_match_jax(level, dtype):
    a = {k: v.astype(np.float32) for k, v in _inputs().items()}
    with jax.default_matmul_precision("highest"):
        with paddle.amp.auto_cast(level=level, dtype=dtype):
            jouts = _jax_module(a)
    with amp.auto_cast(level=level, dtype=dtype):
        touts = _torch_module(a)
    names = ["linear", "matmul", "softmax", "add", "add (mixed)",
             "layer_norm", "exp"]
    for name, j, t in zip(names, jouts, touts):
        assert t.dtype == _TORCH_DT[str(j.dtype)], (name, t.dtype, j.dtype)
        ref = np.asarray(j.numpy(), np.float32)
        tol = 4 * _ULP[dtype] * float(np.abs(ref).max())
        got = t.float().numpy()
        assert float(np.abs(got - ref).max()) <= tol, name
    # outside the block nothing is cast
    assert all(t.dtype == torch.float32 for t in _torch_module(a))
    assert not amp.amp_state().enabled


def test_custom_lists_adjust_the_policy():
    x = torch.randn(4, 4)
    with amp.auto_cast(level="O1", dtype="bfloat16",
                       custom_white_list={"add"},
                       custom_black_list={"matmul"}):
        assert (x + x).dtype == torch.bfloat16
        assert (x.bfloat16() @ x.bfloat16()).dtype == torch.float32
        # an embedding's integer indices stay integers
        ids = torch.tensor([[1, 2]])
        emb = torch.nn.functional.embedding(ids, x)
        assert emb.dtype == torch.float32
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert torch.nn.functional.embedding(ids, x).dtype == torch.bfloat16
        assert (x + x).dtype == torch.bfloat16


def test_gpt_tiny_loss_under_o1_matches_jax():
    paddle.seed(0)
    jm = jgpt("gpt_tiny")
    tm = gpt("gpt_tiny", device="cpu")
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(0).randint(0, 256, (2, 64)).astype(np.int32)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl = float(jm.loss(paddle.to_tensor(ids)))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = tm.loss(torch.from_numpy(ids).long())
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=2e-2)
    tl.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())


# the scaler test's steps: True for finite gradients, else the value
# planted in one gradient element
_EVENTS = [True, True, "inf", True, True, True, "nan", "inf", True, True,
           True, True, "-inf", True, True]


def _run_scaler(pkg, events, **kw):
    """Drive a scaler through `events`; returns the scale after each
    update and the parameter after each step."""
    if pkg == "jax":
        p = paddle.to_tensor(np.ones(3, np.float32))
        p.stop_gradient = False
        opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[p])
        scaler = paddle.amp.GradScaler(**kw)
        const = paddle.to_tensor
    else:
        p = torch.nn.Parameter(torch.ones(3))
        opt = SGD(learning_rate=0.1, parameters=[p])
        scaler = amp.GradScaler(**kw)
        const = torch.from_numpy
    scales, params = [], []
    for ev in events:
        c = np.array([1.0, -2.0, 0.5], np.float32)
        if ev is not True:
            c[1] = float(ev)
        loss = (p * const(c)).sum()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        params.append(np.asarray(p.numpy() if pkg == "jax"
                                 else p.detach().numpy()).copy())
    return scales, params, opt, scaler


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2),
    dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
         decr_every_n_nan_or_inf=2, decr_ratio=0.25, incr_ratio=4.0),
])
def test_grad_scaler_trajectory_matches_jax(kw):
    js, jp, _, jscaler = _run_scaler("jax", _EVENTS, **kw)
    ts, tp, topt, tscaler = _run_scaler("torch", _EVENTS, **kw)
    assert ts == js
    for i, ev in enumerate(_EVENTS):
        np.testing.assert_allclose(tp[i], jp[i], rtol=1e-6, atol=1e-6)
        if ev is not True:
            before = tp[i - 1] if i else np.ones(3, np.float32)
            assert np.array_equal(tp[i], before), i
    assert topt._step_count == sum(ev is True for ev in _EVENTS)
    assert tscaler.state_dict() == jscaler.state_dict()


def test_unscale_then_step_unscales_once():
    """`unscale_` (to clip between backward and step) followed by `step`
    divides by the scale once (the reference divides twice)."""
    p = torch.nn.Parameter(torch.ones(2))
    opt = SGD(learning_rate=1.0, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    scaler.scale((p * torch.tensor([1.0, 2.0])).sum()).backward()
    scaler.unscale_(opt)
    torch.testing.assert_close(p.grad, torch.tensor([1.0, 2.0]))
    scaler.step(opt)
    scaler.update()
    torch.testing.assert_close(p.detach(), torch.tensor([0.0, -1.0]))


def test_grad_scaler_state_dict_round_trip():
    """`load_state_dict` restores every key `state_dict` writes (the
    ratios too, which the reference drops), so a scaler loaded into one
    built at the defaults continues the same scale trajectory."""
    kw = dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=1, decr_ratio=0.25, incr_ratio=4.0)
    _, _, _, scaler = _run_scaler("torch", _EVENTS[:5], **kw)
    fresh = amp.GradScaler(incr_every_n_steps=3)
    fresh.load_state_dict(scaler.state_dict())
    assert fresh.state_dict() == scaler.state_dict()
    for s in (scaler, fresh):
        s._found_inf = True
        s.update()
        s._found_inf = False
        for _ in range(3):
            s.update()
    assert fresh.state_dict() == scaler.state_dict()
    assert fresh.get_init_loss_scaling() == scaler.get_init_loss_scaling()


def test_fp16_dropout_attention_on_the_cpu_takes_the_plain_route():
    """Training-mode dropout attention in fp16 on a CPU tensor runs the
    composed plain path on the same bit stream (on a CUDA tensor the
    short-attention kernels refuse fp16 with TypeError instead)."""
    from paddle_tpu_torch.ops import _dropout_rng
    from paddle_tpu_torch.ops.short_attention import composed_attention

    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float16))
               for _ in range(3))
    got = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.1, training=True,
        generator=torch.Generator().manual_seed(7))
    seed = _dropout_rng.draw_seed(torch.Generator().manual_seed(7),
                                  q.device)
    want = composed_attention(q, k, v, None, False, 0.1, seed)[0]
    assert got.dtype == torch.float16
    assert torch.equal(got, want)


def test_decorate_o2_and_a_bert_tiny_step():
    """bert_tiny decorated to bf16 (the same Parameter objects), one O2
    step under the scaler: a finite f32 loss, bf16 gradients and AdamW
    moments, parameters moved; then a step with an inf gradient is
    skipped bit for bit and halves the scale."""
    gen = torch.Generator().manual_seed(1)
    m = bert_for_sequence_classification("bert_tiny", device="cpu",
                                         generator=gen)
    before = list(m.parameters())
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    m2, opt2 = amp.decorate(m, opt, level="O2", dtype="bfloat16")
    assert m2 is m and opt2 is opt
    assert all(p is q and p.dtype == torch.bfloat16
               for p, q in zip(m.parameters(), before))
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 8)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (4, 32)))
    labels = torch.from_numpy(rng.randint(0, 2, (4,)))

    def step(poison=False):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = TF.cross_entropy(m(ids), labels)
        assert loss.dtype == torch.float32
        scaler.scale(loss).backward()
        if poison:
            m.classifier.weight.grad[0, 0] = float("inf")
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    w0 = m.classifier.weight.detach().clone()
    assert torch.isfinite(step())
    assert not torch.equal(m.classifier.weight, w0)
    st = opt.state_dict()
    assert st["moment1_0"].dtype == torch.bfloat16
    snap = [p.detach().clone() for p in m.parameters()]
    step(poison=True)
    assert scaler.get_init_loss_scaling() == 2.0 ** 7
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), snap))
    assert opt._step_count == 1


def test_policy_is_per_thread():
    """`auto_cast` in one thread casts nothing in another, so a decode
    engine's scheduler thread (and its CUDA-graph captures) runs outside a
    caller's `auto_cast`."""
    x = torch.randn(2, 2)
    seen = {}

    def other():
        seen["dtype"] = (x @ x).dtype
        seen["enabled"] = amp.amp_state().enabled

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert (x @ x).dtype == torch.bfloat16
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"dtype": torch.float32, "enabled": False}


def test_decode_engine_ignores_a_callers_auto_cast():
    from paddle_tpu_torch.inference import DecodeEngine

    tm = gpt("gpt_tiny", device="cpu")
    tm.eval()
    eng = DecodeEngine(tm, max_length=48, block_size=8,
                       decode_buckets=(1, 2), prefill_buckets=(8, 16),
                       prefill_chunk=8, default_timeout=60.0, device="cpu")
    try:
        prompt = list(range(3, 14))
        ref = eng.generate(prompt, 6)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            got = eng.generate(prompt, 6)
        assert got == ref
    finally:
        eng.shutdown()


@pytest.mark.parametrize("call", [
    lambda: amp.auto_cast(use_promote=False).__enter__(),
    lambda: amp.auto_cast(level="O0").__enter__(),
    lambda: amp.decorate(torch.nn.Linear(2, 2), level="O2",
                         master_weight=True),
    lambda: amp.decorate(torch.nn.Linear(2, 2), level="O2",
                         save_dtype="float32"),
])
def test_arguments_the_reference_ignores_are_refused(call):
    with pytest.raises(NotImplementedError):
        call()
    assert not amp.amp_state().enabled
