"""Port parity: `paddle_tpu_torch.ops.flash_attention` (the plain versions
the CPU runs behind the same autograd Function that launches the kernels
on the GPU) and `nn.functional.cross_entropy` against the JAX package's
Pallas flash attention (interpret mode) and hard-label cross entropy, on
the same numpy inputs. Forward outputs and `torch.autograd` gradients are
held against the JAX forward and `jax.grad`:

* float32: 2e-5 forward, 5e-4 gradients (tests/test_pallas_flash.py's
  bounds: the same f32 math summed in another order);
* bfloat16: 0.05 forward, gradients rtol 0.1 / atol 0.3 (that file's
  bf16 bounds: products rounded to bf16 at different places).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.functional import cross_entropy as jcross_entropy
from paddle_tpu.ops.pallas import flash_attention as jflash
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention_supported as jsupported)

from paddle_tpu_torch.nn import functional as TF
# the module (the package's `flash_attention` name is the function)
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

TOL = {"float32": dict(fwd=(2e-5, 2e-5), grad=(5e-4, 5e-4)),
       "bfloat16": dict(fwd=(0.05, 0.05), grad=(0.1, 0.3))}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, do, causal, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x).astype(_JDT[dtype])
                       for x in (q, k, v, do))

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, interpret=True)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, jq, jk, jv)
        grads = vjp(jdo)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch(q, k, v, do, causal, dtype, fn):
    tq, tk, tv = (torch.from_numpy(x).to(_TDT[dtype]).requires_grad_()
                  for x in (q, k, v))
    out = fn(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do).to(_TDT[dtype]))
    return [x.detach().float().numpy() for x in
            (out, tq.grad, tk.grad, tv.grad)]


def _close(got, ref, dtype, what):
    rtol, atol = TOL[dtype]["fwd" if what == "out" else "grad"]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=what)


def _kernel_route(q, k, v, causal):
    return tfa.flash_attention(q, k, v, causal=causal)


# test_pallas_flash.py's shapes: block-aligned S, ragged S with the head
# dims it pairs them with
CASES = [(1, 256, 2, 32), (1, 128, 2, 16), (2, 256, 3, 16), (1, 200, 2, 32),
         (1, 97, 2, 16), (1, 128, 2, 128), (1, 256, 2, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_flash_f32_matches_jax(shape, causal):
    args = _inputs(*shape, seed=sum(shape))
    ref = _jax(*args, causal, "float32")
    got = _torch(*args, causal, "float32", _kernel_route)
    for g, r, what in zip(got, ref, ("out", "dq", "dk", "dv")):
        _close(g, r, "float32", what)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 200, 2, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_bf16_matches_jax(shape, causal):
    args = _inputs(*shape, seed=7)
    ref = _jax(*args, causal, "bfloat16")
    got = _torch(*args, causal, "bfloat16", _kernel_route)
    for g, r, what in zip(got, ref, ("out", "dq", "dk", "dv")):
        _close(g, r, "bfloat16", what)


def test_plain_backward_matches_autograd_of_plain_forward():
    """flash_attention_bwd_ref (what the dq / dkv kernels are held
    against) equals autograd through flash_attention_ref in f32."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 130, 2, 24, 3))
    for causal in (True, False):
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        out, lse = tfa.flash_attention_ref(qa, ka, va, causal=causal)
        out.backward(do)
        delta = tfa.attention_delta(out.detach(), do)
        got = tfa.flash_attention_bwd_ref(q, k, v, do, lse.detach(), delta,
                                          causal=causal)
        for g, r in zip(got, (qa.grad, ka.grad, va.grad)):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 300, 2, 64), (1, 130, 2, 128),
                                   (1, 64, 2, 64), (1, 256, 2, 512),
                                   (2, 4096, 8, 256), (1, 4096, 8, 257),
                                   (1, 128, 1, 256), (1, 127, 1, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_supported_predicate_equals_jax(shape, causal):
    assert tfa.flash_attention_supported(shape, causal) == \
        jsupported(shape, causal)


def test_sdpa_routes_cpu_and_odd_shapes_to_plain_version():
    """On the CPU every call is the plain version (no launch), the same
    numbers as the JAX functional; GQA-shaped k/v are served too."""
    from paddle_tpu.nn import functional as JF

    r = np.random.RandomState(5)
    q, k, v = (r.randn(2, 128, 4, 16).astype(np.float32) for _ in range(3))
    before = tfa.flash_attention_fwd.launches
    got, none = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert none is None and tfa.flash_attention_fwd.launches == before
    with jax.default_matmul_precision("highest"):
        ref, _ = JF.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                               rtol=2e-5, atol=2e-5)
    kg = torch.from_numpy(k[:, :, :2])
    out = TF.scaled_dot_product_attention(torch.from_numpy(q), kg, kg,
                                          is_causal=True)
    rep = tfa.flash_attention_ref(torch.from_numpy(q),
                                  kg.repeat_interleave(2, dim=2),
                                  kg.repeat_interleave(2, dim=2))[0]
    torch.testing.assert_close(out, rep)


def test_unported_options_raise():
    x = torch.zeros(1, 128, 2, 16)
    with pytest.raises(NotImplementedError, match="Queue 2 #7"):
        TF.scaled_dot_product_attention(x, x, x, dropout_p=0.1)
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(x, x, x,
                                        attn_mask=torch.ones(128, 128))
    with pytest.raises(NotImplementedError):
        TF.flash_attention(x, x, x, return_softmax=True)
    with pytest.raises(NotImplementedError):
        TF.cross_entropy(torch.zeros(3, 5), torch.zeros(3, dtype=torch.long),
                         reduction="sum")
    out = TF.scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                          training=False)
    assert out.shape == x.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    """Mean hard-label CE with ignored positions, forward and gradient.
    f32: 1e-5; bf16 logits: the loss and gradient are rounded to bf16 on
    both sides (one bf16 ulp of slack: 1e-2)."""
    r = np.random.RandomState(11)
    logits = (r.randn(37, 53) * 3).astype(np.float32)
    label = r.randint(0, 53, (37,)).astype(np.int64)
    label[[3, 9, 20]] = -100
    tol = 1e-5 if dtype == "float32" else 1e-2

    jx = jnp.asarray(logits).astype(_JDT[dtype])
    with jax.default_matmul_precision("highest"):
        ref, g = jax.value_and_grad(
            lambda x: jcross_entropy(Tensor(x), Tensor(
                jnp.asarray(label, jnp.int32)))._value.astype(
                    jnp.float32))(jx)
    tx = torch.from_numpy(logits).to(_TDT[dtype]).requires_grad_()
    loss = TF.cross_entropy(tx, torch.from_numpy(label))
    assert loss.dtype == _TDT[dtype]
    loss.float().backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(g.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert not tx.grad[[3, 9, 20]].any()
