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
    """What is still refused raises; attention dropout and an additive
    mask compute (dropout through the short-attention route)."""
    x = torch.zeros(1, 128, 2, 16)
    with pytest.raises(NotImplementedError):
        TF.flash_attention(x, x, x, return_softmax=True)
    with pytest.raises(NotImplementedError):
        TF.cross_entropy(torch.zeros(3, 5), torch.zeros(3, dtype=torch.long),
                         reduction="sum")
    with pytest.raises(TypeError):
        TF.scaled_dot_product_attention(
            x, x, x, attn_mask=torch.ones(128, 128, dtype=torch.bool))
    y = torch.randn(1, 128, 2, 16, generator=torch.Generator().manual_seed(0))
    dropped = TF.scaled_dot_product_attention(y, y, y, dropout_p=0.1)
    masked = TF.scaled_dot_product_attention(y, y, y,
                                             attn_mask=torch.zeros(128, 128))
    out = TF.scaled_dot_product_attention(y, y, y, dropout_p=0.1,
                                          training=False)
    assert dropped.shape == masked.shape == out.shape == x.shape
    assert not torch.equal(dropped, out)
    torch.testing.assert_close(masked, out, rtol=0, atol=1e-6)


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


def _meta_qkv(B, S, H, D, dtype=torch.bfloat16, fused=True):
    """q, k, v of a model's shapes without memory: meta tensors keep the
    shapes, the strides and the byte offsets of the views."""
    if fused:
        return torch.empty(B, S, 3, H, D, dtype=dtype, device="meta").unbind(2)
    return [torch.empty(B, S, H, D, dtype=dtype, device="meta")
            for _ in range(3)]


@pytest.mark.parametrize("case,shape,dtype,fused,route", [
    ("gpt_base", (16, 1024, 12, 64), "bfloat16", True, "wgmma"),
    ("bert_base", (128, 128, 12, 64), "bfloat16", True, "wgmma"),
    ("llama2_7b", (4, 2048, 32, 128), "bfloat16", False, "wgmma"),
    ("padded D = 80", (2, 1024, 8, 80), "bfloat16", True, "wgmma"),
    ("D = 40", (32, 128, 12, 40), "bfloat16", True, "wgmma"),
    ("gpt_base f32", (16, 1024, 12, 64), "float32", True, "mma"),
    ("D = 256", (1, 256, 2, 256), "bfloat16", False, "mma"),
    ("D = 32", (1, 256, 2, 32), "bfloat16", True, "mma"),
    ("D = 36", (1, 256, 2, 36), "bfloat16", False, "mma"),
])
def test_fwd_route_predicate_on_the_slices_shapes(case, shape, dtype, fused,
                                                  route):
    q, k, v = _meta_qkv(*shape, dtype=_TDT[dtype], fused=fused)
    want = {"wgmma": tfa.FWD_WGMMA, "mma": tfa.FWD_MMA}[route]
    assert tfa.flash_fwd_route(q, k, v)[0] == want, case


def test_fwd_route_predicate_refuses_what_tma_cannot_describe():
    """A base off 16 bytes keeps the mma.sync body; a stride along D is
    no refusal: the wrapper launches on a unit-stride copy, which the
    route returns and the Hopper body takes."""
    q, k, v = _meta_qkv(2, 256, 4, 64)
    route, ops, _, strides = tfa.flash_fwd_route(q, k, v)
    assert route == tfa.FWD_WGMMA
    assert all(a is b for a, b in zip(ops, (q, k, v)))
    strided = torch.empty(2, 256, 4, 128, dtype=torch.bfloat16,
                          device="meta")[..., ::2]
    route, ops, _, strides = tfa.flash_fwd_route(strided, k, v)
    assert route == tfa.FWD_WGMMA
    assert ops[0] is not strided and strides[0] == (65536, 256, 64, 1)
    base = torch.empty(2 * 256 * 4 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    odd = base[4:].view(2, 256, 4, 64)
    assert tfa.flash_fwd_route(odd, k, v)[0] == tfa.FWD_MMA


def test_fwd_route_counts_name_both_bodies_and_a_cpu_call_counts_none():
    """`flash_attention_fwd.routes` counts launches by body where the
    kernel is launched; the plain version on the CPU launches none."""
    assert set(tfa.flash_attention_fwd.routes) == {tfa.FWD_MMA,
                                                   tfa.FWD_WGMMA}
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = dict(tfa.flash_attention_fwd.routes)
    tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa.flash_attention_fwd.routes == before


@pytest.mark.parametrize("case,shape,dtype,fused,route", [
    ("gpt_base", (16, 1024, 12, 64), "bfloat16", True, "wgmma"),
    ("llama2_7b", (4, 2048, 32, 128), "bfloat16", False, "wgmma"),
    ("ragged S", (4, 1000, 12, 64), "bfloat16", True, "wgmma"),
    ("padded D = 80", (2, 1024, 8, 80), "bfloat16", True, "wgmma"),
    ("gpt_base f32", (16, 1024, 12, 64), "float32", True, "mma"),
    ("D = 256", (1, 256, 2, 256), "bfloat16", False, "mma"),
    ("D = 32", (1, 256, 2, 32), "bfloat16", True, "mma"),
    ("D = 36", (1, 256, 2, 36), "bfloat16", False, "mma"),
])
def test_bwd_route_predicate_on_the_slices_shapes(case, shape, dtype, fused,
                                                  route):
    """The backward takes its Hopper bodies on the forward's conditions,
    with dO held to them too."""
    q, k, v = _meta_qkv(*shape, dtype=_TDT[dtype], fused=fused)
    do = torch.empty(shape, dtype=_TDT[dtype], device="meta")
    want = {"wgmma": tfa.BWD_WGMMA, "mma": tfa.BWD_MMA}[route]
    assert tfa.flash_bwd_route(q, k, v, do)[0] == want, case
    assert (want == tfa.BWD_WGMMA) == (
        tfa.flash_fwd_route(q, k, v)[0] == tfa.FWD_WGMMA), case


def test_bwd_route_predicate_refuses_what_tma_cannot_describe():
    """dO with a base off 16 bytes, or a stride that is not a multiple of
    8 elements, keeps the mma.sync bodies, as do a scale that is not
    positive and an f32 dO. A dO with a stride along D is launched as a
    unit-stride copy, which the Hopper bodies take: the route returns the
    copy the wrappers launch on."""
    q, k, v = _meta_qkv(2, 256, 4, 64)
    do = torch.empty(2, 256, 4, 64, dtype=torch.bfloat16, device="meta")
    assert tfa.flash_bwd_route(q, k, v, do)[0] == tfa.BWD_WGMMA
    strided = torch.empty(2, 256, 4, 128, dtype=torch.bfloat16,
                          device="meta")[..., ::2]
    route, ops, _, strides = tfa.flash_bwd_route(q, k, v, strided)
    assert route == tfa.BWD_WGMMA
    assert ops[3] is not strided and strides[3] == (65536, 256, 64, 1)
    base = torch.empty(2 * 256 * 4 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    assert tfa.flash_bwd_route(q, k, v, base[4:].view(2, 256, 4, 64))[0] \
        == tfa.BWD_MMA
    wide = torch.empty(2, 256, 4, 68, dtype=torch.bfloat16,
                       device="meta")[..., :64]
    assert tfa.flash_bwd_route(q, k, v, wide)[0] == tfa.BWD_MMA
    assert tfa.flash_bwd_route(q, k, v, do, scale=0.0)[0] == tfa.BWD_MMA
    assert tfa.flash_bwd_route(q, k, v, do.to(torch.float32))[0] \
        == tfa.BWD_MMA


def test_bwd_route_counts_name_both_bodies_and_a_cpu_call_counts_none():
    """`flash_attention_bwd_dq.routes` and `flash_attention_bwd_dkv.routes`
    count launches by body where the kernels are launched; the plain
    versions on the CPU launch none."""
    for w in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        assert set(w.routes) == {tfa.BWD_MMA, tfa.BWD_WGMMA}
    g = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(1, 128, 2, 64, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    lse = torch.zeros(1, 2, 128)
    before = [dict(w.routes) for w in (tfa.flash_attention_bwd_dq,
                                       tfa.flash_attention_bwd_dkv)]
    tfa.flash_attention_bwd_dq(q, k, v, do, lse, lse, causal=True)
    tfa.flash_attention_bwd_dkv(q, k, v, do, lse, lse, causal=True)
    assert [dict(w.routes) for w in (tfa.flash_attention_bwd_dq,
                                     tfa.flash_attention_bwd_dkv)] == before


# --- the ring step's route (`flash_pos_route`) --------------------------------

def _meta_shard(B, s, H, D, dtype=torch.bfloat16):
    return torch.empty(B, s, H, D, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,q_shape,k_len,dtype,route", [
    ("gpt_base shard", (8, 512, 12, 64), 512, "bfloat16", "wgmma"),
    ("llama2_7b shard", (1, 2048, 32, 128), 2048, "bfloat16", "wgmma"),
    ("padded D = 80", (2, 256, 4, 80), 256, "bfloat16", "wgmma"),
    ("gpt_base shard f32", (8, 512, 12, 64), 512, "float32", "mma"),
    ("D = 32", (2, 256, 4, 32), 256, "bfloat16", "mma"),
    ("D = 256", (1, 256, 2, 256), 256, "bfloat16", "mma"),
    ("Sq != Sk", (2, 200, 3, 64), 136, "bfloat16", "mma"),
])
def test_pos_route_predicate_on_the_ring_shapes(case, q_shape, k_len, dtype,
                                                route):
    """The ring step takes the Hopper bodies on the whole-sequence
    kernels' conditions with shards of one length, forward and backward
    alike; f32, head-dim tiles 32 and 256 and Sq != Sk the mma.sync
    bodies."""
    B, s, H, D = q_shape
    q, do = (_meta_shard(B, s, H, D, _TDT[dtype]) for _ in range(2))
    k, v = (_meta_shard(B, k_len, H, D, _TDT[dtype]) for _ in range(2))
    fwd = {"wgmma": tfa.FWD_WGMMA, "mma": tfa.FWD_MMA}[route]
    bwd = {"wgmma": tfa.BWD_WGMMA, "mma": tfa.BWD_MMA}[route]
    assert tfa.flash_pos_route(q, k, v)[0] == fwd, case
    assert tfa.flash_pos_route(q, k, v, do)[0] == bwd, case


def test_pos_route_refuses_what_tma_cannot_describe():
    """A base off 16 bytes (q, or dO alone) keeps the mma.sync bodies; a
    stride along D is launched as a unit-stride copy, which the route
    returns and the Hopper bodies take."""
    q, k, v, do = (_meta_shard(2, 256, 4, 64) for _ in range(4))
    base = torch.empty(2 * 256 * 4 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    odd = base[4:].view(2, 256, 4, 64)
    assert tfa.flash_pos_route(odd, k, v)[0] == tfa.FWD_MMA
    assert tfa.flash_pos_route(q, k, v, odd)[0] == tfa.BWD_MMA
    strided = torch.empty(2, 256, 4, 128, dtype=torch.bfloat16,
                          device="meta")[..., ::2]
    route, ops, _, strides = tfa.flash_pos_route(q, strided, v, do)
    assert route == tfa.BWD_WGMMA
    assert ops[1] is not strided and strides[1] == (65536, 256, 64, 1)


def test_pos_route_counts_name_both_bodies_and_a_cpu_call_counts_none():
    """The ring-step wrappers count launches by body (`.routes`) where the
    kernels are launched, beside `.launches`; the plain versions on the
    CPU launch none."""
    assert set(tfa.flash_fwd_pos.routes) == {tfa.FWD_MMA, tfa.FWD_WGMMA}
    wrappers = (tfa.flash_fwd_pos, tfa.flash_bwd_pos_dq,
                tfa.flash_bwd_pos_dkv)
    for w in wrappers[1:]:
        assert set(w.routes) == {tfa.BWD_MMA, tfa.BWD_WGMMA}
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(1, 128, 2, 64, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    pos = torch.arange(128, dtype=torch.int32)
    before = [(w.launches, dict(w.routes)) for w in wrappers]
    out, lse = tfa.flash_fwd_pos(q, k, v, pos, pos)
    delta = tfa.attention_delta(out, do)
    tfa.flash_bwd_pos(q, k, v, do, lse, delta, pos, pos)
    assert [(w.launches, dict(w.routes)) for w in wrappers] == before
