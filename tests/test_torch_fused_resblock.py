"""Port parity of the fused bottleneck kernels' plain versions
(`paddle_tpu_torch.ops.fused_resblock`) on the CPU, against the JAX
package's Pallas kernels in interpret mode (as tests/test_fused_resblock.py
runs them), on the same numpy inputs.

* MATMUL_DTYPE f32 on both sides (the JAX test's setting): y atol 2e-5 /
  rtol 1e-5, as JAX's own test; the six BN statistics atol 1e-5 (f32 sums
  in another order); the ten gradients of `fused_bottleneck_auto`
  relative max error (max |a - b| / max |b|) <= 1e-4.
* bf16 operands on both sides (the production setting): the two round
  f32 sums of the same bf16 products to bf16 at r1 and r2, summed in
  another order, so a value at a rounding boundary can land one bf16 ulp
  apart and move what follows: y within 4 bf16 ulps of max |y| (max abs),
  the statistics and gradients normwise (||a - b|| / ||b||) within 1e-2.
* The odd batch (N=6, H=W=4, 4C=16, C=8) of the JAX test, f32.
* The port's plain kernels against the port's f32 `bottleneck_reference`
  (and autograd through it), f32: y atol 2e-5, statistics atol 1e-5,
  gradients relative 1e-4.
* Two chained blocks with the k4 -> k1 coupling (`fused_bottleneck2_fwd`)
  against the JAX chain in interpret mode: MATMUL_DTYPE f32, y2 atol and
  rtol 2e-4 (tests/test_fused_resblock.py:127's tolerance); bf16 operands
  with x in f32 and in bf16, y2 within 4 bf16 ulps of max |y2|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops.pallas import fused_resblock as jfr

from paddle_tpu_torch.ops import fused_resblock as tfr

NAMES = "x w1 w2 w3 g1 b1 g2 b2 g3 b3".split()


def _args(N=4, H=8, W=8, C4=32, C=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C4).astype(np.float32)
    w1 = rng.randn(C4, C).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, C, C).astype(np.float32) * 0.1
    w3 = rng.randn(C, C4).astype(np.float32) * 0.1
    vecs = [1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C),
            1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C),
            1.0 + 0.1 * rng.randn(C4), 0.1 * rng.randn(C4)]
    return [x, w1, w2, w3] + [v.astype(np.float32) for v in vecs]


def _cot(shape):
    return np.cos(np.arange(int(np.prod(shape))).reshape(shape) * 0.01
                  ).astype(np.float32)


@pytest.fixture
def matmul_dtype(request, monkeypatch):
    """Both packages' MATMUL_DTYPE set to the parameter (f32 or bf16)."""
    name = request.param
    monkeypatch.setattr(jfr, "MATMUL_DTYPE", getattr(jnp, name))
    monkeypatch.setattr(tfr, "MATMUL_DTYPE", getattr(torch, name))
    return name


def _jax_fwd(args):
    with jax.default_matmul_precision("highest"):
        out = jfr.fused_bottleneck_auto(*map(jnp.asarray, args))
    return [np.asarray(o, dtype=np.float32) for o in out]


def _jax_grads(args, cot):
    with jax.default_matmul_precision("highest"):
        g = jax.grad(lambda a: jnp.sum(
            jfr.fused_bottleneck_auto(*a)[0].astype(jnp.float32) * cot))(
            [jnp.asarray(a) for a in args])
    return [np.asarray(t, dtype=np.float32) for t in g]


def _port(args, cot, x_dtype=torch.float32):
    leaves = [torch.from_numpy(a.copy()) for a in args]
    leaves[0] = leaves[0].to(x_dtype)
    leaves = [t.requires_grad_() for t in leaves]
    out = tfr.fused_bottleneck_auto(*leaves)
    (out[0].float() * torch.from_numpy(cot)).sum().backward()
    return ([o.detach().float().numpy() for o in out],
            [t.grad.float().numpy() for t in leaves])


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("matmul_dtype", ["float32"], indirect=True)
@pytest.mark.parametrize("shape", [dict(), dict(N=6, H=4, W=4, C4=16, C=8,
                                                seed=1)])
def test_plain_forward_matches_jax_kernels(matmul_dtype, shape):
    args = _args(**shape)
    jout = _jax_fwd(args)
    tout, _ = _port(args, _cot(args[0].shape))
    np.testing.assert_allclose(tout[0], jout[0], atol=2e-5, rtol=1e-5)
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("matmul_dtype", ["float32"], indirect=True)
@pytest.mark.parametrize("shape", [dict(), dict(N=6, H=4, W=4, C4=16, C=8,
                                                seed=1)])
def test_plain_gradients_match_jax_kernels(matmul_dtype, shape):
    args = _args(**shape)
    cot = _cot(args[0].shape)
    jg = _jax_grads(args, cot)
    _, tg = _port(args, cot)
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel_max(a, b) <= 1e-4, (name, _rel_max(a, b))


@pytest.mark.parametrize("matmul_dtype", ["bfloat16"], indirect=True)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_bf16_operands_match_jax_kernels(matmul_dtype, x_dtype):
    args = _args(N=2, H=8, W=8, C4=64, C=16, seed=3)
    args[0] = np.asarray(jnp.asarray(args[0]).astype(getattr(jnp, x_dtype)
                                                      ).astype(jnp.float32))
    cot = _cot(args[0].shape)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(getattr(jnp, x_dtype))
    with jax.default_matmul_precision("highest"):
        jout = [np.asarray(o, dtype=np.float32)
                for o in jfr.fused_bottleneck_auto(*jargs)]
        jg = jax.grad(lambda a: jnp.sum(
            jfr.fused_bottleneck_auto(*a)[0].astype(jnp.float32) * cot))(
            jargs)
    jg = [np.asarray(t, dtype=np.float32) for t in jg]
    tout, tg = _port(args, cot, getattr(torch, x_dtype))
    ulp = 2.0 ** -8 * np.max(np.abs(jout[0]))
    assert np.max(np.abs(tout[0] - jout[0])) <= 4 * ulp
    for a, b in zip(tout[1:], jout[1:]):
        assert _normwise(a, b) <= 1e-2
    for name, a, b in zip(NAMES, tg, jg):
        assert _normwise(a, b) <= 1e-2, (name, _normwise(a, b))


def test_plain_kernels_match_port_reference():
    """Kernel arithmetic (f32 operands) against the module composition in
    f32, forward and gradients, both in the port."""
    args = [torch.from_numpy(a) for a in _args(seed=2)]
    cot = torch.from_numpy(_cot(args[0].shape))
    old = tfr.MATMUL_DTYPE
    tfr.MATMUL_DTYPE = torch.float32
    try:
        fused = [t.clone().requires_grad_() for t in args]
        out = tfr.fused_bottleneck_auto(*fused)
        (out[0] * cot).sum().backward()
    finally:
        tfr.MATMUL_DTYPE = old
    ref = [t.clone().requires_grad_() for t in args]
    y_ref, stats_ref = tfr.bottleneck_reference(*ref)
    (y_ref * cot).sum().backward()
    torch.testing.assert_close(out[0], y_ref, atol=2e-5, rtol=1e-5)
    flat_ref = [t for pair in stats_ref for t in pair]
    for a, b in zip(out[1:], flat_ref):
        torch.testing.assert_close(a, b.detach(), atol=1e-5, rtol=0)
    for name, a, b in zip(NAMES, fused, ref):
        assert _rel_max(a.grad.numpy(), b.grad.numpy()) <= 1e-4, name


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    args = [torch.from_numpy(a) for a in _args()]
    before = (tfr.fused_bottleneck_fwd.launches,
              tfr.fused_bottleneck_bwd.launches)
    y, res, stats = tfr.fused_bottleneck_fwd(*args)
    y_ref, _, stats_ref = tfr.fused_bottleneck_fwd_ref(*args)
    assert torch.equal(y, y_ref)
    dy = torch.ones_like(y)
    for a, b in zip(tfr.fused_bottleneck_bwd(res, dy),
                    tfr.fused_bottleneck_bwd_ref(res, dy)):
        assert torch.equal(a, b)
    assert (tfr.fused_bottleneck_fwd.launches,
            tfr.fused_bottleneck_bwd.launches) == before
    with pytest.raises(ValueError):
        tfr.fused_bottleneck_fwd(args[0], args[1].t(), *args[2:])


# ------------------------------------------------ two blocks, k4 -> k1 coupled

def _pair_args(x_dtype="float32", **shape):
    a1 = _args(seed=1, **shape)
    a2 = _args(seed=2, **shape)
    x = np.array(jnp.asarray(a1[0]).astype(getattr(jnp, x_dtype)
                                             ).astype(jnp.float32))
    return x, a1[1:], a2[1:]


def _pair_jax(x, p1, p2, x_dtype):
    xj = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    with jax.default_matmul_precision("highest"):
        y = jfr.fused_bottleneck2_fwd(xj, tuple(map(jnp.asarray, p1)),
                                      tuple(map(jnp.asarray, p2)),
                                      interpret=True)
    return np.asarray(y, dtype=np.float32)


def _pair_port(x, p1, p2, x_dtype):
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    y = tfr.fused_bottleneck2_fwd(xt, [torch.from_numpy(a) for a in p1],
                                  [torch.from_numpy(a) for a in p2])
    assert y.dtype == xt.dtype and y.shape == xt.shape
    return y.float().numpy()


@pytest.mark.parametrize("matmul_dtype", ["float32"], indirect=True)
@pytest.mark.parametrize("shape", [dict(), dict(N=6, H=4, W=4, C4=16, C=8)])
def test_coupled_pair_matches_jax_f32(matmul_dtype, shape):
    x, p1, p2 = _pair_args(**shape)
    want = _pair_jax(x, p1, p2, "float32")
    before = tfr.fused_bottleneck2_fwd.launches
    got = _pair_port(x, p1, p2, "float32")
    assert tfr.fused_bottleneck2_fwd.launches == before   # CPU: no kernel
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("matmul_dtype", ["bfloat16"], indirect=True)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_coupled_pair_matches_jax_bf16(matmul_dtype, x_dtype):
    x, p1, p2 = _pair_args(x_dtype, N=2, H=8, W=8, C4=64, C=16)
    want = _pair_jax(x, p1, p2, x_dtype)
    got = _pair_port(x, p1, p2, x_dtype)
    ulp = 2.0 ** -8 * np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= 4 * ulp


def test_coupled_pair_is_two_chained_blocks():
    """f32 operands: the pair equals two `fused_bottleneck_fwd_ref` calls
    (the coupling changes no rounding when nothing is rounded)."""
    x, p1, p2 = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                 else [torch.from_numpy(t) for t in a]
                 for a in _pair_args())
    old = tfr.MATMUL_DTYPE
    tfr.MATMUL_DTYPE = torch.float32
    try:
        y1 = tfr.fused_bottleneck_fwd_ref(x, *p1)[0]
        y2 = tfr.fused_bottleneck_fwd_ref(y1, *p2)[0]
        pair = tfr.fused_bottleneck2_fwd(x, p1, p2)
    finally:
        tfr.MATMUL_DTYPE = old
    torch.testing.assert_close(pair, y2, atol=1e-6, rtol=1e-6)
