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


# ---------------------- the kernels' tiles, row chunks and operands (CUDA)

# ResNet-50's identity blocks at N = 128: (H = W, C)
STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))


@pytest.mark.parametrize("H,C", STAGES)
def test_weight_gradient_chunks_are_a_pure_function_of_the_shape(H, C):
    """`_splits` cuts the rows into chunks of a multiple of 64 rows and at
    least 256 (unless M is smaller), covering M exactly once, the same
    cut on every call (the reduction order of the partial sums is fixed),
    and enough of them to give the card about `_TARGET_CTAS` CTAs (less
    what rounding the chunks up to 64 rows takes)."""
    M = 128 * H * H
    for K, N, conv in ((C, 4 * C, False), (9 * C, C, True),
                       (4 * C, C, False)):
        tiles = tfr._wgrad_tiles(K, N, conv)
        splits, rows = tfr._splits(M, tiles)
        assert (splits, rows) == tfr._splits(M, tiles)
        assert rows % tfr._CHUNK == 0 and rows >= 256
        assert (splits - 1) * rows < M <= splits * rows
        assert tiles * splits >= 0.9 * min(tfr._TARGET_CTAS,
                                           tiles * (M // 256))


@pytest.mark.parametrize("M", [1, 63, 96, 255, 257, 1000, 6272])
def test_weight_gradient_chunks_cover_small_and_ragged_m(M):
    for tiles in (1, 3, 64, 600):
        splits, rows = tfr._splits(M, tiles)
        assert splits >= 1 and rows % 64 == 0
        assert (splits - 1) * rows < M <= splits * rows


def test_weight_gradient_tiles_follow_the_kernel_grid():
    """The 3x3 gradient: 3 kernel rows x ceil(C / 64) input-channel
    tiles, the 1x1 ones ceil(K / 128) tiles of K; x output tiles 128 wide
    where N > 64."""
    assert tfr._wgrad_tiles(9 * 64, 64, True) == 3
    assert tfr._wgrad_tiles(9 * 512, 512, True) == 3 * 8 * 4
    assert tfr._wgrad_tiles(9 * 8, 8, True) == 3
    assert tfr._wgrad_tiles(64, 256, False) == 1 * 2
    assert tfr._wgrad_tiles(2048, 512, False) == 16 * 4
    assert tfr._wgrad_tiles(16, 8, False) == 1


@pytest.mark.parametrize("M", [96, 128, 129, 401408])
def test_backward_sums_have_a_row_per_128_row_tile(M):
    """The per-tile BN sums: one [2, N] row per 128-row tile of the Hopper
    row products, in both directions (the forward's products run on the
    backward's bodies)."""
    L = tfr._Launcher.__new__(tfr._Launcher)
    L.M, L.dev = M, torch.device("cpu")
    assert L.sums(8, tfr._TILE_ROWS).shape == (-(-M // 128), 2, 8)
    assert L.sums(8).shape == (-(-M // 128), 2, 8)


@pytest.mark.parametrize("M", [63, 64, 96, 6272, 401408])
def test_pair_sums_have_a_row_per_64_row_tile(M):
    """The coupled kernel's per-tile sums of block 2's r1: one [2, C] row
    per 64-row tile (`_K41_ROWS`, the C entry's `ptt_resblock_k41_rows`),
    so ResNet-50's layer4 (M = 6272) has 98 of them."""
    L = tfr._Launcher.__new__(tfr._Launcher)
    L.M, L.dev = M, torch.device("cpu")
    assert tfr._K41_ROWS == 64
    assert L.sums(8, tfr._K41_ROWS).shape == (-(-M // 64), 2, 8)


# ------------------------------- the forward's B operands (the wrapper's)

@pytest.mark.parametrize("C", [8, 16, 64])
def test_forward_weight_operands_are_the_plain_weights(C):
    """`_fwd_weights` hands the products their weights as [N, K] (K-major,
    as TMA reads them): w1 and w3 transposed, element for element; the
    3x3's [C, 9 C] operand, cut back into taps, is w2[di + 1, dj + 1] in
    `_conv3x3`'s tap order (the JAX `_conv3x3_flat`'s: di, dj = -1, 0, 1,
    then input channels)."""
    _, w1, w2, w3 = (torch.from_numpy(a) for a in _args(C4=4 * C, C=C)[:4])
    w1t, w2t, w3t = tfr._fwd_weights(w1, w2, w3)
    assert w1t.shape == (C, 4 * C) and w3t.shape == (4 * C, C)
    assert torch.equal(w1t.t(), w1) and torch.equal(w3t.t(), w3)
    assert w2t.shape == (C, 9 * C) and w2t.is_contiguous()
    taps = w2t.t().reshape(9, C, C)
    for i, ((di, dj), _) in enumerate(tfr._taps(torch.zeros(1, C), 1, 1,
                                                 1)):
        assert torch.equal(taps[i], w2[di + 1, dj + 1]), (di, dj)


def test_forward_conv_operand_computes_the_conv():
    """A plain product through the 3x3's operand — the nine shifted views
    side by side, K = tap * C + c — equals `_conv3x3` within f32 rounding
    (the sum over 9 C in one product, not tap by tap)."""
    N, H, W, C = 2, 5, 6, 16
    rng = np.random.RandomState(3)
    f = torch.from_numpy(rng.randn(N * H * W, C).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(3, 3, C, C).astype(np.float32) * 0.1)
    old = tfr.MATMUL_DTYPE
    tfr.MATMUL_DTYPE = torch.float32
    try:
        want = tfr._conv3x3(f, w2, N, H, W)
    finally:
        tfr.MATMUL_DTYPE = old
    _, w2t, _ = tfr._fwd_weights(torch.zeros(4 * C, C), w2,
                                 torch.zeros(C, 4 * C))
    a = torch.cat([g for _, g in tfr._taps(f, N, H, W)], dim=1)
    torch.testing.assert_close(a @ w2t.t(), want, atol=1e-5, rtol=1e-5)


def test_forward_launch_names_and_bodies():
    """`FWD_PRODUCTS` names the forward's eight launches; every product
    kind maps to a Hopper body, the coupled kind to its own, the wgmma
    kernel rb_wg_k41; every body the wrappers count by has a name."""
    assert tfr.FWD_PRODUCTS == ("F1", "bn1", "F2", "bn2", "form a2", "F3",
                                "bn3", "F4")
    hopper = {tfr.ROUTE_ROWS, tfr.ROUTE_CONV, tfr.ROUTE_WGRAD}
    for kind in (tfr._F1, tfr._F2, tfr._F3, tfr._F4):
        assert tfr._BODY[kind] in hopper
    assert tfr._BODY[tfr._F2] == tfr.ROUTE_CONV
    assert tfr._BODY[tfr._F41] == tfr.ROUTE_K41
    assert tfr.ROUTE_NAMES[tfr.ROUTE_K41].startswith("rb_wg_k41 ")
    assert tfr._BODY[tfr._FA] == tfr.ROUTE_FORM
    for f in (tfr.fused_bottleneck_fwd, tfr.fused_bottleneck_bwd,
              tfr.fused_bottleneck2_fwd):
        assert set(f.routes) == set(tfr.ROUTE_NAMES)


def test_cpu_calls_count_no_route():
    """A CPU call takes the plain versions: no body's count moves."""
    args = [torch.from_numpy(a) for a in _args()]
    before = [dict(f.routes) for f in (tfr.fused_bottleneck_fwd,
                                       tfr.fused_bottleneck_bwd,
                                       tfr.fused_bottleneck2_fwd)]
    y, res, _ = tfr.fused_bottleneck_fwd(*args)
    tfr.fused_bottleneck_bwd(res, torch.ones_like(y))
    tfr.fused_bottleneck2_fwd(args[0], args[1:], args[1:])
    assert [dict(f.routes) for f in (tfr.fused_bottleneck_fwd,
                                     tfr.fused_bottleneck_bwd,
                                     tfr.fused_bottleneck2_fwd)] == before
