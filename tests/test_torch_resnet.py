"""Port parity of the ResNet training path on the CPU, against the JAX
package on the same numpy inputs and weights (`convert.load_jax_state`).

Tolerances, with their reasons:
* `conv2d`, `max_pool2d`, `adaptive_avg_pool2d`, `batch_norm` (f32): 1e-5
  abs (f32 sums in another order);
* `BottleneckBlock(64, 16, data_format="NHWC")` at [2, 8, 8, 64], each
  mode ("0", "force") against JAX in the same mode (tests/
  test_fused_resblock.py's case): the output 1e-5 abs, the loss 1e-5
  relative, bn1's running mean 1e-5 abs and conv2's gradient 1e-4 of its
  max, f32 (in "force" the bf16 operands are the same on both sides,
  but the f32 sums of their products are taken in another order, so a
  bf16 rounding of r1 or r2 can land one ulp apart: conv2's gradient
  2e-2 of its max there; reading 5.2e-4);
* the tiny `ResNet(BottleneckBlock, [2, 1, 1, 1], num_classes=10)` at 32
  px: eval-mode logits 1e-4 abs in NHWC and NCHW (f32), train-mode
  logits normwise 1e-3 (see the test);
* 3 steps through `parallelize` (Momentum lr 1e-4, 0.9; B = 8, since at
  B = 2 layer4's BNs see two values a channel and the loss is so steep
  that f32 rounding alone moves step 2's loss by 5 %) against the JAX
  engine, once per mode and compute dtype, with the readings of the
  run that set them:
  - "0", f32: losses 1e-4 relative (reading 5.5e-5), parameters
    normwise 1e-5 (2.5e-7), running stats normwise 1e-4 (1.0e-5);
  - "force", f32: the fused block multiplies bf16 operands on both
    sides, summed in another order: losses 5e-2 (1.9e-2), parameters
    5e-4 (5.3e-5), running stats 5e-2 (6.6e-3);
  - bf16 compute, either mode: the first loss within 2 bf16 ulps
    relative (at most 2^-6; reading 1.2e-2), then 2.5e-1 (reading
    1.6e-1: the JAX BN takes its statistics and normalises in bf16, the
    port's in f32 on bf16 data, and the port's trajectory is the one
    nearer the f32 run), parameters
    5e-3 (2.8e-4), running stats 1e-1 (4.0e-2).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu.models import resnet as jres
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.convert import load_jax_state, state_to_jax
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float32)


def _named(jm):
    return {k: _np(v) for k, v in jm.state_dict().items()}


@pytest.fixture
def fused_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("PADDLE_TPU_FUSED_RESBLOCK", mode)
    return set_mode


@pytest.fixture(autouse=True)
def _restore_global_mesh():
    """`dist.parallelize(mesh=...)` installs its mesh as the process-wide
    hybrid group; put the previous one back for later files."""
    prev = dist.get_hybrid_communicate_group()
    yield
    dist.set_hybrid_communicate_group(prev)


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,padding,groups", [
    (1, 1, 1), (2, 3, 1), (2, [1, 2, 0, 1], 1), (1, "SAME", 2)])
def test_conv2d_matches_jax(data_format, stride, padding, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 9).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                        paddle.to_tensor(b), stride, padding, 1, groups,
                        data_format)
    got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride, padding, 1, groups,
                    data_format)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_train_and_inference_match_jax(data_format):
    rng = np.random.RandomState(1)
    shape = (4, 3, 5, 5) if data_format == "NCHW" else (4, 5, 5, 3)
    xs = [rng.randn(*shape).astype(np.float32) * 2 + 1 for _ in range(2)]
    w, b = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    jm, jv = paddle.to_tensor(np.zeros(3, np.float32)), paddle.to_tensor(
        np.ones(3, np.float32))
    tm, tv = torch.zeros(3), torch.ones(3)
    for x in xs:        # two training calls: the running blend twice
        ref = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                            paddle.to_tensor(b), training=True,
                            data_format=data_format)
        got = TF.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                            torch.from_numpy(b), training=True,
                            data_format=data_format)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-5)
    ref = JF.batch_norm(paddle.to_tensor(xs[0]), jm, jv, paddle.to_tensor(w),
                        paddle.to_tensor(b), training=False,
                        data_format=data_format)
    got = TF.batch_norm(torch.from_numpy(xs[0]), tm, tv, torch.from_numpy(w),
                        torch.from_numpy(b), training=False,
                        data_format=data_format)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)


def test_batch_norm_takes_bf16_data_with_f32_buffers():
    """Under a bf16 compute dtype gamma and beta arrive in bf16 and the
    running buffers stay f32: the result is bf16, the buffers f32."""
    x = torch.randn(2, 4, 4, 3).to(torch.bfloat16)
    rm, rv = torch.zeros(3), torch.ones(3)
    w = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    out = TF.batch_norm(x, rm, rv, w, torch.zeros(3, dtype=torch.bfloat16),
                        training=True, data_format="NHWC")
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and rm.dtype == torch.float32
    assert w.grad.dtype == torch.bfloat16 and rm.abs().sum() > 0


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_pooling_matches_jax(data_format):
    x = np.random.RandomState(2).randn(2, 3, 9, 7).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = JF.max_pool2d(paddle.to_tensor(x), 3, 2, 1,
                        data_format=data_format)
    got = TF.max_pool2d(torch.from_numpy(x), 3, 2, 1,
                        data_format=data_format)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    for size in ((1, 1), (3, 3), (2, 4)):
        ref = JF.adaptive_avg_pool2d(paddle.to_tensor(x), size,
                                     data_format=data_format)
        got = TF.adaptive_avg_pool2d(torch.from_numpy(x), size,
                                     data_format=data_format)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)


def test_momentum_update_matches_jax():
    """Three Momentum steps on given gradients against the JAX package's
    `Momentum._update_one`, with weight decay (a number and an object with
    `coeff`) and Nesterov: f32 to 1e-6."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]

    class L2:
        coeff = 0.2

    for nesterov in (False, True):
        for wd in (0.05, L2()):
            jopt = paddle.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
                weight_decay=wd,
                parameters=paddle.nn.Linear(2, 2).parameters())
            jp, state = jnp.asarray(p0), {"velocity": jnp.zeros(64)}
            tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
            topt = Momentum(learning_rate=0.1, momentum=0.9,
                            use_nesterov=nesterov, weight_decay=wd,
                            parameters=[tp])
            for t, g in enumerate(grads, start=1):
                jp, state = jopt._update_one(jp, jnp.asarray(g), state,
                                             jnp.asarray(0.1, jnp.float32),
                                             jnp.asarray(t, jnp.int32))
                tp.grad = torch.from_numpy(g)
                topt.step()
                np.testing.assert_allclose(tp.detach().numpy(),
                                           np.asarray(jp), rtol=1e-6,
                                           atol=1e-6)


# ------------------------------------------------------------------ blocks

def _block_run(pkg, mode, x_np, fused_mode, init=None):
    fused_mode(mode)
    if pkg == "jax":
        paddle.seed(0)
        blk = jres.BottleneckBlock(64, 16, data_format="NHWC")
        blk.train()
        with jax.default_matmul_precision("highest"):
            y = blk(paddle.to_tensor(x_np))
            loss = (y * y).mean()
            loss.backward()
        return (float(loss.numpy()), _np(blk.bn1._mean),
                _np(blk.conv2.weight.grad), _np(y))
    blk = tres.BottleneckBlock(64, 16, data_format="NHWC")
    load_jax_state(blk, init)
    blk.train()
    y = blk(torch.from_numpy(x_np))
    loss = (y * y).mean()
    loss.backward()
    return (float(loss.detach()), blk.bn1._mean.numpy(),
            blk.conv2.weight.grad.numpy(), y.detach().numpy())


@pytest.mark.parametrize("mode", ["0", "force"])
def test_bottleneck_block_matches_jax_in_each_mode(mode, fused_mode):
    x_np = np.random.RandomState(0).randn(2, 8, 8, 64).astype("float32")
    jl, jmean, jgrad, jy = _block_run("jax", mode, x_np, fused_mode)
    fused_mode("0")
    paddle.seed(0)
    init = _named(jres.BottleneckBlock(64, 16, data_format="NHWC"))
    tl, tmean, tgrad, ty = _block_run("port", mode, x_np, fused_mode, init)
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    np.testing.assert_allclose(tmean, jmean, atol=1e-5)
    tol = 1e-4 if mode == "0" else 2e-2
    assert np.max(np.abs(tgrad - jgrad)) <= tol * np.max(np.abs(jgrad))


def test_can_fuse_cases(fused_mode):
    blk = tres.BottleneckBlock(64, 16, data_format="NHWC")
    x32, x16 = torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 4, 64,
                                                     dtype=torch.bfloat16)
    fused_mode("0")
    assert not blk._can_fuse(x16)
    fused_mode("force")
    assert blk._can_fuse(x32) and blk._can_fuse()
    blk.eval()
    assert not blk._can_fuse(x32)                 # eval: running stats
    blk.train()
    blk.bn2.eval()
    assert not blk._can_fuse(x32)                 # one frozen BN
    blk.bn2.train()
    blk.bn3._use_global_stats = True
    assert not blk._can_fuse(x32)
    fused_mode("1")                               # bf16 CUDA inputs only
    blk.bn3._use_global_stats = None
    assert not blk._can_fuse(x32) and not blk._can_fuse(x16)
    fused_mode("force")
    for other in (tres.BottleneckBlock(64, 16, stride=2, data_format="NHWC"),
                  tres.BottleneckBlock(64, 16, data_format="NCHW"),
                  tres.BottleneckBlock(32, 16, data_format="NHWC",
                                       downsample=torch.nn.Identity())):
        assert not other._can_fuse(x32)


# ------------------------------------------------------------------ model

def _tiny(pkg, data_format, device="cpu"):
    if pkg == "jax":
        paddle.seed(0)
        return jres.ResNet(jres.BottleneckBlock, [2, 1, 1, 1],
                           num_classes=10, data_format=data_format)
    return tres.ResNet(tres.BottleneckBlock, [2, 1, 1, 1], num_classes=10,
                       data_format=data_format, device=device)


def _images(data_format, b=2, size=32):
    x = np.random.RandomState(4).randn(b, 3, size, size).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, np.random.RandomState(5).randint(0, 10, (b,)).astype(np.int64)


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_tiny_resnet_logits_match_jax(data_format):
    jm = _tiny("jax", data_format)
    jm.eval()
    tm = _tiny("port", data_format)
    load_jax_state(tm, _named(jm))
    tm.eval()
    x, _ = _images(data_format)
    with jax.default_matmul_precision("highest"):
        ref = _np(jm(paddle.to_tensor(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the train-mode forward (batch statistics) too: layer4's BNs see
    # n = 2 values a channel (B = 2 at 1 x 1), so (x - mean) / std is
    # +-1 divided by a std of two nearby values, which magnifies f32
    # rounding: normwise 1e-3 (reading 1.9e-4)
    jm.train()
    tm.train()
    with jax.default_matmul_precision("highest"):
        ref = _np(jm(paddle.to_tensor(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)


STEPS, LR, TRAIN_B = 3, 1e-4, 8
# (loss after the first step, loss, parameters, running stats) by
# (compute dtype, mode); see the module docstring
TRAIN_TOL = {(None, "0"): (1e-4, 1e-4, 1e-5, 1e-4),
             (None, "force"): (5e-2, 5e-2, 5e-4, 5e-2),
             ("bfloat16", "0"): (2 ** -6, 2.5e-1, 5e-3, 1e-1),
             ("bfloat16", "force"): (2 ** -6, 2.5e-1, 5e-3, 1e-1)}


def _loss_jax(m, x, y):
    return paddle.nn.functional.cross_entropy(m(x), y).mean()


def _loss_port(m, x, y):
    return TF.cross_entropy(m(x), y).mean()


def _train_jax(compute_dtype, x, y):
    jm = _tiny("jax", "NHWC")
    init = _named(jm)
    opt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                    parameters=jm.parameters())
    with jax.default_matmul_precision("highest"):
        eng = dist.parallelize(
            jm, opt, loss_fn=_loss_jax,
            mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]),
            compute_dtype=compute_dtype)
        losses = [float(eng.train_batch(paddle.to_tensor(x),
                                        paddle.to_tensor(y)))
                  for _ in range(STEPS)]
    return init, losses, _named(jm)


@pytest.mark.parametrize("mode", ["0", "force"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_tiny_resnet_trains_like_the_jax_engine(compute_dtype, mode,
                                                fused_mode, monkeypatch,
                                                tmp_path):
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    fused_mode(mode)
    x, y = _images("NHWC", b=TRAIN_B)
    init, jl, jparams = _train_jax(compute_dtype, x, y)
    tm = _tiny("port", "NHWC")
    load_jax_state(tm, init)
    eng = parallelize(tm, Momentum(learning_rate=LR, momentum=0.9,
                                   parameters=tm.parameters()),
                      loss_fn=_loss_port, compute_dtype=compute_dtype)
    tl = [float(eng.train_batch(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(STEPS)]
    tparams = state_to_jax(tm)
    first_tol, loss_tol, param_tol, stat_tol = TRAIN_TOL[compute_dtype,
                                                         mode]
    assert abs(tl[0] - jl[0]) <= first_tol * abs(jl[0])
    np.testing.assert_allclose(tl, jl, rtol=loss_tol)
    assert tl[-1] < tl[0]
    assert set(tparams) == set(jparams)
    stats = [n for n in jparams if n.endswith(("._mean", "._variance"))]
    params = sorted(set(jparams) - set(stats))
    for names, tol in ((params, param_tol), (stats, stat_tol)):
        got, ref = (np.concatenate([p[n].ravel() for n in names])
                    for p in (tparams, jparams))
        assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref)
    # the running stats moved, once a step, on the f32 buffers
    assert not np.allclose(tparams["layer1.1.bn1._mean"], 0.0)
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    # eval_batch on the model in eval mode takes the running statistics
    tm.eval()
    ev = float(eng.eval_batch(torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite(ev)


def test_resnet_state_round_trips_through_convert():
    jm = _tiny("jax", "NHWC")
    named = _named(jm)
    tm = _tiny("port", "NHWC")
    load_jax_state(tm, named)
    back = state_to_jax(tm)
    assert set(back) == set(named)
    for n, a in named.items():
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    assert tm.fc.weight.shape == (10, 2048)                 # [out, in]
    assert tm.conv1.weight.shape == named["conv1.weight"].shape   # OIHW
    assert tm.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_flops_count_of_resnet50():
    m = tres.resnet50(device="cpu")
    # 4.09 G multiply-adds a 224 px image, forward (the published figure
    # is 4.1 G), x 2 FLOPs x 3 for training
    assert abs(tres.train_flops_per_image(m, 224) / 6 / 4.0892e9 - 1) < 1e-4
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
