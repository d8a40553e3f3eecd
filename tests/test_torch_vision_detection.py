"""Port parity of the detection slice on the CPU — PP-YOLOE (BASELINE
config 3's model) and `vision.ops.nms` / `box_iou` — against the JAX
package on the same numpy inputs and weights (`convert.load_jax_state`),
at toy size: width 0.25, 64 px, 4 classes, tests/test_detection.py's
images and boxes.

Tolerances, with their reasons (f32 throughout; the sums run in another
order on each side):
* the forward, per level: normwise 1e-5;
* `loss`: 1e-5 relative; every gradient normwise 1e-4, in NCHW and NHWC;
* one `parallelize` Momentum step against the JAX engine's: the loss
  1e-5 relative, the parameters normwise 1e-5;
* `postprocess`: boxes 1e-5 (relative to the image size), scores 1e-5,
  labels and counts equal;
* `nms`: indices equal, with planted score ties (a stable order) and
  IoU exactly at the threshold (strict ``>``); `box_iou` 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu.vision import ops as jops
from paddle_tpu.vision.models import yolo as jyolo

from paddle_tpu_torch.convert import load_jax_state, state_to_jax
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import ops as tops
from paddle_tpu_torch.vision.models import yolo as tyolo

SIZE = 64


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float32)


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _named(jm):
    return {k: _np(v) for k, v in jm.state_dict().items()}


@pytest.fixture(autouse=True)
def _restore_global_mesh():
    """`dist.parallelize(mesh=...)` installs its mesh as the process-wide
    hybrid group; put the previous one back for later files."""
    prev = dist.get_hybrid_communicate_group()
    yield
    dist.set_hybrid_communicate_group(prev)


def _pair(data_format="NCHW", num_classes=4):
    paddle.seed(0)
    jm = jyolo.PPYOLOE(num_classes=num_classes, width=0.25, depth=1,
                       max_boxes=4, data_format=data_format)
    tm = tyolo.PPYOLOE(num_classes=num_classes, width=0.25, depth=1,
                       max_boxes=4, data_format=data_format, device="cpu")
    load_jax_state(tm, _named(jm))
    return jm, tm


def _sample(n=2, size=SIZE, seed=0):
    """tests/test_detection.py's inputs: images with one bright square
    each, the gt that square."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, 3, size, size).astype(np.float32) * 0.1
    boxes = np.zeros((n, 4, 4), np.float32)
    labels = np.zeros((n, 4), np.int64)
    mask = np.zeros((n, 4), np.float32)
    for i in range(n):
        x0, y0 = rng.randint(4, size // 2, 2)
        w, h = rng.randint(12, size // 2 - 2, 2)
        x1, y1 = min(x0 + w, size - 1), min(y0 + h, size - 1)
        imgs[i, :, y0:y1, x0:x1] += 0.9
        boxes[i, 0] = [x0, y0, x1, y1]
        labels[i, 0] = i % 4
        mask[i, 0] = 1.0
    return imgs, boxes, labels, mask


def _layout(imgs, data_format):
    return np.ascontiguousarray(imgs.transpose(0, 2, 3, 1)) \
        if data_format == "NHWC" else imgs


def _loss(m, img, gb, gl, gm):
    return m.loss(img, gb, gl, gm)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_forward_per_level_matches_jax(data_format):
    jm, tm = _pair(data_format)
    jm.eval()
    tm.eval()
    x = _layout(_sample()[0], data_format)
    with jax.default_matmul_precision("highest"):
        ref = jm(paddle.to_tensor(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == 3
    for (jc, jr), (tc, tr), s in zip(ref, got, (8, 16, 32)):
        hw = SIZE // s
        want = (2, 4, hw, hw) if data_format == "NCHW" else (2, hw, hw, 4)
        assert tuple(tc.shape) == tuple(tr.shape) == want
        for j, t in ((jc, tc), (jr, tr)):
            assert _normwise(t.numpy(), _np(j)) <= 1e-5


def _port_grads(tm):
    return {n: p.grad.numpy() for n, p in tm.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_loss_and_every_gradient_match_jax(data_format):
    jm, tm = _pair(data_format)
    imgs, boxes, labels, mask = _sample()
    x = _layout(imgs, data_format)
    with jax.default_matmul_precision("highest"):
        jloss = jm.loss(*(paddle.to_tensor(a) for a in (x, boxes, labels,
                                                        mask)))
        jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters() if p.grad is not None}
    tloss = tm.loss(*(torch.from_numpy(a) for a in (x, boxes, labels,
                                                    mask)))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tloss.backward()
    tgrads = _port_grads(tm)
    assert set(tgrads) == set(jgrads) == {n for n, _ in
                                          tm.named_parameters()}
    errs = {n: _normwise(tgrads[n], g) for n, g in jgrads.items()
            if np.linalg.norm(g) > 0}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                               key=lambda x: -x[1])[:3]


def test_nchw_and_nhwc_losses_agree():
    """The bench's channels-last layout reproduces the NCHW loss given the
    same weights (tests/test_detection.py's layout parity, on the port)."""
    _, t1 = _pair("NCHW")
    _, t2 = _pair("NHWC")
    imgs, boxes, labels, mask = (torch.from_numpy(a) for a in _sample())
    l1 = t1.loss(imgs, boxes, labels, mask)
    l2 = t2.loss(imgs.permute(0, 2, 3, 1).contiguous(), boxes, labels, mask)
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=1e-5)


def test_nhwc_heads_flatten_as_views():
    """NHWC: the heads' outputs are contiguous channels-last tensors and
    flatten to [B, H*W, C] without a copy."""
    _, tm = _pair("NHWC")
    outs = tm(torch.from_numpy(_layout(_sample()[0], "NHWC")))
    for cls, reg in outs:
        for t in (cls, reg):
            assert t.is_contiguous()
            flat = tm._flat(t)[0]
            assert flat.data_ptr() == t.data_ptr() and flat._base is not None


def test_giou_splits_the_gradient_of_a_tie_as_jax_does():
    """A predicted box whose left edge equals the target's: the maxima and
    minima of the GIoU tie, and `jnp.maximum` sends half the gradient
    each way; the port builds `_giou` from `torch.maximum` / `minimum`,
    which do the same (`torch.clamp` would not)."""
    a = np.array([[10.0, 10.0, 30.0, 25.0], [5.0, 5.0, 5.0, 9.0]],
                 np.float32)
    b = np.array([[10.0, 12.0, 28.0, 25.0], [5.0, 5.0, 8.0, 9.0]],
                 np.float32)
    ja = jax.numpy.asarray(a)
    jg = np.asarray(jax.grad(lambda x: jyolo._giou(x, b).sum())(ja))
    ta = torch.from_numpy(a).requires_grad_()
    tyolo._giou(ta, torch.from_numpy(b)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), jg, atol=1e-6)
    np.testing.assert_allclose(tyolo._giou(ta, torch.from_numpy(b))
                               .detach().numpy(),
                               np.asarray(jyolo._giou(ja, b)), atol=1e-6)


def test_one_parallelize_momentum_step_matches_the_jax_engine(
        monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", str(tmp_path))
    jm, tm = _pair("NHWC")
    imgs, boxes, labels, mask = _sample()
    batch = (_layout(imgs, "NHWC"), boxes, labels, mask)
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=jm.parameters())
    with jax.default_matmul_precision("highest"):
        jeng = dist.parallelize(
            jm, opt, loss_fn=_loss,
            mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]))
        jl = float(jeng.train_batch(*(paddle.to_tensor(a) for a in batch)))
    teng = parallelize(tm, Momentum(learning_rate=0.01, momentum=0.9,
                                    parameters=tm.parameters()),
                       loss_fn=_loss)
    tl = float(teng.train_batch(*(torch.from_numpy(a) for a in batch)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jparams, tparams = _named(jm), state_to_jax(tm)
    assert set(jparams) == set(tparams)
    names = sorted(n for n in jparams
                   if not n.endswith(("._mean", "._variance")))
    got, ref = (np.concatenate([p[n].ravel() for n in names])
                for p in (tparams, jparams))
    assert _normwise(got, ref) <= 1e-5
    # the running statistics moved, on both sides alike
    assert not np.allclose(tparams["stem.1._mean"], 0.0)
    np.testing.assert_allclose(tparams["stem.1._mean"],
                               jparams["stem.1._mean"], atol=1e-5)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_postprocess_matches_jax(data_format):
    """With the class biases at 0 (scores near 0.5, so boxes pass the
    threshold and overlap) the two postprocesses keep the same boxes."""
    jm, tm = _pair(data_format)
    named = _named(jm)
    for i in range(3):
        named[f"heads.{i}.cls_pred.bias"] = np.zeros(4, np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in named.items()})
    load_jax_state(tm, named)
    jm.eval()
    tm.eval()
    x = _layout(_sample()[0], data_format)
    with jax.default_matmul_precision("highest"):
        ref = jm.postprocess(paddle.to_tensor(x), score_threshold=0.3,
                             nms_iou=0.6)
    got = tm.postprocess(torch.from_numpy(x), score_threshold=0.3,
                         nms_iou=0.6)
    assert len(got) == len(ref) == 2
    kept = 0
    for (tb, ts, tl), (jb, js, jl) in zip(got, ref):
        assert tb.shape == jb.shape and ts.shape == js.shape
        np.testing.assert_allclose(tb, jb, atol=1e-5 * SIZE)
        np.testing.assert_allclose(ts, js, atol=1e-5)
        assert tl.dtype == np.int64 and np.array_equal(tl, jl)
        kept += len(ts)
    assert kept > 2


# ------------------------------------------------------------------ ops

def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(1, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("iou_threshold", [0.1, 0.3, 0.6])
def test_nms_matches_jax_on_random_boxes_with_ties(seed, iou_threshold):
    rng = np.random.RandomState(seed)
    n = 40 + seed * 7
    b = _boxes(rng, n)
    # half the seeds draw scores from 5 values: many exact ties
    s = (rng.randint(0, 5, n) if seed % 2 else rng.rand(n)).astype(
        np.float32)
    ref = np.asarray(jops.nms(b, s, iou_threshold=iou_threshold).numpy())
    got = tops.nms(torch.from_numpy(b), torch.from_numpy(s),
                   iou_threshold=iou_threshold)
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nms_iou_exactly_at_the_threshold_keeps_the_box():
    """IoU 0.5 exactly (areas 100 and 50, the second inside the first):
    at threshold 0.5 both stay (strict >), below it the second goes."""
    b = np.array([[0, 0, 10, 10], [0, 0, 10, 5], [20, 20, 24, 24],
                  [20, 20, 24, 22]], np.float32)
    s = np.array([0.9, 0.8, 0.7, 0.7], np.float32)
    iou = tops.box_iou(torch.from_numpy(b), torch.from_numpy(b))
    assert float(iou[0, 1]) == 0.5 and float(iou[2, 3]) == 0.5
    for thr in (0.5, 0.49):
        ref = np.asarray(jops.nms(b, s, iou_threshold=thr).numpy())
        got = tops.nms(torch.from_numpy(b), torch.from_numpy(s),
                       iou_threshold=thr).numpy()
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tops.nms(torch.from_numpy(b), torch.from_numpy(s), 0.5).numpy(),
        [0, 1, 2, 3])
    np.testing.assert_array_equal(
        tops.nms(torch.from_numpy(b), torch.from_numpy(s), 0.49).numpy(),
        [0, 2, -1, -1])


def test_nms_default_scores_and_top_k_slice_the_padded_vector():
    rng = np.random.RandomState(7)
    b = _boxes(rng, 30)
    for top_k in (None, 3, 30):
        ref = np.asarray(jops.nms(b, None, 0.2, top_k=top_k).numpy())
        got = tops.nms(torch.from_numpy(b), None, 0.2, top_k=top_k).numpy()
        np.testing.assert_array_equal(got, ref)
    # every box overlapping the first: one kept, then -1s inside top_k
    same = np.tile(np.array([[0, 0, 10, 10]], np.float32), (6, 1))
    np.testing.assert_array_equal(
        tops.nms(torch.from_numpy(same), None, 0.5, top_k=3).numpy(),
        np.asarray(jops.nms(same, None, 0.5, top_k=3).numpy()))


def test_box_iou_matches_jax():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 9), _boxes(rng, 13)
    ref = _np(jops.box_iou(paddle.to_tensor(a), paddle.to_tensor(b)))
    got = tops.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (9, 13)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_numpy_inputs_go_to_the_gpu_unless_asked_for_the_cpu():
    b = _boxes(np.random.RandomState(0), 4)
    got = tops.nms(b, None, 0.5, device="cpu")
    assert got.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.nms(b, None, 0.5)
