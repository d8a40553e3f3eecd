"""Port parity of the vision model zoo on the CPU — the Vision
Transformer (`vit_tiny`: 32 px, patches of 8, width 64, 2 layers, 4
heads), LeNet, AlexNet, VGG, MobileNetV1 / V2 and SqueezeNet — and of
the layers they are built from (`nn.Sequential`, `LayerList`,
`ParameterList`, `LayerDict`, `Linear`, `Silu`, `ReLU6`, `GELU`), against
the JAX package on the same numpy inputs and weights
(`convert.load_jax_state`).

Tolerances (f32; sums in another order on each side): the ViT logits
1e-5 abs and its loss 1e-5 relative, every gradient normwise 1e-4; each
CNN's eval-mode logits normwise 1e-5; the activations 1e-6 abs.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import _is_linear_weight, load_jax_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as tmodels


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float32)


def _named(jm):
    return {k: _np(v) for k, v in jm.state_dict().items()}


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pair(name, **kw):
    paddle.seed(0)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    load_jax_state(tm, _named(jm))
    return jm, tm


# ------------------------------------------------------------------ layers

def test_containers_name_children_as_the_jax_ones():
    paddle.seed(0)
    jseq = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(),
                          jnn.Sequential(jnn.Linear(4, 2)))
    tseq = tnn.Sequential(tnn.Linear(3, 4, device="cpu"), tnn.ReLU(),
                          tnn.Sequential(tnn.Linear(4, 2, device="cpu")))
    assert set(_named(jseq)) == {n for n, _ in tseq.named_parameters()}
    load_jax_state(tseq, _named(jseq))
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = _np(jseq(paddle.to_tensor(x)))
    np.testing.assert_allclose(tseq(torch.from_numpy(x)).detach().numpy(),
                               ref, atol=1e-6)
    assert len(tseq) == 3 and isinstance(tseq[0:2], tnn.Sequential)
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.Silu()))
    assert list(dict(named.named_children())) == ["a", "b"]
    ll = tnn.LayerList([tnn.ReLU(), tnn.Silu()])
    ll.insert(0, tnn.GELU())
    assert [type(m).__name__ for m in ll] == ["GELU", "ReLU", "Silu"]
    assert list(dict(ll.named_children())) == ["0", "1", "2"]
    assert isinstance(ll[1:], tnn.LayerList) and len(ll[1:]) == 2
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    ld = tnn.LayerDict({"x": tnn.ReLU()}).update([("y", tnn.Silu())])
    assert list(ld.keys()) == ["x", "y"] and "y" in ld


@pytest.mark.parametrize("name", ["Silu", "ReLU6", "GELU", "ReLU"])
def test_activation_layers_match_jax(name):
    x = np.linspace(-8, 8, 101).astype(np.float32)
    ref = _np(getattr(jnn, name)()(paddle.to_tensor(x)))
    got = getattr(tnn, name)()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_linear_initialisation_is_paddles():
    g = torch.Generator().manual_seed(0)
    lin = tnn.Linear(300, 100, device="cpu", generator=g)
    bound = np.sqrt(6.0 / 400)
    w = lin.weight.detach().numpy()
    assert w.shape == (100, 300) and np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.95 * bound
    assert not lin.bias.detach().numpy().any()
    assert tnn.Linear(3, 2, bias_attr=False, device="cpu").bias is None
    again = tnn.Linear(300, 100, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, lin.weight)


# ------------------------------------------------------------------ ViT

def _port_grads(tm):
    """The port's gradients in the JAX layouts."""
    out = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        out[n] = g.T if _is_linear_weight(n, g) else g
    return out


def test_vit_forward_and_every_gradient_match_jax():
    jm, tm = _pair("vit_tiny")
    rng = np.random.RandomState(0)
    x = rng.randn(3, 3, 32, 32).astype(np.float32)
    y = np.array([1, 7, 3], np.int64)
    with jax.default_matmul_precision("highest"):
        jlogits = jm(paddle.to_tensor(x))
        jloss = paddle.nn.functional.cross_entropy(
            jlogits, paddle.to_tensor(y)).mean()
        jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters() if p.grad is not None}
    tlogits = tm(torch.from_numpy(x))
    assert tuple(tlogits.shape) == (3, 10)
    np.testing.assert_allclose(tlogits.detach().numpy(), _np(jlogits),
                               atol=1e-5)
    tloss = TF.cross_entropy(tlogits, torch.from_numpy(y)).mean()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tloss.backward()
    tgrads = _port_grads(tm)
    assert set(tgrads) == set(jgrads)
    errs = {n: _normwise(tgrads[n], g) for n, g in jgrads.items()}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                               key=lambda x: -x[1])[:3]


def test_vit_class_token_and_position_table_are_truncated_normal():
    m = tmodels.vit_tiny(device="cpu", seed=3)
    pos = m.pos_embed.detach().numpy()
    assert pos.shape == (1, 17, 64) and m.cls_token.shape == (1, 1, 64)
    assert np.abs(pos).max() <= 0.04 and 0.015 < pos.std() < 0.02
    again = tmodels.vit_tiny(device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                  again.parameters()))


def test_train_flops_per_image_counts_the_products():
    """ViT-B/16 at 224 px: 17.56 G multiply-adds a forward (the published
    count), so 105.4 GFLOP a trained image; PP-YOLOE-s at 640 px and
    ResNet-50 at 224 px through the same entry point."""
    vit = tmodels.vit_b_16(device="cpu")
    f = tmodels.train_flops_per_image(vit, 224)
    assert abs(f / 6 - 17.56e9) < 0.01e9
    # one block by hand: four Linears on 197 tokens, attention 4 S^2 D
    s, d = 197, 768
    block = 2 * s * d * (3 * d + d + 4 * d + 4 * d) + 4 * s * s * d
    patch = 2 * 16 * 16 * 3 * d * 196
    assert f == 3 * (patch + 12 * block + 2 * d * 1000)
    det = tmodels.ppyoloe_s(device="cpu")
    assert 35e9 < tmodels.train_flops_per_image(det, 640) < 45e9
    assert abs(tmodels.train_flops_per_image(tmodels.resnet50(device="cpu"),
                                             224) - 24.54e9) < 0.01e9
    with pytest.raises(TypeError):
        tmodels.train_flops_per_image(tmodels.LeNet(device="cpu"), 28)


# ------------------------------------------------------------------ CNNs

CNNS = [
    ("LeNet", dict(num_classes=10), (2, 1, 28, 28)),
    ("alexnet", dict(num_classes=10), (2, 3, 64, 64)),
    ("vgg11", dict(num_classes=10), (1, 3, 32, 32)),
    ("vgg11", dict(num_classes=10, batch_norm=True), (1, 3, 32, 32)),
    ("mobilenet_v1", dict(scale=0.25, num_classes=10), (2, 3, 32, 32)),
    ("mobilenet_v2", dict(scale=0.25, num_classes=10), (2, 3, 32, 32)),
    ("squeezenet1_0", dict(num_classes=10), (2, 3, 64, 64)),
    ("squeezenet1_1", dict(num_classes=10), (2, 3, 64, 64)),
]


@pytest.mark.parametrize("name,kw,shape", CNNS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(CNNS)])
def test_cnn_eval_forward_matches_jax(name, kw, shape):
    jm, tm = _pair(name, **kw)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = _np(jm(paddle.to_tensor(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (shape[0], 10)
    assert _normwise(got, ref) <= 1e-5


def test_vision_exports_match_the_jax_package():
    from paddle_tpu import vision as jvision

    import paddle_tpu_torch.vision as tvision

    ported = ("LeNet", "AlexNet", "VGG", "ResNet", "MobileNetV1",
              "MobileNetV2", "SqueezeNet", "PPYOLOE", "VisionTransformer",
              "resnet50", "vgg16", "ppyoloe_s", "vit_b_16", "vit_l_16",
              "vit_s_16", "vit_tiny", "squeezenet1_1", "mobilenet_v2",
              "wide_resnet50_2")
    for name in ported:
        assert hasattr(jmodels, name) and hasattr(tmodels, name), name
    # every model the JAX package exports, in vision.models and vision
    import types

    from paddle_tpu.vision import ops as jops

    exported = [n for n in dir(jmodels) if not n.startswith("_")
                and not isinstance(getattr(jmodels, n), types.ModuleType)]
    assert len(exported) >= 60
    for name in exported:
        assert hasattr(tmodels, name) and hasattr(tvision, name), name
        assert name in tmodels.__all__, name
    # and every op of vision.ops
    ops = [n for n in dir(jops) if not n.startswith("_") and callable(
        getattr(jops, n)) and getattr(getattr(jops, n), "__module__",
                                      "") == jops.__name__]
    assert {"roi_align", "matrix_nms", "DeformConv2D"} <= set(ops)
    for name in ops:
        assert hasattr(tvision.ops, name) and name in tvision.ops.__all__, \
            name
    for name in jvision.__all__ if hasattr(jvision, "__all__") else ():
        assert hasattr(tvision, name), name
    assert tmodels.resnet50 is __import__(
        "paddle_tpu_torch.models", fromlist=["resnet50"]).resnet50
    assert tvision.ops.nms is not None
