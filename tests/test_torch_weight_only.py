"""Port parity: weight-only int8/int4 quantization and matmul
(`paddle_tpu_torch.nn.quant`, `paddle_tpu_torch.ops.weight_only`) against
the JAX package's `nn/quant.py` and its Pallas kernel run in interpret
mode. Inputs are made with numpy from a seed and fed to both sides; the
port runs on the CPU, where the wrapper computes the kernel's plain
version. The CUDA kernel itself is compared with that plain version in
tests/test_torch_cuda.py (and at full size by chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.nn import quant as jq
from paddle_tpu.ops.pallas.weight_only import weight_only_matmul as j_wom

from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import weight_only as tw

# f32 products summed in another order (XLA vs PyTorch CPU): 1e-5 relative
RTOL, ATOL = 1e-5, 1e-5


def _w(seed, k=256, n=256):
    return np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.05


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("group_size", [-1, 64])
def test_weight_quantize_byte_equal(algo, group_size):
    w = _w(0)
    jqw, jsc = jq.weight_quantize(jnp.asarray(w), algo,
                                  group_size=group_size)
    tqw, tsc = tq.weight_quantize(torch.from_numpy(w), algo,
                                  group_size=group_size)
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw.numpy()))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc.numpy()))


def test_pack_unpack_int4_byte_equal():
    q = np.random.RandomState(1).randint(-7, 8, (16, 64)).astype(np.int8)
    jp = np.asarray(jq._pack_int4(jnp.asarray(q)))
    tp = tq._pack_int4(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tq._unpack_int4(torch.from_numpy(tp))
                                  .numpy(), q)
    np.testing.assert_array_equal(
        tq._unpack_int4(torch.from_numpy(tp)).numpy(),
        np.asarray(jq._unpack_int4(jnp.asarray(jp))))


@pytest.mark.parametrize("wdt", ["int8", "int4"])
@pytest.mark.parametrize("m", [1, 5, 13])
def test_matmul_plain_matches_pallas_interpret(wdt, m):
    """m not a multiple of 8 included; k = 256 keeps the JAX kernel on
    its Pallas path (it needs a 128-multiple packed width)."""
    w = _w(2)
    qw, sc = jq.weight_quantize(jnp.asarray(w), f"weight_only_{wdt}")
    qw, sc = np.asarray(qw.numpy()), np.asarray(sc.numpy())
    x = np.random.RandomState(3 + m).randn(m, w.shape[0]).astype(np.float32)
    ref = j_wom(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc),
                interpret=True, weight_dtype=wdt)
    assert ref is not None            # the Pallas kernel really ran
    got = tw.weight_only_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                                torch.from_numpy(sc), wdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_grouped_scales_match_jax_fallback(wdt):
    w = _w(4)
    qw, sc = jq.weight_quantize(jnp.asarray(w), f"weight_only_{wdt}",
                                group_size=64)
    x = np.random.RandomState(5).randn(3, 7, w.shape[0]).astype(np.float32)
    ref = jq._wol_impl(jnp.asarray(x), qw._value, sc._value,
                       jnp.zeros((1,)), group_size=64, has_bias=False,
                       weight_dtype=wdt)
    got = tq.weight_only_linear(torch.from_numpy(x),
                                torch.from_numpy(np.asarray(qw.numpy())),
                                None, torch.from_numpy(np.asarray(sc.numpy())),
                                weight_dtype=wdt, group_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_weight_dequantize_matches(wdt):
    w = _w(6)
    qw, sc = jq.weight_quantize(jnp.asarray(w), f"weight_only_{wdt}")
    jd = np.asarray(jq.weight_dequantize(qw, sc, f"weight_only_{wdt}")
                    .numpy())
    td = tq.weight_dequantize(torch.from_numpy(np.asarray(qw.numpy())),
                              torch.from_numpy(np.asarray(sc.numpy())),
                              f"weight_only_{wdt}")
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-7)
    # round trip: within half a quantization step of the float weight
    step = np.asarray(sc.numpy())[None, :]
    assert np.all(np.abs(td.numpy() - w) <= step / 2 + 1e-7)


def test_weight_only_linear_layer_with_bias_matches_jax():
    from paddle_tpu import nn as jnn
    import paddle_tpu as paddle

    paddle.seed(3)
    jl = jnn.Linear(64, 32)
    jlq = jq.WeightOnlyLinear.from_linear(jl)
    tl = torch.nn.Linear(64, 32)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight.numpy()).T))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias.numpy())))
    tlq = tq.WeightOnlyLinear.from_linear(tl)
    np.testing.assert_array_equal(tlq.quant_weight.numpy(),
                                  np.asarray(jlq.quant_weight.numpy()))
    x = np.random.RandomState(7).randn(2, 3, 64).astype(np.float32)
    ref = np.asarray(jlq(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tlq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_quantize_for_inference_min_features():
    model = torch.nn.Sequential(torch.nn.Linear(64, 300),
                                torch.nn.Linear(300, 300))
    tq.quantize_for_inference(model, "int8")          # default 256
    assert isinstance(model[0], torch.nn.Linear)      # 64 < 256 stays
    assert isinstance(model[1], tq.WeightOnlyLinear)
    tq.quantize_for_inference(model, "int4", min_features=0)
    assert isinstance(model[0], tq.WeightOnlyLinear)


def test_cpu_dispatch_takes_plain_version_and_validates():
    w = _w(8, k=64, n=32)
    qw, sc = tq.weight_quantize(torch.from_numpy(w))
    x = torch.randn(4, 64)
    before = tw.weight_only_matmul.launches
    got = tw.weight_only_matmul(x, qw, sc)
    assert tw.weight_only_matmul.launches == before   # no kernel on CPU
    torch.testing.assert_close(got, tw.weight_only_matmul_ref(x, qw, sc))
    with pytest.raises(ValueError):
        tw.weight_only_matmul(x, qw, sc, "int4")      # width mismatch
    with pytest.raises(ValueError):
        tw.weight_only_matmul(x, qw, sc[:5])


# (n, k) of the llama2_7b serving path's Linears
LLAMA_LINEARS = {"qkv": (12288, 4096), "o_proj": (4096, 4096),
                 "gate_up": (22016, 4096), "down": (4096, 11008),
                 "lm_head": (32000, 4096)}


@pytest.mark.parametrize("layer", sorted(LLAMA_LINEARS))
def test_route_predicate_on_llama2_7b_linears(layer):
    """Every decode bucket (m = 1..16) of a bf16/f16 serving step takes the
    row-stable tensor-core GEMV, a prefill chunk the wgmma GEMM; f32 x and
    unaligned x take the CUDA-core GEMV at any m."""
    _, k = LLAMA_LINEARS[layer]
    for dt in (torch.bfloat16, torch.float16):
        for m in range(1, 17):
            assert tw.weight_only_route(m, k, dt) == tw.ROUTE_DECODE
        for m in (17, 100, 256, 300):
            assert tw.weight_only_route(m, k, dt) == tw.ROUTE_PREFILL
        for m in (8, 256):
            assert tw.weight_only_route(m, k, dt, aligned=False) \
                == tw.ROUTE_GEMV
    for m in (1, 8, 256):
        assert tw.weight_only_route(m, k, torch.float32) == tw.ROUTE_GEMV


@pytest.mark.parametrize("k", [550, 552, 576 + 32, 4096 + 8])
def test_route_predicate_sends_k_not_a_multiple_of_64_to_the_gemv(k):
    for m in (1, 16, 17, 256):
        assert tw.weight_only_route(m, k, torch.bfloat16) == tw.ROUTE_GEMV


def test_route_counts_name_every_route_and_a_cpu_call_counts_none():
    """`weight_only_matmul.routes` counts launches by route code where the
    kernel is launched; the plain version on the CPU launches none."""
    assert set(tw.weight_only_matmul.routes) == {
        tw.ROUTE_GEMV, tw.ROUTE_DECODE, tw.ROUTE_PREFILL}
    qw, sc = tq.weight_quantize(torch.from_numpy(_w(3, k=64, n=32)))
    before = dict(tw.weight_only_matmul.routes)
    for m in (1, 17):
        tw.weight_only_matmul(torch.randn(m, 64).to(torch.bfloat16), qw, sc)
    assert tw.weight_only_matmul.routes == before
