"""GPU-only tests of the port's hand-written CUDA kernels: each kernel
against its plain PyTorch version, and a tiny model served through both.
The kernels have no CPU mode, so every test here skips without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import pytest
import torch

from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.gpt import _quant_kv
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import decode_attn as td
from paddle_tpu_torch.ops import weight_only as tw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,k", [(torch.float32, 550),
                                     (torch.bfloat16, 576),
                                     (torch.bfloat16, 552)])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 16, 17, 70])
def test_weight_only_kernel_matches_plain(cuda, dtype, k, wdt, m):
    """Every path: GEMV row-blocks of 1, 2, 4 and 8 (m <= 16, and m > 16
    for f32 or k % 64 != 0; 16-byte loads when k % 32 == 0, element loads
    and a ragged tail otherwise), tensor cores (m > 16, bf16,
    k % 64 == 0), ragged m and n.
    f32: 1e-4 relative (summation order); bf16: both round an f32 sum to
    bf16, so 2 bf16 ulps of the largest output."""
    g = torch.Generator().manual_seed(m)
    n = 333
    w = torch.randn(k, n, generator=g) * 0.05
    qw, sc = tq.weight_quantize(w, f"weight_only_{wdt}")
    x = torch.randn(m, k, generator=g).to(dtype)
    ref = tw.weight_only_matmul_ref(x, qw, sc, wdt)
    before = tw.weight_only_matmul.launches
    got = tw.weight_only_matmul(x.to(cuda), qw.to(cuda), sc.to(cuda), wdt)
    assert tw.weight_only_matmul.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    else:
        tol = 2 * 2.0 ** -8 * ref.float().abs().max().item()
        assert (got.cpu().float() - ref.float()).abs().max().item() <= tol


def _paged_case(B, H, Hkv, D, BS, NB, N, pos, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g)
    k = torch.randn(N, BS, Hkv, D, generator=g)     # engine layout
    v = torch.randn(N, BS, Hkv, D, generator=g)
    perm = (torch.randperm(N - 1, generator=g) + 1).tolist()
    tables = torch.zeros(B, NB, dtype=torch.int32)
    for b, p in enumerate(pos):
        used = p // BS + 1
        tables[b, :used] = torch.tensor([perm.pop() for _ in range(used)])
    return q, k, v, tables, torch.tensor(pos, dtype=torch.int32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv", [4, 1])
@pytest.mark.parametrize("nb", [3, 40])       # one split / several splits
def test_paged_kernel_matches_plain(cuda, int8, hkv, nb):
    """Through a permuted engine-layout view; f32 query, so 1e-4 (online
    and split softmax vs two-pass softmax, all in f32)."""
    pos = [0, 13, nb * 8 - 1]
    q, k, v, tables, pos_t = _paged_case(3, 4, hkv, 64, 8, nb, 3 * nb + 1,
                                         pos, seed=nb)
    k, v = k.to(cuda), v.to(cuda)
    if int8:
        (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
        ks, vs = ks.permute(0, 2, 1), vs.permute(0, 2, 1)
    else:
        ks = vs = None
    args = (q.to(cuda), k.permute(0, 2, 1, 3), ks, v.permute(0, 2, 1, 3), vs,
            tables.to(cuda), pos_t.to(cuda))
    before = td.paged_decode_attention.launches
    got = td.paged_decode_attention(*args)
    assert td.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got, td.paged_decode_attention_ref(*args),
                               rtol=1e-4, atol=1e-4)


def test_paged_kernel_row_stable_across_batch(cuda):
    """A sequence's output bits do not depend on its batchmates."""
    q, k, v, tables, pos = _paged_case(4, 4, 2, 64, 8, 20, 81,
                                       [5, 70, 150, 33], seed=3)
    full = td.paged_decode_attention(
        q.to(cuda), k.to(cuda).permute(0, 2, 1, 3), None,
        v.to(cuda).permute(0, 2, 1, 3), None, tables.to(cuda), pos.to(cuda))
    one = td.paged_decode_attention(
        q[2:3].to(cuda), k.to(cuda).permute(0, 2, 1, 3), None,
        v.to(cuda).permute(0, 2, 1, 3), None, tables[2:3].to(cuda),
        pos[2:3].to(cuda))
    assert torch.equal(full[2:3], one)


def test_engine_serves_through_both_kernels(cuda):
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    m = quantize_for_inference(gpt("gpt_tiny", device=cuda), "int8",
                               min_features=0)
    before = (td.paged_decode_attention.launches,
              tw.weight_only_matmul.launches)
    with DecodeEngine(m, max_length=32, block_size=8, quant="int8") as e:
        assert len(e.generate([1, 2, 3], 4)) == 4
        assert e.stats()["blocks"]["allocated"] == 0
    assert td.paged_decode_attention.launches > before[0]
    assert tw.weight_only_matmul.launches > before[1]
