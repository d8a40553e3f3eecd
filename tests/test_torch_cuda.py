"""GPU-only tests of the port's hand-written CUDA kernels: each kernel
against its plain PyTorch version, a tiny model served through the decode
kernels and trained through the flash-attention kernels.
The kernels have no CPU mode, so every test here skips without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import importlib

import pytest
import torch

from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.gpt import _quant_kv
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import decode_attn as td
from paddle_tpu_torch.ops import weight_only as tw

tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

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


def _flash_case(B, S, H, D, dtype, seed, fused=False):
    """q, k, v, dO; with `fused`, q/k/v are strided views of one
    [B, S, 3, H, D] tensor (the model's fused-QKV layout)."""
    g = torch.Generator().manual_seed(seed)
    if fused:
        qkv = torch.randn(B, S, 3, H, D, generator=g).to(dtype).cuda()
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, S, H, D, generator=g).to(dtype).cuda()
                   for _ in range(3))
    do = torch.randn(B, S, H, D, generator=g).to(dtype).cuda()
    return q, k, v, do


def _err(got, ref):
    """max |got - ref| over max(1, max |ref|)."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1.0)).item()


def _norm_err(got, ref):
    """||got - ref|| / ||ref||."""
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


# dtype -> (O max abs error, each gradient's normwise relative error);
# the largest gradient readings of these cases on an H100: 1.7e-4 in
# bf16, 2.5e-7 in f32
FLASH_TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D,fused", [(128, 32, False), (300, 64, True),
                                       (200, 80, False), (257, 128, True),
                                       (130, 256, False), (97, 16, False)])
def test_flash_kernels_match_plain(cuda, dtype, causal, S, D, fused):
    """Forward, dq and dkv each against the plain versions on the same
    inputs (the backward kernels get the plain forward's lse and delta).
    O to FLASH_TOL's max abs error; each gradient to its normwise
    relative error (f32: summation order only)."""
    tol, grad_tol = FLASH_TOL[dtype]
    q, k, v, do = _flash_case(2, S, 3, D, dtype, seed=S + D, fused=fused)
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert _err(out, ref) <= tol
    assert (lse - lse_ref).abs().max().item() <= (1e-2 if tol > 1e-3
                                                  else 1e-4)
    delta = tfa.attention_delta(ref, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta,
                                    causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta,
                                         causal=causal)
    refs = tfa.flash_attention_bwd_ref(q, k, v, do, lse_ref, delta,
                                       causal=causal)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all(), name
        assert _norm_err(got, r) <= grad_tol, (name, _norm_err(got, r))
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)


def test_flash_backward_is_bitwise_reproducible(cuda):
    """No atomics: two backward passes give the same bits."""
    q, k, v, do = _flash_case(2, 1000, 4, 64, torch.bfloat16, seed=5)
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        tfa.flash_attention(*leaves, causal=True).backward(do)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_sdpa_routes_by_the_shape_predicate_alone(cuda):
    """On the GPU, self-attention shapes that `flash_attention_supported`
    admits launch the forward kernel; S < 128 and GQA-shaped k/v take the
    plain version."""
    from paddle_tpu_torch.nn import functional as TF

    def launches_of(q, k):
        before = tfa.flash_attention_fwd.launches
        TF.scaled_dot_product_attention(q, k, k, is_causal=True)
        return tfa.flash_attention_fwd.launches - before

    x = torch.randn(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    assert launches_of(x, x) == 1
    assert launches_of(x[:, :64], x[:, :64]) == 0
    assert launches_of(x, x[:, :, :2]) == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_kernel_refuses_other_dtypes(cuda, dtype):
    x = torch.zeros(1, 128, 2, 64, dtype=dtype, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_attention(x, x, x)


def test_parallelize_trains_gpt_tiny_through_flash_kernels(cuda):
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    m = gpt("gpt_tiny", device=cuda)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    eng = parallelize(m, opt, compute_dtype="bfloat16")
    ids = torch.randint(0, m.cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(0))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    losses = eng.train_batches([(ids,)] * 3)
    after = (tfa.flash_attention_fwd.launches,
             tfa.flash_attention_bwd_dq.launches,
             tfa.flash_attention_bwd_dkv.launches)
    per = 3 * m.cfg.num_layers
    assert tuple(a - b for a, b in zip(after, before)) == (per, per, per)
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
    assert m.device.type == "cuda"
