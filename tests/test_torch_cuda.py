"""GPU-only tests of the port's hand-written CUDA kernels: each kernel
against its plain PyTorch version, a tiny model served through the decode
kernels (with prefix sharing and LoRA adapters through BGMV), trained
through the flash-attention kernels, a tiny BERT fine-tuned through
the short-attention kernels with attention dropout, and CSR-pattern
attention through the block-sparse kernel.
The kernels have no CPU mode, so every test here skips without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the repository's conftest
(which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import importlib
import math
import threading
import time

import pytest
import torch

from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.gpt import _quant_kv
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import bgmv as tb
from paddle_tpu_torch.ops import decode_attn as td
from paddle_tpu_torch.ops import weight_only as tw

tbs = importlib.import_module("paddle_tpu_torch.ops.block_sparse_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
tsa = importlib.import_module("paddle_tpu_torch.ops.short_attention")
trb = importlib.import_module("paddle_tpu_torch.ops.fused_resblock")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,k", [(torch.float32, 550),
                                     (torch.bfloat16, 576),
                                     (torch.bfloat16, 552),
                                     (torch.bfloat16, 512),
                                     (torch.bfloat16, 4096),
                                     (torch.float16, 4096)])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 16, 17, 64, 70, 100, 256, 300])
def test_weight_only_kernel_matches_plain(cuda, dtype, k, wdt, m):
    """Every route: the decode tensor-core GEMV (m <= 16, bf16/f16,
    k % 64 == 0), the prefill wgmma GEMM (m > 16, the same rules; 128 or
    256 rows of x a CTA, and m = 300 over two x tiles), and the CUDA-core
    GEMV for the rest (f32 or k % 64 != 0; row-blocks of 1, 2, 4 and 8,
    16-byte loads when k % 32 == 0, element loads and a ragged tail
    otherwise); ragged m and n.
    f32: 1e-4 relative (summation order); bf16/f16: both round an f32 sum
    to x's type, so 2 bf16 ulps of the largest output."""
    g = torch.Generator().manual_seed(m)
    n = 333
    w = torch.randn(k, n, generator=g) * 0.05
    qw, sc = tq.weight_quantize(w, f"weight_only_{wdt}")
    x = torch.randn(m, k, generator=g).to(dtype)
    ref = tw.weight_only_matmul_ref(x, qw, sc, wdt)
    before = tw.weight_only_matmul.launches
    routes = dict(tw.weight_only_matmul.routes)
    got = tw.weight_only_matmul(x.to(cuda), qw.to(cuda), sc.to(cuda), wdt)
    assert tw.weight_only_matmul.launches == before + 1
    want = tw.ROUTE_GEMV
    if dtype != torch.float32 and k % 64 == 0:
        want = tw.ROUTE_DECODE if m <= 16 else tw.ROUTE_PREFILL
    routes[want] += 1
    assert tw.weight_only_matmul.routes == routes
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    else:
        tol = 2 * 2.0 ** -8 * ref.float().abs().max().item()
        assert (got.cpu().float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
@pytest.mark.parametrize("k", [4096, 576])
def test_weight_only_rows_bit_equal_across_m(cuda, dtype, wdt, k):
    """The decode route is row-stable: a row's output is the same bits
    whether it is computed at m = 1, 2, 3, 4, 8 or 16 (the decode
    buckets), for an n whose CTAs split k over 8, 2 and no warps."""
    g = torch.Generator(device=cuda).manual_seed(k)
    for n in (333, 22016, 34000):
        w = torch.randn(k, n, generator=g, device=cuda) * 0.05
        qw, sc = tq.weight_quantize(w, f"weight_only_{wdt}")
        x = torch.randn(16, k, generator=g, device=cuda).to(dtype)
        assert tw.weight_only_route(16, k, dtype) == tw.ROUTE_DECODE
        full = tw.weight_only_matmul(x, qw, sc, wdt)
        for m in (1, 2, 3, 4, 8):
            assert torch.equal(tw.weight_only_matmul(x[:m], qw, sc, wdt),
                               full[:m]), (n, m)


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
        st = e.stats()
        # quiesced: only the prefix cache's pins remain
        assert st["blocks"]["allocated"] \
            == st["prefix_cache"]["physical_blocks"]
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


@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_is_bitwise_reproducible(cuda, D):
    """No atomics: two backward passes give the same bits (on the Hopper
    bodies: each output has one owner that sums it in a fixed order)."""
    q, k, v, do = _flash_case(2, 1000, 4, D, torch.bfloat16, seed=5)
    assert tfa.flash_bwd_route(q, k, v, do)[0] == tfa.BWD_WGMMA
    grads = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        tfa.flash_attention(*leaves, causal=True).backward(do)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1024, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_hopper_body_matches_plain(cuda, D, S, causal):
    """The bf16 forward's Hopper body (TMA-fed wgmma, P in registers) on
    fused-QKV views, block-aligned, ragged and long S: O to FLASH_TOL's
    2e-2 max abs error, lse to 1e-2."""
    q, k, v, _ = _flash_case(2, S, 3, D, torch.bfloat16, seed=S + D,
                             fused=True)
    before = tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    assert tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] == before + 1
    ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= FLASH_TOL[torch.bfloat16][0]
    assert (lse - lse_ref).abs().max().item() <= 1e-2


def test_flash_forward_is_bitwise_reproducible(cuda):
    """Two calls of the Hopper forward give the same bits."""
    q, k, v, _ = _flash_case(2, 1000, 4, 128, torch.bfloat16, seed=7,
                             fused=True)
    assert tfa.flash_fwd_route(q, k, v)[0] == tfa.FWD_WGMMA
    a = tfa.flash_attention_fwd(q, k, v, causal=True)
    b = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("S", [1024, 1000])
def test_flash_forward_bit_stable_in_a_cuda_graph(cuda, S):
    """Hundreds of causal Hopper forwards back to back in one CUDA graph,
    at D = 64 (64-key blocks, so warpgroup 0 skips the last K block of its
    tile before warpgroup 1 is done with the stage), block-aligned and
    ragged S: every launch of every replay gives the eager launch's O and
    lse bit for bit. A warpgroup that hands a skipped block's stage back
    too early lets a lagging warp wait on the wrong phase, which traps
    (the launch fails) or reads the next block's K/V."""
    q, k, v, _ = _flash_case(4, S, 12, 64, torch.bfloat16, seed=S,
                             fused=True)
    calls = 256
    o0, l0 = tfa.flash_attention_fwd(q, k, v, causal=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.current_stream().wait_stream(side)
    tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] = 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tfa.flash_attention_fwd(q, k, v, causal=True)
                for _ in range(calls)]
    assert tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] == calls
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        bad = [i for i, (o, l) in enumerate(outs)
               if not (torch.equal(o, o0) and torch.equal(l, l0))]
        assert not bad, f"{len(bad)} of {calls} launches differ"


@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_reads_the_hopper_forward_lse(cuda, D):
    """Training's path: the dq / dkv kernels run on the Hopper forward's
    lse (and delta from its O) and match the plain backward given the same
    lse and delta (normwise, FLASH_TOL); the autograd Function, which
    hands them exactly these, gives the same gradients bit for bit."""
    q, k, v, do = _flash_case(2, 1000, 3, D, torch.bfloat16, seed=D,
                              fused=True)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa.flash_fwd_route(q, k, v)[0] == tfa.FWD_WGMMA
    delta = tfa.attention_delta(out, do)
    grads = (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True),
             *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                          causal=True))
    refs = tfa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal=True)
    for name, got, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _norm_err(got, r) <= FLASH_TOL[torch.bfloat16][1], name
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves, causal=True).backward(do)
    for name, x, got in zip(("dq", "dk", "dv"), leaves, grads):
        assert torch.equal(x.grad, got), name


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("S", [1024, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_hopper_bodies_match_plain(cuda, D, S, causal):
    """The dQ and dK/dV Hopper bodies (TMA-fed wgmma, dS and P^T in
    registers; at D = 128 the two warpgroups share a 64-key tile) on
    fused-QKV views, block-aligned and ragged S, D padded to the 128-column
    tile at 80: each gradient to FLASH_TOL's normwise 1e-3 against the
    plain backward on the same lse and delta, one launch of each on its
    Hopper route."""
    q, k, v, do = _flash_case(2, S, 3, D, torch.bfloat16, seed=S + D + 1,
                              fused=True)
    ref, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    delta = tfa.attention_delta(ref, do)
    assert tfa.flash_bwd_route(q, k, v, do)[0] == tfa.BWD_WGMMA
    before = (dict(tfa.flash_attention_bwd_dq.routes),
              dict(tfa.flash_attention_bwd_dkv.routes))
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal)
    for w, b in zip((tfa.flash_attention_bwd_dq,
                     tfa.flash_attention_bwd_dkv), before):
        assert w.routes == {**b, tfa.BWD_WGMMA: b[tfa.BWD_WGMMA] + 1}
    refs = tfa.flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                       causal=causal)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all(), name
        assert _norm_err(got, r) <= FLASH_TOL[torch.bfloat16][1], (
            name, _norm_err(got, r))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1024, 1000])
def test_flash_backward_bit_stable_in_a_cuda_graph(cuda, D, S):
    """Hundreds of causal Hopper dQ and dK/dV launches back to back in one
    CUDA graph, replayed 3 times: every launch gives the eager launch's
    gradients bit for bit. The causal loops skip blocks in turn (dQ: a
    warpgroup's blocks past its last row; dK/dV: blocks before its first
    key), and a stage released before every warp has passed its wait lets
    a lagging warp wait on the wrong phase: the launch traps or reads the
    next block."""
    q, k, v, do = _flash_case(2, S, 12, D, torch.bfloat16, seed=S + D,
                              fused=True)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = tfa.attention_delta(out, do)

    def bwd():
        return (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))

    ref = bwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd()
    torch.cuda.current_stream().wait_stream(side)
    calls = 128
    tfa.flash_attention_bwd_dq.routes[tfa.BWD_WGMMA] = 0
    tfa.flash_attention_bwd_dkv.routes[tfa.BWD_WGMMA] = 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [bwd() for _ in range(calls)]
    assert tfa.flash_attention_bwd_dq.routes[tfa.BWD_WGMMA] == calls
    assert tfa.flash_attention_bwd_dkv.routes[tfa.BWD_WGMMA] == calls
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        bad = [i for i, o in enumerate(outs)
               if not all(torch.equal(a, b) for a, b in zip(o, ref))]
        assert not bad, f"{len(bad)} of {calls} calls differ"


@pytest.mark.parametrize("kind", [3, 4, 5])
def test_flash_hopper_kinds_refuse_what_they_do_not_admit(cuda, kind):
    """Asked for a Hopper body on f32 operands, the C entry refuses
    (cudaErrorInvalidValue) instead of running another body."""
    q, k, v, do = _flash_case(1, 256, 2, 64, torch.float32, seed=3)
    lse = torch.zeros(1, 2, 256, device=cuda)
    _, ptrs, strides = _build.attention_views((q, k, v, do))
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfa._launch(kind, q, ptrs, strides, lse, lse, out, out, lse, True,
                    0.125)


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


# ---------------------------------------------------------------------------
# BGMV (multi-tenant LoRA)
# ---------------------------------------------------------------------------

def _bgmv_case(b, s, d_in, d_out, r, slots, dtype, seed, strided=False):
    """x (optionally a strided view: every row padded to 2*d_in), slot
    stacks with slot 0 zero, ids mixing slot 0, repeats and distinct
    slots."""
    g = torch.Generator().manual_seed(seed)
    width = 2 * d_in if strided else d_in
    x = torch.randn(b, s, width, generator=g).to(dtype)[..., :d_in]
    A = torch.randn(slots, d_in, r, generator=g) * 0.05
    B = torch.randn(slots, r, d_out, generator=g) * 0.05
    A[0] = 0.0
    B[0] = 0.0
    ids = torch.tensor([(i * 3) % slots if i % 3 else 0 for i in range(b)],
                       dtype=torch.int32)
    return x, A, B, ids


def _bgmv_tol(ref):
    """f32 sums in another order: 1e-5 of the largest |output| + 1e-6."""
    return 1e-5 * ref.abs().max().item() + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d_in,d_out,r,strided", [
    (8, 1, 4096, 12288, 16, False),    # llama2_7b qkv_proj, decode
    (8, 1, 4096, 4096, 64, True),      # out_proj at rank 64, strided x
    (3, 5, 300, 77, 3, False),         # r % 4 != 0: element loads; ragged
    (2, 9, 256, 513, 128, True),       # rank 128, ragged s and d_out
    (5, 1, 64, 100, 1, False)])        # rank 1
def test_bgmv_kernel_matches_plain(cuda, dtype, b, s, d_in, d_out, r,
                                   strided):
    x, A, B, ids = _bgmv_case(b, s, d_in, d_out, r, 6, dtype, seed=d_in + r,
                              strided=strided)
    ref = tb.lora_delta_ref(x, A, B, ids)
    before = tb.lora_delta.launches, dict(tb.lora_delta.routes)
    got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert tb.lora_delta.launches == before[0] + 1
    route = tb.ROUTE_CLUSTER if s == 1 else tb.ROUTE_TWO_LAUNCH
    assert tb.lora_delta.routes == {**before[1],
                                    route: before[1][route] + 1}
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got.cpu() - ref).abs().max().item() <= _bgmv_tol(ref)
    for i in range(b):
        if ids[i] == 0:
            assert not got[i].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 4, 16, 64, 128])
@pytest.mark.parametrize("d_in,d_out", [
    (4096, 12288),                     # llama2_7b qkv_proj: 16 CTAs
    (4100, 4098),                      # neither divides by KC; d_out % 4
    (300, 77)])                        # 8 CTAs, ragged cuts
def test_bgmv_cluster_route_matches_plain(cuda, dtype, r, d_in, d_out):
    """The decode step's body (one cluster a sequence, h exchanged
    through distributed shared memory) at b = 1, 3, 8 and 16, a strided x
    at b = 3 and 16: within 1e-5 of max |ref|, slot-0 rows exact zeros,
    one launch on the cluster route."""
    for b, strided in ((1, False), (3, True), (8, False), (16, True)):
        x, A, B, ids = _bgmv_case(b, 1, d_in, d_out, r, 6, dtype,
                                  seed=d_in + r + b, strided=strided)
        ref = tb.lora_delta_ref(x, A, B, ids)
        before = dict(tb.lora_delta.routes)
        got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda),
                            ids.to(cuda))
        torch.cuda.synchronize()
        assert tb.lora_delta.routes == {
            **before, tb.ROUTE_CLUSTER: before[tb.ROUTE_CLUSTER] + 1}
        assert (got.cpu() - ref).abs().max().item() <= _bgmv_tol(ref), b
        for i in range(b):
            if ids[i] == 0:
                assert not got[i].any()


@pytest.mark.parametrize("d_out", [4096, 4098])
def test_bgmv_rows_are_batch_invariant(cuda, d_out):
    """A row's bits do not depend on its batchmates or the batch size
    (the cluster body's cut is a function of the shape alone)."""
    x, A, B, ids = _bgmv_case(8, 1, 4096, d_out, 16, 8, torch.bfloat16, 5)
    x, A, B, ids = x.to(cuda), A.to(cuda), B.to(cuda), ids.to(cuda)
    full = tb.lora_delta(x, A, B, ids)
    for i in range(8):
        one = tb.lora_delta(x[i:i + 1], A, B, ids[i:i + 1])
        assert torch.equal(full[i:i + 1], one)
    part = tb.lora_delta(x[2:5], A, B, ids[2:5])
    assert torch.equal(full[2:5], part)
    big = tb.lora_delta(torch.cat([x, x]), A, B, torch.cat([ids, ids]))
    assert torch.equal(big[:8], full) and torch.equal(big[8:], full)


def test_bgmv_prefill_rows_take_the_two_launch_body(cuda):
    """s > 1 (a chunk with an id per sequence): shrink then expand, within
    the tolerance of the plain version."""
    x, A, B, ids = _bgmv_case(3, 40, 512, 300, 16, 4, torch.bfloat16, 7)
    before = dict(tb.lora_delta.routes)
    got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda), ids.to(cuda))
    assert tb.lora_delta.routes == {
        **before, tb.ROUTE_TWO_LAUNCH: before[tb.ROUTE_TWO_LAUNCH] + 1}
    ref = tb.lora_delta_ref(x, A, B, ids)
    assert (got.cpu() - ref).abs().max().item() <= _bgmv_tol(ref)


def test_bgmv_scalar_ids_take_the_matmul_path(cuda):
    x, A, B, _ = _bgmv_case(1, 7, 96, 80, 8, 4, torch.float32, 9)
    before = tb.lora_delta.launches
    got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda),
                        torch.tensor(2, dtype=torch.int32, device=cuda))
    assert tb.lora_delta.launches == before
    ref = tb.lora_delta_ref(x, A, B, torch.tensor([2], dtype=torch.int32))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("d_in,d_out", [(64, 48), (4096, 12288)])
def test_bgmv_out_of_range_slot_gives_nan_rows(cuda, s, d_in, d_out):
    """An id outside [0, slots) gives a NaN row on either body; its
    batchmates (slot 0 among them) are unaffected."""
    x, A, B, _ = _bgmv_case(4, s, d_in, d_out, 4, 3, torch.float32, 1)
    ids = torch.tensor([1, 7, 0, -1], dtype=torch.int32)
    got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda), ids.to(cuda))
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1]).all()
    assert not got[2].any() and torch.isnan(got[3]).all()
    ref = tb.lora_delta_ref(x[:1], A, B, ids[:1])
    assert (got[:1].cpu() - ref).abs().max().item() <= _bgmv_tol(ref)


def _tiny_int8(cuda):
    """gpt_tiny with an untied head, every Linear int8: each product of a
    decode step is a row-stable kernel."""
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    return quantize_for_inference(
        gpt("gpt_tiny", device=cuda, tie_word_embeddings=False), "int8",
        min_features=0)


def test_engine_sharing_equals_private_on_gpu(cuda):
    """int8 weights and KV: every decode product is row-stable, so a
    sharing engine's tokens equal a private engine's."""
    from paddle_tpu_torch.inference import DecodeEngine

    m = _tiny_int8(cuda)
    g = torch.Generator().manual_seed(4)
    system = torch.randint(0, 256, (16,), generator=g).tolist()
    prompts = [system + torch.randint(0, 256, (t,), generator=g).tolist()
               for t in (3, 9, 5)]
    prompts.append(list(prompts[0]))
    kw = dict(max_length=48, block_size=8, prefill_buckets=(8, 16, 32),
              prefill_chunk=8, quant="int8")

    def run(e):
        first = e.generate(prompts[0], 6)
        return [first] + [s.result() for s in
                          [e.submit(p, 6) for p in prompts[1:]]]

    with DecodeEngine(m, prefix_cache=False, **kw) as e:
        ref = run(e)
    with DecodeEngine(m, **kw) as e:
        assert run(e) == ref
        st = e.stats()
    assert st["prefix_cache"]["full_hits"] >= 1 and st["cow_copies"] >= 1
    assert e.stats()["blocks"]["allocated"] == 0


def test_engine_adapters_through_bgmv_on_gpu(cuda):
    from paddle_tpu_torch.inference import AdapterPool, DecodeEngine

    m = _tiny_int8(cuda)
    pool = AdapterPool(m, rank=8, slots=4)
    g = torch.Generator().manual_seed(1)
    for name in ("a", "b"):
        pool.load(name, {k: (torch.randn(i, 8, generator=g) * 0.2,
                             torch.randn(8, o, generator=g) * 0.2)
                         for k, (i, o) in pool.layers.items()})
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
    tenants = [None, "a", "b"]
    try:
        with DecodeEngine(m, max_length=32, block_size=8,
                          adapters=pool) as e:
            solo = [e.generate(p, 6, adapter=t)
                    for p, t in zip(prompts, tenants)]
            before = tb.lora_delta.launches
            streams = [e.submit(p, 6, adapter=t)
                       for p, t in zip(prompts, tenants)]
            assert [s.result() for s in streams] == solo
            assert tb.lora_delta.launches > before
            assert e.stats()["adapters"]["refs"] == 0
    finally:
        pool.detach()


def test_sampler_rows_do_not_depend_on_the_row_count(cuda):
    """A row's draw is the same alone, in 3 rows and in 8 (top-p's cumsum
    runs in fixed row groups; PyTorch's own CUDA cumsum is not
    row-count-invariant)."""
    from paddle_tpu_torch.inference import sampling as ts

    g = torch.Generator().manual_seed(2)
    logits = (torch.randn(8, 32000, generator=g) * 3).to(cuda)
    for ctr in range(6):
        pack = {"ctr": torch.full((8,), ctr, dtype=torch.int64),
                "greedy": torch.tensor([0, 1, 0, 0, 0, 0, 0, 0],
                                       dtype=torch.int32),
                "rep": torch.ones(8), "seed": torch.arange(8) * 7 + 1,
                "temp": torch.full((8,), 0.8), "top_k": torch.tensor(
                    [0, 0, 50, 0, 10, 0, 0, 5]),
                "top_p": torch.tensor([0.9, 1.0, 0.9, 0.5, 1.0, 0.95, 0.7,
                                       0.9])}
        pack = {k: v.to(cuda) for k, v in pack.items()}
        full = ts.sample_token(logits, pack)
        for lo, hi in ((0, 1), (3, 4), (2, 5), (5, 8)):
            part = ts.sample_token(logits[lo:hi],
                                   {k: v[lo:hi] for k, v in pack.items()})
            assert torch.equal(part, full[lo:hi])


@pytest.mark.parametrize("width", [768, 4096])
def test_norm_rows_do_not_depend_on_the_row_count(cuda, width):
    """The norms' f32 row statistics, and the norms themselves, keep a
    row's bits at any row count (a plain `mean` over 4096 does not)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional.norm import _row_mean

    g = torch.Generator().manual_seed(6)
    x = (torch.randn(64, width, generator=g) * 3).to(cuda)
    w = (torch.rand(width, generator=g) + 0.5).to(cuda)
    xb = x.to(torch.bfloat16)
    fns = (_row_mean, lambda t: F.rms_norm(t, w.to(t.dtype)),
           lambda t: F.layer_norm(t, w, w))
    for fn in fns:
        for t in (x, xb):
            alone = torch.cat([fn(t[i:i + 1]) for i in range(t.shape[0])])
            for rows in (2, 3, 4, 8, 16, 17, 64):
                assert torch.equal(fn(t[:rows]), alone[:rows])


def test_sampled_stream_same_alone_and_batched_on_gpu(cuda):
    """With int8 weights every product of a step is row-stable and the
    sampler is row-count-invariant: a sampled request decodes the same
    tokens alone (bucket 1) and among batchmates (bucket 4)."""
    from paddle_tpu_torch.inference import DecodeEngine, SamplingParams

    m = _tiny_int8(cuda)
    sp = SamplingParams(temperature=1.2, top_k=40, top_p=0.9, seed=11)
    prompt = [5, 17, 99, 3, 42, 7]
    with DecodeEngine(m, max_length=48, block_size=8,
                      prefix_cache=False) as e:
        alone = e.generate(prompt, 16, sampling=sp)
        mates = [e.submit([i + 1, i + 2, i + 3], 16,
                          sampling=SamplingParams(temperature=1.0, seed=i))
                 for i in range(3)]
        batched = e.submit(prompt, 16, sampling=sp)
        assert batched.result() == alone
        for s in mates:
            s.result()
        assert e.stats()["steps"] > 16


# ---------------------------------------------------------------------------
# Short attention with in-kernel dropout (BERT)
# ---------------------------------------------------------------------------

def _sa_case(B, S, H, D, dtype, seed):
    """q, k, v as views of one [B, S, 3, H, D] tensor (BERT's fused QKV),
    dO, and a stream seed on the card."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3, H, D, generator=g).to(dtype).cuda()
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, S, H, D, generator=g).to(dtype).cuda()
    return q, k, v, do, torch.tensor([seed * 7919 + 1], device="cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D,p", [(128, 64, 0.1), (128, 64, 0.0),
                                   (512, 64, 0.1), (512, 64, 0.0),
                                   (136, 64, 0.1), (136, 64, 0.0),
                                   (128, 40, 0.1), (64, 256, 0.3),
                                   (8, 8, 0.5)])
def test_short_attention_kernels_match_plain(cuda, dtype, causal, S, D, p):
    """Forward and backward against the plain versions with the same seed,
    so the same mask: O to FLASH_TOL's max abs error, lse to 1e-2 (bf16)
    / 1e-4 (f32), each gradient to its normwise error (the backward
    kernels take the forward kernel's lse, as on the training path, the
    plain backward the plain forward's). One forward launch, on the
    Hopper body for bf16 at 32 < D <= 128 (the flash forward's body with
    the keep bits drawn inside), two backward launches (dQ, then
    dK/dV)."""
    tol, grad_tol = FLASH_TOL[dtype]
    q, k, v, do, seed = _sa_case(2, S, 3, D, dtype, seed=S + D)
    counts = (tsa.short_attention_fwd.launches,
              tsa.short_attention_bwd.launches)
    route = (tsa.FWD_WGMMA if dtype == torch.bfloat16 and 32 < D <= 128
             else tsa.FWD_MMA)
    assert tsa.short_fwd_route(q, k, v)[0] == route
    routes = dict(tsa.short_attention_fwd.routes)
    out, lse = tsa.short_attention_fwd(q, k, v, seed, p, causal)
    assert tsa.short_attention_fwd.routes == {**routes,
                                              route: routes[route] + 1}
    ref, lse_ref = tsa.short_attention_ref(q, k, v, seed, p, causal)
    assert _err(out, ref) <= tol, _err(out, ref)
    assert (lse - lse_ref).abs().max().item() <= (1e-2 if tol > 1e-3
                                                  else 1e-4)
    grads = tsa.short_attention_bwd(q, k, v, do, lse, seed, p, causal)
    refs = tsa.short_attention_bwd_ref(q, k, v, do, lse_ref, seed, p,
                                       causal)
    for name, got, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(got).all(), name
        assert _norm_err(got, r) <= grad_tol, (name, _norm_err(got, r))
    assert (tsa.short_attention_fwd.launches,
            tsa.short_attention_bwd.launches) == (counts[0] + 1,
                                                  counts[1] + 2)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 256),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("S,p", [(128, 0.1), (136, 0.5), (512, 0.1)])
def test_short_attention_kernel_draws_the_plain_mask(cuda, dtype, D, S, p):
    """The kernel's keep bits, read out exactly for every key: with
    q = k = 0 every probability is 1/S, and with V[j, j - c] = 1 for the
    keys j in [c, c + D) the output's (i, d) entry is nonzero exactly
    where element (i, c + d) is kept; one call per D keys. It must equal
    the plain stream's mask bit for bit. f32 runs the mma.sync body; bf16
    the Hopper body's two instantiations: 64-key blocks and one keep word
    a draw at D = 64 (BERT's), 128-key blocks and two at D = 128."""
    from paddle_tpu_torch.ops import _dropout_rng

    B, H = 2, 3
    q = torch.zeros(B, S, H, D, device=cuda, dtype=dtype)
    seed = torch.tensor([2024], device=cuda)
    route = tsa.FWD_WGMMA if dtype == torch.bfloat16 else tsa.FWD_MMA
    assert tsa.short_fwd_route(q, q, q)[0] == route
    kept = torch.empty(B, H, S, S, dtype=torch.bool, device=cuda)
    for c in range(0, S, D):
        w = min(D, S - c)
        v = torch.zeros(S, D, device=cuda, dtype=dtype)
        v[c:c + w, :w] = torch.eye(w, device=cuda, dtype=dtype)
        v = v[None, :, None, :].expand(B, S, H, D).contiguous()
        before = tsa.short_attention_fwd.routes[route]
        out, _ = tsa.short_attention_fwd(q, q, v, seed, p)
        assert tsa.short_attention_fwd.routes[route] == before + 1
        kept[..., c:c + w] = (out[..., :w] != 0).permute(0, 2, 1, 3)
    assert torch.equal(kept, _dropout_rng.keep_mask(seed, B, H, S, S, p))


def test_short_attention_hopper_kind_refuses_what_it_does_not_admit(cuda):
    """Asked for the Hopper forward on f32 operands, the C entry refuses
    (cudaErrorInvalidValue) instead of running the mma.sync body."""
    q, k, v, _, seed = _sa_case(1, 128, 2, 64, torch.float32, seed=2)
    _, ptrs, strides = _build.attention_views((q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(1, 2, 128, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsa._launch(tsa.FWD_WGMMA, q, ptrs, strides, seed, lse, None, out,
                    None, 0.1, False, 0.125)


def test_short_attention_backward_is_bitwise_reproducible(cuda):
    """No atomics and a replayed mask: two passes give the same bits."""
    q, k, v, do, seed = _sa_case(4, 128, 4, 64, torch.bfloat16, seed=9)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = tsa.short_attention(*leaves, seed, 0.1)
        out.backward(do)
        runs.append([out, *(x.grad for x in leaves)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [((1, 520, 2, 64), torch.bfloat16),
                                         ((1, 130, 2, 64), torch.bfloat16),
                                         ((1, 128, 2, 12), torch.bfloat16),
                                         ((1, 128, 2, 264), torch.float32),
                                         ((1, 128, 2, 64), torch.float16)])
def test_short_attention_wrapper_raises_instead_of_falling_back(
        cuda, shape, dtype):
    x = torch.zeros(shape, dtype=dtype, device=cuda)
    seed = torch.tensor([1], device=cuda)
    before = tsa.short_attention_fwd.launches
    with pytest.raises(ValueError, match="short attention kernels"):
        tsa.short_attention_fwd(x, x, x, seed, 0.1)
    assert tsa.short_attention_fwd.launches == before


def test_sdpa_routes_dropout_to_the_short_attention_kernels(cuda):
    """Training-mode dropout on a shape the kernels take launches them;
    eval mode at S = 128 takes the flash forward; a mask or p = 1 takes
    the composed path (no kernel)."""
    from paddle_tpu_torch.nn import functional as TF

    x = torch.randn(2, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)

    def launches(**kw):
        before = (tsa.short_attention_fwd.launches,
                  tfa.flash_attention_fwd.launches)
        TF.scaled_dot_product_attention(x, x, x, generator=g, **kw)
        return (tsa.short_attention_fwd.launches - before[0],
                tfa.flash_attention_fwd.launches - before[1])

    assert launches(dropout_p=0.1) == (1, 0)
    assert launches(dropout_p=0.1, training=False) == (0, 1)
    assert launches(dropout_p=0.1,
                    attn_mask=torch.zeros(2, 1, 1, 128, device=cuda)) \
        == (0, 0)
    assert launches(dropout_p=1.0) == (0, 0)


def test_parallelize_fine_tunes_bert_tiny_through_short_attention(cuda):
    """bert_tiny (dropout 0.1) trained 3 steps in bf16 through the kernels
    and through the composed plain route with the same weights and
    generator seed: one forward and two backward launches per layer and
    step on the kernel run, none on the plain run; losses within 1e-2
    relative (bf16 rounding at other places, the same masks)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import bert_for_sequence_classification
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1024, (4, 64), generator=g)
    labels = torch.randint(0, 2, (4,), generator=g)
    runs = {}
    supported = attention.short_attention_supported
    for route in ("kernels", "plain"):
        if route == "plain":
            attention.short_attention_supported = lambda *a: False
        try:
            m = bert_for_sequence_classification(
                "bert_tiny", device=cuda,
                generator=torch.Generator(device=cuda).manual_seed(5))
            eng = parallelize(
                m, AdamW(learning_rate=1e-3, parameters=m.parameters()),
                loss_fn=lambda m, x, y: TF.cross_entropy(m(x), y).mean(),
                compute_dtype="bfloat16")
            before = (tsa.short_attention_fwd.launches,
                      tsa.short_attention_bwd.launches)
            losses = eng.train_batches([(ids, labels)] * 3)
            runs[route] = (losses.float().cpu(),
                           (tsa.short_attention_fwd.launches - before[0],
                            tsa.short_attention_bwd.launches - before[1]))
        finally:
            attention.short_attention_supported = supported
    per = 3 * m.cfg.num_hidden_layers
    assert runs["kernels"][1] == (per, 2 * per)
    assert runs["plain"][1] == (0, 0)
    assert torch.isfinite(runs["kernels"][0]).all()
    torch.testing.assert_close(runs["kernels"][0], runs["plain"][0],
                               rtol=1e-2, atol=0)


# ---------------------------------------------------------------------------
# fused bottleneck block (ops/fused_resblock.py, csrc/fused_resblock.cu)
# ---------------------------------------------------------------------------

def _block_args(N, H, W, C4, C, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, H, W, C4, generator=g).to(dtype)
    ws = [torch.randn(*s, generator=g) * (2.0 / s[-2]) ** 0.5
          for s in ((C4, C), (3, 3, C, C), (C, C4))]
    ws[1] = ws[1] / 3.0
    vecs = [1.0 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g),
            1.0 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g),
            1.0 + 0.1 * torch.randn(C4, generator=g),
            0.1 * torch.randn(C4, generator=g)]
    return [t.to(device) for t in (x, *ws, *vecs)]


def _normwise(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _y_tol(ref):
    """2 bf16 ulps of max |y|, or 1e-2 absolute, whichever is larger."""
    return max(2 * 2.0 ** -8 * ref.float().abs().max().item(), 1e-2)


@pytest.mark.parametrize("N,H,W,C4,C,dtype", [
    (2, 8, 8, 64, 16, torch.bfloat16),      # two images, one row tile
    (6, 4, 4, 16, 8, torch.bfloat16),       # ragged M = 96, C = 8
    (3, 5, 7, 256, 64, torch.float32),      # f32 input, bf16 operands
    (128, 7, 7, 2048, 512, torch.bfloat16),  # ResNet-50 layer4, N = 128
])
def test_fused_resblock_kernels_match_plain(cuda, N, H, W, C4, C, dtype):
    """Forward kernels against the plain forward: y within 2 bf16 ulps of
    max |y| (or 1e-2 abs) — both round f32 sums of the same bf16 products,
    summed in another order, to bf16 at r1, r2 and y; r1, r2 and the BN
    vectors normwise within 1e-2 (readings <= 6e-4); one call each, eight
    and fourteen launches counted at the launches. Backward kernels
    against the plain backward on the kernels' residuals, as training
    runs them: the ten gradients normwise within 1e-2 (readings <= 1.1e-3:
    da2, da1 and dx are stored in the activations' dtype). End to end,
    each side on its own residuals, within 5e-2 (readings <= 2.2e-2: a
    residual one bf16 ulp apart flips a relu mask element, whose gradient
    then changes by its full size)."""
    args = _block_args(N, H, W, C4, C, dtype, cuda)
    dy = torch.randn(N, H, W, C4, generator=torch.Generator().manual_seed(1)
                     ).to(dtype).to(cuda)
    before = [(f.calls, f.launches) for f in (trb.fused_bottleneck_fwd,
                                              trb.fused_bottleneck_bwd)]
    y, res, stats = trb.fused_bottleneck_fwd(*args)
    grads = trb.fused_bottleneck_bwd(res, dy)
    assert [(f.calls - c, f.launches - n) for f, (c, n) in zip(
        (trb.fused_bottleneck_fwd, trb.fused_bottleneck_bwd), before)] == [
            (1, 8), (1, 14)]
    y_ref, res_ref, stats_ref = trb.fused_bottleneck_fwd_ref(*args)
    same_res = trb.fused_bottleneck_bwd_ref(res, dy)
    own_res = trb.fused_bottleneck_bwd_ref(res_ref, dy)
    torch.cuda.synchronize()
    assert y.dtype == dtype and grads[0].dtype == dtype
    assert (y.float() - y_ref.float()).abs().max().item() <= _y_tol(y_ref)
    for a, b in zip(res[1:3] + res[7:10], res_ref[1:3] + res_ref[7:10]):
        assert _normwise(a, b) <= 1e-2
    for pair, pair_ref in zip(stats, stats_ref):
        for a, b in zip(pair, pair_ref):
            assert _normwise(a, b) <= 1e-3
    names = "dx dw1 dw2 dw3 dg1 dbe1 dg2 dbe2 dg3 dbe3".split()
    for name, a, b, c in zip(names, grads, same_res, own_res):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _normwise(a, b) <= 1e-2, (name, _normwise(a, b))
        assert _normwise(a, c) <= 5e-2, (name, _normwise(a, c))


def test_fused_resblock_kernels_are_bitwise_reproducible(cuda):
    """No atomics: two runs of the forward and backward are bit-equal."""
    args = _block_args(4, 14, 14, 256, 64, torch.bfloat16, cuda)
    dy = torch.randn_like(args[0])
    runs = []
    for _ in range(2):
        y, res, stats = trb.fused_bottleneck_fwd(*args)
        runs.append((y, *[t for p in stats for t in p],
                     *trb.fused_bottleneck_bwd(res, dy)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


#: the forward's launches a call by body: F1, F3, F4 on rb_wg, F2 on
#: rb_wg_conv, relu(bn2(r2)) formed once, three BN reductions
FWD_ROUTES = {trb.ROUTE_ROWS: 3, trb.ROUTE_CONV: 1, trb.ROUTE_WGRAD: 0,
              trb.ROUTE_FORM: 1, trb.ROUTE_REDUCE: 3, trb.ROUTE_K41: 0}


@pytest.mark.parametrize("N,H,W,C4,C,dtype", [
    (2, 8, 8, 32, 8, torch.bfloat16),        # C = 8: 64-wide tiles of N
    (6, 4, 4, 64, 16, torch.float32),        # ragged M = 96, f32 x
    (3, 5, 7, 256, 64, torch.bfloat16),      # ragged M = 105; one K step
    (2, 6, 1, 512, 128, torch.bfloat16),     # W = 1: every tap masked
    (2, 6, 1, 512, 128, torch.float32),      # but the middle column
    (5, 9, 11, 256, 64, torch.float32),      # f32 x over ragged tiles
    (16, 7, 7, 2048, 512, torch.float32),    # ResNet-50 layer4 width, f32
    (128, 56, 56, 256, 64, torch.bfloat16),  # ResNet-50 layer1, N = 128
])
def test_fused_forward_hopper_bodies_match_plain(cuda, N, H, W, C4, C,
                                                 dtype):
    """The forward on the Hopper bodies (F1, F3, F4 on rb_wg, F2 on
    rb_wg_conv, relu(bn2(r2)) formed once) against the plain forward: y
    within 2 bf16 ulps of max |y| (or 1e-2 abs), r1, r2 and the BN vectors
    normwise within 1e-2, the statistics within 1e-3; each launch counted
    on its body; a rerun bit-equal. The smallest ring of these bodies is
    F1's three stages at f32 x; the f32 case at layer4 width wraps it over
    32 K steps."""
    args = _block_args(N, H, W, C4, C, dtype, cuda, seed=5)
    before = dict(trb.fused_bottleneck_fwd.routes)
    y, res, stats = trb.fused_bottleneck_fwd(*args)
    took = {r: c - before[r]
            for r, c in trb.fused_bottleneck_fwd.routes.items()}
    assert took == FWD_ROUTES
    y2, res2, stats2 = trb.fused_bottleneck_fwd(*args)
    y_ref, res_ref, stats_ref = trb.fused_bottleneck_fwd_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.isfinite(y).all()
    assert (y.float() - y_ref.float()).abs().max().item() <= _y_tol(y_ref)
    for a, b in zip(res[1:3] + res[7:10], res_ref[1:3] + res_ref[7:10]):
        assert _normwise(a, b) <= 1e-2
    for pair, pair_ref in zip(stats, stats_ref):
        for a, b in zip(pair, pair_ref):
            assert _normwise(a, b) <= 1e-3
    assert torch.equal(y, y2)
    for a, b in zip(res[1:3] + res[7:10], res2[1:3] + res2[7:10]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_forward_kinds_refuse_what_they_do_not_admit(cuda, dtype):
    """A width past the 3x3 body's staged halo returns
    cudaErrorInvalidValue at the C entry (no other body takes it)."""
    args = _block_args(1, 2, 2000, 64, 16, dtype, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        trb.fused_bottleneck_fwd(*args)


@pytest.mark.parametrize("N,H,W,C4,C,dtype", [
    (5, 9, 11, 256, 64, torch.bfloat16),    # ragged M = 495; tiles span
                                            # images
    (3, 6, 5, 2048, 512, torch.bfloat16),   # ragged M = 90 at C = 512
    (2, 20, 20, 512, 128, torch.bfloat16),  # 128-wide tiles of N = C
    (1, 3, 130, 256, 64, torch.bfloat16),   # a halo wider than a tile
    (2, 8, 8, 512, 128, torch.float32),     # f32: rings of one or two
                                            # stages over two K steps and
                                            # two row chunks
])
def test_fused_resblock_backward_matches_plain_on_hopper_tiles(cuda, N, H, W,
                                                              C4, C, dtype):
    """The backward's Hopper bodies (row products on 128-row tiles, the
    3x3 conv from a staged halo, the weight gradients by row chunks)
    against the plain backward on the kernels' residuals: each of the ten
    gradients normwise within 1e-2; fourteen launches a call; a rerun
    bit-equal."""
    args = _block_args(N, H, W, C4, C, dtype, cuda, seed=3)
    dy = torch.randn(N, H, W, C4, generator=torch.Generator().manual_seed(4)
                     ).to(dtype).to(cuda)
    _, res, _ = trb.fused_bottleneck_fwd(*args)
    before = trb.fused_bottleneck_bwd.launches
    grads = trb.fused_bottleneck_bwd(res, dy)
    assert trb.fused_bottleneck_bwd.launches - before == 14
    again = trb.fused_bottleneck_bwd(res, dy)
    same_res = trb.fused_bottleneck_bwd_ref(res, dy)
    torch.cuda.synchronize()
    names = "dx dw1 dw2 dw3 dg1 dbe1 dg2 dbe2 dg3 dbe3".split()
    for name, a, b, c in zip(names, grads, same_res, again):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _normwise(a, b) <= 1e-2, (name, _normwise(a, b))
        assert torch.equal(a, c), name


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_fused_resblock_kernels_refuse_other_dtypes(cuda, dtype):
    args = _block_args(2, 4, 4, 32, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        trb.fused_bottleneck_fwd(args[0].to(dtype), *args[1:])


def test_fused_resblock_autograd_matches_plain(cuda):
    """`fused_block_impl` on OIHW conv weights (the model's entry): the
    kernels' gradients through autograd against the plain versions'."""
    N, H, W, C4, C = 2, 6, 6, 64, 16
    x, w1, w2, w3, *vecs = _block_args(N, H, W, C4, C, torch.bfloat16, cuda)
    cw = [w1.t()[:, :, None, None], w2.permute(3, 2, 0, 1),
          w3.t()[:, :, None, None]]
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, *cw, *vecs)]
        y = trb.fused_block_impl(*leaves, eps=1e-5)[0]
        (y.float() * torch.linspace(-1, 1, y.numel(), device=dev
                                    ).reshape(y.shape)).sum().backward()
        outs.append([y] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert a.shape == b.shape
        assert _normwise(a.cpu(), b) <= 1e-2


def test_bottleneck_block_routes_by_mode(cuda, monkeypatch):
    """Mode "1" with a bf16 CUDA input: one forward and one backward call
    of the fused kernels a block call; mode "0": none; an f32 input in
    mode "1" keeps the per-op route."""
    from paddle_tpu_torch.models.resnet import BottleneckBlock

    blk = BottleneckBlock(256, 64, data_format="NHWC", device=cuda)
    x = torch.randn(2, 8, 8, 256, device=cuda)
    for mode, dtype, want in (("1", torch.bfloat16, 1), ("0", torch.bfloat16,
                                                          0),
                              ("1", torch.float32, 0)):
        monkeypatch.setenv("PADDLE_TPU_FUSED_RESBLOCK", mode)
        before = (trb.fused_bottleneck_fwd.calls,
                  trb.fused_bottleneck_bwd.calls)
        y = blk.to(dtype)(x.to(dtype))
        y.float().sum().backward()
        assert (trb.fused_bottleneck_fwd.calls - before[0],
                trb.fused_bottleneck_bwd.calls - before[1]) == (want, want)
        blk.zero_grad()


def test_parallelize_trains_tiny_resnet_through_fused_blocks(cuda,
                                                             monkeypatch):
    """A tiny ResNet (blocks [2, 1, 1, 1]: one identity block) trained 3
    steps in bf16 through `parallelize` on each route from the same
    weights: one fused forward and backward call a step on the fused
    route, none on the per-op route; finite, falling losses within 2e-2
    of the first loss of each other (bf16 rounding at other places; by
    step 3 the loss is a fiftieth of the first, so a relative gate there
    would measure noise)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.optimizer import Momentum

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 32, 32, 3, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    runs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_FUSED_RESBLOCK", mode)
        m = ResNet(BottleneckBlock, [2, 1, 1, 1], num_classes=10,
                   data_format="NHWC", device=cuda, seed=3)
        eng = parallelize(
            m, Momentum(learning_rate=1e-4, momentum=0.9,
                        parameters=m.parameters()),
            loss_fn=lambda m, a, b: TF.cross_entropy(m(a), b).mean(),
            compute_dtype="bfloat16")
        before = trb.fused_bottleneck_fwd.calls
        losses = eng.train_batches([(x, y)] * 3).float().cpu()
        runs[mode] = (losses, trb.fused_bottleneck_fwd.calls - before,
                      m.layer1[1].bn1._mean.clone())
    assert runs["1"][1] == 3 and runs["0"][1] == 0
    for losses, _, mean in runs.values():
        assert torch.isfinite(losses).all() and losses[-1] < losses[0]
        assert mean.abs().sum() > 0 and mean.dtype == torch.float32
    first = runs["0"][0][0].item()
    torch.testing.assert_close(runs["1"][0], runs["0"][0], rtol=0,
                               atol=2e-2 * first)


# --- ring-step (position-masked) flash kernels --------------------------------

def _pos_span(*spans):
    return torch.cat([torch.arange(lo, hi + 1) for lo, hi in
                      zip(spans[::2], spans[1::2])]).to(torch.int32)


def _pos_perm(n, m, seed):
    return torch.randperm(n, generator=torch.Generator().manual_seed(
        seed))[:m].int()


# name -> (q positions, k positions, causal, D): rank 0 of a 2-way zigzag
# ring (S = 512) on its own and the visiting shard; a contiguous shard
# whose keys all lie in its future; no mask; ragged lengths with
# shuffled positions and a padded head dim (the mma.sync bodies); then
# cases of the Hopper route (bf16, shards of one length): zigzag runs of
# 64 (rank 0 of a 4-way ring at S = 512: one 128-row tile straddles both
# runs) and of 192 (a 2-way ring at S = 768: the middle tile straddles
# them), shuffled positions of one length, a tile that mixes rows that see
# keys with rows that see none, a shard wholly in the future at D = 128
POS_KERNEL_CASES = {
    "zigzag own": (_pos_span(0, 127, 384, 511), _pos_span(0, 127, 384, 511),
                   True, 64),
    "zigzag visiting": (_pos_span(0, 127, 384, 511), _pos_span(128, 383),
                        True, 64),
    "fully masked": (_pos_span(0, 255), _pos_span(256, 511), True, 64),
    "full D=128": (_pos_span(0, 255), _pos_span(256, 511), False, 128),
    "shuffled ragged D=80": (_pos_perm(400, 200, 1), _pos_perm(400, 136, 2),
                             True, 80),
    "runs of 64 own D=128": (_pos_span(0, 63, 448, 511),
                             _pos_span(0, 63, 448, 511), True, 128),
    "runs of 64 visiting D=64": (_pos_span(0, 63, 448, 511),
                                 _pos_span(64, 127, 384, 447), True, 64),
    "runs of 192 own D=64": (_pos_span(0, 191, 576, 767),
                             _pos_span(0, 191, 576, 767), True, 64),
    "runs of 192 visiting D=128": (_pos_span(0, 191, 576, 767),
                                   _pos_span(192, 575), True, 128),
    "shuffled equal D=64": (_pos_perm(400, 200, 3), _pos_perm(400, 200, 4),
                            True, 64),
    "shuffled equal D=128": (_pos_perm(600, 256, 5), _pos_perm(600, 256, 6),
                             True, 128),
    "mixed tile D=128": (_pos_span(0, 255), _pos_span(100, 355), True, 128),
    "mixed tile D=64": (_pos_span(0, 255), _pos_span(100, 355), True, 64),
    "future D=128": (_pos_span(0, 255), _pos_span(256, 511), True, 128),
    "full shuffled D=64": (_pos_perm(400, 200, 7), _pos_perm(400, 200, 8),
                           False, 64),
}


def _pos_counts():
    return [(w.launches, dict(w.routes)) for w in (
        tfa.flash_fwd_pos, tfa.flash_bwd_pos_dq, tfa.flash_bwd_pos_dkv)]


def _pos_hopper(dtype, q_pos, k_pos, D):
    """Whether a ring step of these operands (contiguous bf16 or f32)
    takes the Hopper bodies: bf16, 32 < D <= 128, D % 8 == 0, one
    length."""
    return (dtype == torch.bfloat16 and len(q_pos) == len(k_pos)
            and 32 < D <= 128 and D % 8 == 0)


def _pos_case(q_pos, k_pos, D, dtype, seed, B=2, H=3):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(B, len(q_pos), H, D, generator=g).to(dtype).cuda()
             for _ in range(2))
    k, v = (torch.randn(B, len(k_pos), H, D, generator=g).to(dtype).cuda()
            for _ in range(2))
    return q, k, v, do, q_pos.cuda(), k_pos.cuda()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(POS_KERNEL_CASES))
def test_flash_pos_kernels_match_plain(cuda, dtype, case):
    """flash_fwd_pos, flash_dq_pos and flash_dkv_pos against their plain
    versions (the backward kernels on the plain forward's lse and delta):
    O to FLASH_TOL, rows that see no key O == 0 exactly with lse <= -1e29
    and no NaN, gradients normwise (exactly 0 where no pair is kept). Each
    call counts one launch on the route `flash_pos_route` names: the
    Hopper bodies for bf16 shards of one length, the mma.sync bodies
    otherwise."""
    q_pos, k_pos, causal, D = POS_KERNEL_CASES[case]
    tol, grad_tol = FLASH_TOL[dtype]
    q, k, v, do, qp, kp = _pos_case(q_pos, k_pos, D, dtype, seed=D)
    hopper = _pos_hopper(dtype, q_pos, k_pos, D)
    assert tfa.flash_pos_route(q, k, v)[0] == (
        tfa.FWD_WGMMA if hopper else tfa.FWD_MMA)
    route = tfa.BWD_WGMMA if hopper else tfa.BWD_MMA
    assert tfa.flash_pos_route(q, k, v, do)[0] == route
    counts = _pos_counts()
    out, lse = tfa.flash_fwd_pos(q, k, v, qp, kp, causal=causal)
    ref, lse_ref = tfa.flash_fwd_pos_ref(q, k, v, qp, kp, causal=causal)
    seen = ((qp[:, None] >= kp[None, :]).any(1) if causal
            else torch.ones(len(qp), dtype=torch.bool, device=cuda))
    if seen.any():
        assert _err(out[:, seen], ref[:, seen]) <= tol
        assert (lse - lse_ref)[..., seen].abs().max().item() <= (
            1e-2 if tol > 1e-3 else 1e-4)
    assert (out[:, ~seen] == 0).all() and torch.isfinite(lse).all()
    assert (lse[..., ~seen] <= -1e29).all()
    delta = tfa.attention_delta(ref, do)
    dq, dk, dv = tfa.flash_bwd_pos(q, k, v, do, lse_ref, delta, qp, kp,
                                   causal=causal)
    refs = tfa.flash_bwd_pos_ref(q, k, v, do, lse_ref, delta, qp, kp,
                                 causal=causal)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all(), name
        if r.abs().max() == 0:
            assert (got == 0).all(), name
        else:
            assert _norm_err(got, r) <= grad_tol, (name, _norm_err(got, r))
    fwd_route = tfa.FWD_WGMMA if hopper else tfa.FWD_MMA
    for (n0, r0), (n1, r1), rt in zip(counts, _pos_counts(),
                                      (fwd_route, route, route)):
        assert (n1, r1) == (n0 + 1, {**r0, rt: r0[rt] + 1})


@pytest.mark.parametrize("case", ["zigzag visiting", "runs of 64 own D=128",
                                  "runs of 192 own D=64"])
def test_flash_pos_kernels_are_bitwise_reproducible(cuda, case):
    """Two eager runs bit for bit, on the Hopper route; then 64 ring
    steps (forward, dQ, dK/dV) in one CUDA graph replayed 3 times, each
    bit-equal to the eager run (the skipped and the published blocks,
    launch after launch)."""
    q_pos, k_pos, _, D = POS_KERNEL_CASES[case]
    q, k, v, do, qp, kp = _pos_case(q_pos, k_pos, D, torch.bfloat16, seed=9)
    counts = _pos_counts()
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_fwd_pos(q, k, v, qp, kp)
        delta = tfa.attention_delta(out, do)
        runs.append((out, lse, *tfa.flash_bwd_pos(q, k, v, do, lse, delta,
                                                  qp, kp)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    hopper = (tfa.FWD_WGMMA, tfa.BWD_WGMMA, tfa.BWD_WGMMA)
    assert [r[rt] - r0[rt] for (_, r0), (_, r), rt in zip(
        counts, _pos_counts(), hopper)] == [2, 2, 2]
    lse, delta = runs[0][1], tfa.attention_delta(runs[0][0], do)

    def step():
        return (*tfa.flash_fwd_pos(q, k, v, qp, kp),
                *tfa.flash_bwd_pos(q, k, v, do, lse, delta, qp, kp))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [step() for _ in range(64)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        bad = [i for i, o in enumerate(outs)
               if not all(torch.equal(a, b) for a, b in zip(o, runs[0]))]
        assert not bad, f"{len(bad)} of 64 steps differ"


@pytest.mark.parametrize("kind", [3, 4, 5])
def test_flash_pos_hopper_kinds_refuse_unequal_shards(cuda, kind):
    """Asked for a Hopper body on shards of two lengths, the ring step's C
    entry refuses (cudaErrorInvalidValue) instead of running another
    body."""
    q_pos, k_pos = _pos_perm(400, 200, 1), _pos_perm(400, 136, 2)
    q, k, v, do, qp, kp = _pos_case(q_pos, k_pos, 64, torch.bfloat16, seed=1)
    _, ops, ptrs, strides = tfa.flash_pos_route(q, k, v, do)
    lse = torch.zeros(2, 3, 200, device=cuda)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfa._launch_pos(kind, q, k, ptrs, strides, lse, lse, out, out, lse,
                        qp, kp, True, 0.125)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal,balanced", [(True, True), (True, False),
                                             (False, False)])
def test_serial_ring_matches_whole_sequence_kernels(cuda, n, causal,
                                                    balanced):
    """The ring's n steps run in one process through the pos kernels and
    the merge (`ring_serial`), bf16. Against the same ring through the
    kernels' plain versions: O to FLASH_TOL, and the backward kernels on
    the plain ring's forward statistics (as each kernel is held alone) to
    FLASH_TOL. Against the whole-sequence flash kernels: O to FLASH_TOL,
    the gradients normwise to (n + 1) bf16 roundings, 2**-9 each — every
    step's dq, dk, dv is rounded to bf16 (the TPU kernel's out dtype)
    before the f32 sum, where the whole-sequence kernel rounds once
    (readings on an H100 1.2e-3 to 3.0e-3). The same ring with the
    visiting partial's merge weight dropped must fail that gradient
    gate. Every ring step of the kernels' ring runs on the Hopper bodies
    (n forwards, n dQ and n dK/dV a rank)."""
    from paddle_tpu_torch.distributed import context_parallel as cpm
    from paddle_tpu_torch.distributed.context_parallel import ring_serial

    tol, grad_tol = FLASH_TOL[torch.bfloat16]
    q, k, v, do = _flash_case(2, 1024, 4, 64, torch.bfloat16, seed=n)
    kw = dict(causal=causal, balanced=balanced)
    counts = _pos_counts()
    got, _ = ring_serial(q, k, v, do, n, **kw)
    hopper = (tfa.FWD_WGMMA, tfa.BWD_WGMMA, tfa.BWD_WGMMA)
    assert [(n1 - n0, r[rt] - r0[rt]) for (n0, r0), (n1, r), rt in zip(
        counts, _pos_counts(), hopper)] == [(n * n, n * n)] * 3
    plain, stats = ring_serial(q, k, v, do, n, fwd=tfa.flash_fwd_pos_ref,
                               bwd=tfa.flash_bwd_pos_ref, **kw)
    bwd_alone, _ = ring_serial(q, k, v, do, n, stats=stats, **kw)
    assert _err(got[0], plain[0]) <= tol
    for name, g, w in zip(("dq", "dk", "dv"), bwd_alone[1:], plain[1:]):
        assert _norm_err(g, w) <= grad_tol, (name, _norm_err(g, w))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    delta = tfa.attention_delta(out, do)
    want = (out, tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                            causal=causal),
            *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal))
    assert _err(got[0], want[0]) <= tol
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert _norm_err(g, w) <= (n + 1) * 2.0 ** -9, (name,
                                                         _norm_err(g, w))

    def dropped_weight_merge(out, lse, o_blk, lse_blk):
        lse_new = torch.logaddexp(lse, lse_blk)
        w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
        return out * w_old + o_blk.float(), lse_new

    merge, cpm._merge_partial = cpm._merge_partial, dropped_weight_merge
    try:
        bad, _ = ring_serial(q, k, v, do, n, **kw)
    finally:
        cpm._merge_partial = merge
    assert max(_norm_err(g, w) for g, w in zip(bad[1:], want[1:])) > (
        (n + 1) * 2.0 ** -9)


# --- the row-stable float GEMV of the decode buckets ----------------------------

@pytest.mark.parametrize("dtype,k", [(torch.bfloat16, 4096),
                                     (torch.bfloat16, 11008),
                                     (torch.bfloat16, 550),
                                     (torch.float16, 4096),
                                     (torch.float32, 768)])
@pytest.mark.parametrize("bias", [False, True])
def test_row_gemv_matches_plain_and_is_row_stable(cuda, dtype, k, bias):
    """Against the plain version (bf16 / f16: 2 ulps of the largest
    output; f32 1e-4), at every decode row count, on the body
    `row_gemv_route` names (the tensor-core body for bf16 / f16 at
    k % 64 == 0, the CUDA-core body for f32 and the ragged k = 550),
    counted in `.routes`; the first rows of a call of 16 equal a call of
    1, 2, 3, 4 and 8 bit for bit (n = 333: a ragged last column group)."""
    from paddle_tpu_torch.ops.weight_only import (ROW_MMA, ROW_CUDA_CORE,
                                                  row_gemv, row_gemv_ref)

    g = torch.Generator().manual_seed(k)
    n = 333
    w = (torch.randn(n, k, generator=g) * 0.05).to(dtype).to(cuda)
    b = (torch.randn(n, generator=g).to(dtype).to(cuda) if bias else None)
    x = torch.randn(16, k, generator=g).to(dtype).to(cuda)
    want = (ROW_MMA if dtype != torch.float32 and k % 64 == 0
            else ROW_CUDA_CORE)
    full = row_gemv(x, w, b)
    for m in (1, 2, 3, 4, 8, 16):
        before = row_gemv.launches, dict(row_gemv.routes)
        got = row_gemv(x[:m], w, b)
        assert row_gemv.launches == before[0] + 1
        assert row_gemv.routes[want] == before[1][want] + 1
        ref = row_gemv_ref(x[:m], w, b)
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
            tol = 2 * ulp * ref.float().abs().max().item()
            assert (got.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(got, full[:m]), m
    with pytest.raises(ValueError):
        row_gemv(x.repeat(2, 1), w, b)


@pytest.mark.parametrize("case", ["f32", "ragged_k", "misaligned_x",
                                  "rows"])
def test_row_gemv_tensor_core_body_refuses_what_it_does_not_admit(cuda,
                                                                  case):
    """The C entry asked for the tensor-core body on inputs it does not
    admit returns cudaErrorInvalidValue and launches nothing (no other
    body runs in its place): the output keeps its NaNs."""
    from paddle_tpu_torch.ops.weight_only import ROW_MMA

    dtype = torch.float32 if case == "f32" else torch.bfloat16
    k = 550 if case == "ragged_k" else 512
    m = 17 if case == "rows" else 4
    w = torch.randn(64, k, device=cuda).to(dtype)
    x = torch.randn(m * k + 8, device=cuda).to(dtype)
    xp = x.data_ptr() + (2 if case == "misaligned_x" else 0)
    out = torch.full((m, 64), float("nan"), device=cuda, dtype=dtype)
    _, stream = _build.launch_on(x.device)
    err = _build.lib().ptt_row_gemv(xp, w.data_ptr(), None, out.data_ptr(),
                                    m, 64, k, _build.dtype_code(dtype),
                                    ROW_MMA, stream)
    torch.cuda.synchronize()
    assert err == 1            # cudaErrorInvalidValue
    assert torch.isnan(out).all()


def test_decode_step_logits_equal_across_batch_sizes(cuda):
    """The bf16 llama-shaped paged decode step: a sequence's logits are
    the same bits in a batch of n (1, 2, 4) as in a batch of 8 — every
    float Linear and the untied lm_head through the row-stable GEMV."""
    from paddle_tpu_torch.models.gpt import PagedBatch
    from paddle_tpu_torch.ops.weight_only import row_gemv

    model = gpt("llama2_7b", device=cuda, dtype="bfloat16", seed=0,
                num_layers=2, hidden_size=512, num_heads=8, num_kv_heads=4,
                intermediate_size=1376, vocab_size=4000)
    model.eval()
    bs, nb = 16, 8
    pool = model.init_block_pool(8 * nb + 1, bs)
    g = torch.Generator(device=cuda).manual_seed(3)
    for layer in pool.tensors:
        for t in layer:
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    tables = (1 + torch.arange(8 * nb, device=cuda, dtype=torch.int32)
              ).reshape(8, nb)
    pos = torch.tensor([5, 17, 100, 63, 0, 31, 90, 44], dtype=torch.int32,
                       device=cuda)
    ids = torch.randint(0, 4000, (8, 1), generator=g, device=cuda)

    def step(n):
        layers = [tuple(t.clone() for t in layer) for layer in pool.tensors]
        with torch.no_grad():
            return model.decode_step_paged(
                ids[:n], layers, PagedBatch.decode(tables[:n], pos[:n], bs))

    before = row_gemv.launches
    full = step(8)
    # qkv, out, gate_up, down per layer, and the lm_head
    assert row_gemv.launches - before == 2 * 4 + 1
    for n in (1, 2, 4):
        assert torch.equal(step(n), full[:n]), n


# ------------------------------------------------ block-sparse attention

def _bs_tables(nq, seed, empty=()):
    """A BigBird-like block pattern (window, first/last global blocks, two
    random blocks a row) as csr_to_block_tables returns it; the query
    blocks in `empty` list nothing."""
    g = torch.Generator().manual_seed(seed)
    bm = torch.zeros(nq, nq, dtype=torch.bool)
    for i in range(nq):
        for j in (i - 1, i, i + 1, 0, nq - 1):
            if 0 <= j < nq:
                bm[i, j] = True
        bm[i, torch.randint(0, nq, (2,), generator=g)] = True
    bm[0] = bm[-1] = True
    for i in empty:
        bm[i] = False
    cnt = bm.sum(1).to(torch.int32)
    idx = torch.zeros(nq, max(int(cnt.max()), 1), dtype=torch.int32)
    for i in range(nq):
        cols = torch.nonzero(bm[i]).flatten()
        idx[i, :len(cols)] = cols.to(torch.int32)
    return idx, cnt


BS_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("BH,S,D", [(3, 1024, 64), (2, 512, 128),
                                    (2, 384, 40), (1, 256, 256)])
def test_block_sparse_kernel_matches_plain(cuda, dtype, BH, S, D):
    """O max abs error 2e-2 (bf16) / 1e-4 (f32), the flash rows' gates: the
    kernel casts unnormalised p to bf16 and divides at the end, the plain
    version normalises first. A query block that lists nothing gives 0."""
    nq = S // 128
    idx, cnt = _bs_tables(nq, seed=S + D, empty=(1,))
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(BH, S, D, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    idx, cnt = idx.to(cuda), cnt.to(cuda)
    before = tbs.block_sparse_attention.launches
    got = tbs.block_sparse_attention(q, k, v, idx, cnt, D ** -0.5, 128)
    assert tbs.block_sparse_attention.launches == before + 1
    ref = tbs.block_sparse_attention_ref(q, k, v, idx, cnt, D ** -0.5, 128)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() <= BS_TOL[dtype]
    assert torch.equal(got[:, 128:256], torch.zeros_like(got[:, 128:256]))


def test_block_sparse_kernel_planted_fault_fails_the_gate(cuda):
    """The kernel run over block_cnt - 1 blocks must break the bf16 gate."""
    idx, cnt = _bs_tables(8, seed=1)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(4, 1024, 64, generator=g).to(torch.bfloat16
                                                         ).to(cuda)
               for _ in range(3))
    idx, cnt = idx.to(cuda), cnt.to(cuda)
    ref = tbs.block_sparse_attention_ref(q, k, v, idx, cnt, 0.125, 128)
    bad = tbs._launch(q, k, v, idx, (cnt - 1).clamp_min(0), 0.125, 128)
    assert (bad.float() - ref.float()).abs().max().item() > 10 * BS_TOL[
        torch.bfloat16]


def test_block_sparse_kernel_refuses_what_it_cannot_take(cuda):
    idx, cnt = (t.to(cuda) for t in _bs_tables(2, seed=0))
    q = torch.zeros(1, 256, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tbs.block_sparse_attention(q, q, q, idx, cnt, 1.0, 128)
    q = torch.zeros(1, 256, 320, device=cuda)
    with pytest.raises(ValueError):
        tbs.block_sparse_attention(q, q, q, idx, cnt, 1.0, 128)
    q = torch.zeros(1, 256, 64, device=cuda)
    idx4 = torch.zeros(4, 1, dtype=torch.int32, device=cuda)
    cnt4 = torch.ones(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tbs.block_sparse_attention(q, q, q, idx4, cnt4, 1.0, 64)


# the Hopper body's gate (chip_smoke.py's BS_TOL): |O| is about 0.03-0.1
# here, so 8e-3 is several bf16 ulps of the largest outputs
BS_HOPPER_TOL = 8e-3


def _bs_hopper_case(cuda, BH, S, D, seed, empty=(), bad_index=None):
    """q, k, v bf16 [BH, S, D], the kernel's table and the plain version's
    on the card (ragged counts; the query blocks in `empty` list nothing;
    `bad_index` = (row, value) appends an index outside [0, S / 128) to
    that row of the kernel's table only: the kernel skips it, and the
    plain version, which would not, reads the table without it)."""
    idx, cnt = _bs_tables(S // 128, seed=seed, empty=empty)
    kidx, kcnt = idx, cnt
    if bad_index is not None:
        row, val = bad_index
        kidx = torch.cat([idx, torch.zeros(idx.shape[0], 1,
                                           dtype=torch.int32)], 1)
        kcnt = cnt.clone()
        kidx[row, kcnt[row]] = val
        kcnt[row] += 1
    g = torch.Generator().manual_seed(seed + D)
    q, k, v = (torch.randn(BH, S, D, generator=g).to(torch.bfloat16).to(cuda)
               for _ in range(3))
    return (q, k, v, kidx.to(cuda), kcnt.to(cuda), idx.to(cuda),
            cnt.to(cuda))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["ragged", "empty", "out_of_range"])
def test_block_sparse_hopper_body_matches_plain(cuda, D, case):
    """bf16 at D = 64 and 128 runs the flash forward's Hopper body under
    the block-table policy (`bs_fwd_sm90`, one launch, route BS_WGMMA):
    O within 8e-3 of the plain version on ragged counts, an empty query
    block exactly 0, an index outside [0, S / 128) skipped."""
    S, BH = 1024, 5
    q, k, v, kidx, kcnt, idx, cnt = _bs_hopper_case(
        cuda, BH, S, D, seed=7, empty=(2,) if case == "empty" else (),
        bad_index=(3, S // 128 + 5) if case == "out_of_range" else None)
    assert tbs.block_sparse_route(q, k, v, D ** -0.5) == tbs.BS_WGMMA
    before = dict(tbs.block_sparse_attention.routes)
    got = tbs.block_sparse_attention(q, k, v, kidx, kcnt, D ** -0.5, 128)
    assert tbs.block_sparse_attention.routes == {
        **before, tbs.BS_WGMMA: before[tbs.BS_WGMMA] + 1}
    ref = tbs.block_sparse_attention_ref(q, k, v, idx, cnt, D ** -0.5, 128)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - ref.float()).abs().max().item() <= BS_HOPPER_TOL
    if case == "empty":
        assert torch.equal(got[:, 256:384], torch.zeros_like(got[:, 256:384]))


@pytest.mark.parametrize("D", [64, 128])
def test_block_sparse_hopper_rows_do_not_depend_on_the_order(cuda, D):
    """The query tiles permuted (q's row blocks and the table's rows):
    every tile's output moves with it bit for bit, whichever CTA takes it
    and when; reruns are bit-equal."""
    S, BH = 2048, 6
    q, k, v, idx, cnt = _bs_hopper_case(cuda, BH, S, D, seed=11)[:5]
    nq = S // 128
    perm = torch.randperm(nq, generator=torch.Generator().manual_seed(3))
    perm = perm.to(cuda)
    got = tbs.block_sparse_attention(q, k, v, idx, cnt, D ** -0.5, 128)
    again = tbs.block_sparse_attention(q, k, v, idx, cnt, D ** -0.5, 128)
    blocks = (BH, nq, 128, D)
    qp = q.view(blocks)[:, perm].reshape(BH, S, D)
    outp = tbs.block_sparse_attention(qp, k, v, idx[perm].contiguous(),
                                      cnt[perm].contiguous(), D ** -0.5, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(outp.view(blocks), got.view(blocks)[:, perm])


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 40, 1), (torch.bfloat16, 32, 0),
    (torch.bfloat16, 256, 0), (torch.float32, 64, 0),
    (torch.float32, 128, 0)])
def test_block_sparse_route_by_dtype_and_head_dim(cuda, dtype, D, want):
    """BS_WGMMA (1) for bf16 at 32 < D <= 128, BS_MMA (0) for f32, D <= 32
    and D = 256; each call counts one launch on the body it names and
    agrees with the plain version."""
    idx, cnt = (t.to(cuda) for t in _bs_tables(4, seed=D))
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(2, 512, D, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    assert tbs.block_sparse_route(q, k, v, D ** -0.5) == want
    before = dict(tbs.block_sparse_attention.routes)
    got = tbs.block_sparse_attention(q, k, v, idx, cnt, D ** -0.5, 128)
    assert tbs.block_sparse_attention.routes == {
        **before, want: before[want] + 1}
    ref = tbs.block_sparse_attention_ref(q, k, v, idx, cnt, D ** -0.5, 128)
    torch.cuda.synchronize()
    tol = BS_HOPPER_TOL if dtype == torch.bfloat16 else BS_TOL[dtype]
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_block_sparse_hopper_entry_refuses_what_it_cannot_take(cuda):
    """Asked for the Hopper body (route 1) on f32, D = 256 or without its
    scratch, the C entry refuses (cudaErrorInvalidValue) rather than run
    another body."""
    import ctypes

    idx, cnt = (t.to(cuda) for t in _bs_tables(2, seed=0))
    scratch = torch.zeros(3, dtype=torch.int32, device=cuda)
    for dtype, D, scr in ((torch.float32, 64, scratch),
                          (torch.bfloat16, 256, scratch),
                          (torch.bfloat16, 64, None)):
        q = torch.zeros(1, 256, D, device=cuda, dtype=dtype)
        err = _build.lib().ptt_block_sparse_attention(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), idx.data_ptr(),
            cnt.data_ptr(), q.data_ptr(),
            None if scr is None else scr.data_ptr(), 1, 256, D, 1,
            _build.dtype_code(dtype), tbs.BS_WGMMA, ctypes.c_float(0.125),
            torch.cuda.current_stream().cuda_stream)
        assert err != 0, (dtype, D)


def test_sparse_attention_routes_through_the_kernel(cuda):
    """A shared exact 128-tile CSR: one kernel launch per forward; the
    gradients are the plain route's (the backward is autograd through the
    plain version on the saved inputs, as the reference's)."""
    from paddle_tpu_torch.nn.functional import sparse_attention

    B, H, S, D = 1, 2, 512, 64
    idx, cnt = _bs_tables(S // 128, seed=4)
    mask = torch.zeros(S, S, dtype=torch.bool)
    for i in range(S // 128):
        for j in idx[i, :cnt[i]].tolist():
            mask[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = True
    offset = torch.cat([torch.zeros(1, dtype=torch.long),
                        mask.sum(1).cumsum(0)]).expand(B, H, S + 1)
    columns = torch.nonzero(mask)[:, 1].expand(B, H, -1)
    g = torch.Generator().manual_seed(5)
    leaves = [torch.randn(B, H, S, D, generator=g).to(cuda).requires_grad_()
              for _ in range(3)]
    before = tbs.block_sparse_attention.launches
    out = sparse_attention(*leaves, offset, columns)
    assert tbs.block_sparse_attention.launches == before + 1
    out.sum().backward()
    ref = tbs.block_sparse_attention_ref(
        *(t.detach().reshape(B * H, S, D) for t in leaves), idx.to(cuda),
        cnt.to(cuda), D ** -0.5, 128).reshape(B, H, S, D)
    assert (out.detach() - ref).abs().max().item() <= 1e-4
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    tbs.block_sparse_attention_ref(
        *(t.reshape(B * H, S, D) for t in plain), idx.to(cuda),
        cnt.to(cuda), D ** -0.5, 128).sum().backward()
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


# ------------------------------------------- dense (contiguous-cache) decode

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("T,pos", [(300, 299), (300, 17), (4096, 2000)])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_matches_plain(cuda, int8, H, Hkv, T, pos,
                                           qdtype):
    """The paged kernel (the cache as one block a sequence) against
    `decode_attention_ref`: f32 1e-5 abs (online and split softmax against
    a two-pass softmax, all in f32), bf16 output 1e-2 (one bf16 rounding
    of |O| <~ 2). Keys past pos are poisoned and must not count."""
    from paddle_tpu_torch.ops.decode_attn import (decode_attention,
                                                  decode_attention_ref)

    g = torch.Generator().manual_seed(T + pos + H)
    B, D = 3, 128
    q = torch.randn(B, 1, H, D, generator=g).to(qdtype)
    k = torch.randn(B, Hkv, T, D, generator=g)
    v = torch.randn(B, Hkv, T, D, generator=g)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = 1e4
    if int8:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        ks, vs = ks[..., None], vs[..., None]
    else:
        kq, vq = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ks = vs = torch.ones(B, Hkv, T, 1)
    args = [t.to(cuda) for t in (q, kq, ks, vq, vs)]
    before = decode_attention.launches
    got = decode_attention(*args, pos)
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(*args, pos)
    torch.cuda.synchronize()
    tol = 1e-5 if qdtype == torch.float32 else 1e-2
    assert got.dtype == qdtype
    assert (got.float() - ref.float()).abs().max().item() <= tol
    assert got.float().abs().max().item() < 100.0


def test_dense_decode_kernel_refuses_what_it_cannot_take(cuda):
    from paddle_tpu_torch.ops.decode_attn import decode_attention

    q = torch.zeros(1, 1, 4, 64, device=cuda)
    kv = torch.zeros(1, 4, 16, 64, device=cuda)
    ones = torch.ones(1, 4, 16, 1, device=cuda)
    with pytest.raises(TypeError):                  # bf16 scales
        decode_attention(q, kv, ones.bfloat16(), kv, ones.bfloat16(), 3)
    with pytest.raises(ValueError):                 # K and V strides differ
        decode_attention(q, kv, ones, kv.transpose(2, 3).contiguous(
        ).transpose(2, 3), ones, 3)


# ------------------------------------------- two blocks, k4 -> k1 coupled

@pytest.mark.parametrize("N,H,W,C4,C,dtype", [
    (2, 8, 8, 64, 16, torch.bfloat16),       # two 64-row tiles, C < 64
    (6, 4, 4, 16, 8, torch.bfloat16),        # M = 96: a ragged tile, C = 8
    (3, 5, 7, 256, 64, torch.float32),       # f32 input, bf16 operands
    (2, 56, 56, 256, 64, torch.bfloat16),    # ResNet-50 layer1
    (2, 28, 28, 512, 128, torch.bfloat16),   # layer2
    (4, 14, 14, 1024, 256, torch.bfloat16),  # layer3
    (8, 7, 7, 2048, 512, torch.bfloat16),    # layer4
    (3, 5, 7, 1024, 256, torch.float32),     # M = 105, f32, C = 256
    (1, 9, 7, 2048, 512, torch.float32),     # M = 63, f32, C = 512
])
def test_fused_pair_kernel_matches_plain(cuda, N, H, W, C4, C, dtype):
    """y2 within 2 bf16 ulps of max |y2| (or 1e-2 abs), as the one-block
    forward; one call a pair, fifteen launches counted at the launches;
    bit-equal reruns (fixed-order sums). Fifteen launches: the coupled
    rb_wg_k41 once, the other products on the Hopper bodies."""
    a1 = _block_args(N, H, W, C4, C, dtype, cuda, seed=1)
    a2 = _block_args(N, H, W, C4, C, dtype, cuda, seed=2)
    x, p1, p2 = a1[0], a1[1:], a2[1:]
    before = (trb.fused_bottleneck2_fwd.calls,
              trb.fused_bottleneck2_fwd.launches,
              dict(trb.fused_bottleneck2_fwd.routes))
    y2 = trb.fused_bottleneck2_fwd(x, p1, p2)
    assert (trb.fused_bottleneck2_fwd.calls,
            trb.fused_bottleneck2_fwd.launches) == (before[0] + 1,
                                                    before[1] + 15)
    took = {r: c - before[2][r]
            for r, c in trb.fused_bottleneck2_fwd.routes.items()}
    assert took == {trb.ROUTE_ROWS: 4, trb.ROUTE_CONV: 2, trb.ROUTE_WGRAD: 0,
                    trb.ROUTE_FORM: 2, trb.ROUTE_REDUCE: 6,
                    trb.ROUTE_K41: 1}
    ref = trb.fused_bottleneck2_fwd_ref(x, p1, p2)
    again = trb.fused_bottleneck2_fwd(x, p1, p2)
    torch.cuda.synchronize()
    assert y2.dtype == dtype and y2.shape == x.shape
    assert (y2.float() - ref.float()).abs().max().item() <= _y_tol(ref)
    assert torch.equal(y2, again)


def test_fused_pair_coupled_kernel_tiles_and_width(cuda):
    """The coupled kernel's row tile is the wrapper's (the per-tile sums'
    count), for 4C up to 2048; wider is refused (0)."""
    lib = _build.lib()
    for C in (8, 64, 128, 256, 512):
        assert lib.ptt_resblock_k41_rows(4 * C) == trb._K41_ROWS
    assert lib.ptt_resblock_k41_rows(4 * 1024) == 0


def test_fused_pair_planted_fault_fails_the_gate(cuda, monkeypatch):
    """The coupled kernel run with block 1's residual x read as zeros
    (the fault the gate must see) breaks the 2-ulp gate at layer3's
    width."""
    a1 = _block_args(4, 14, 14, 1024, 256, torch.bfloat16, cuda, seed=1)
    a2 = _block_args(4, 14, 14, 1024, 256, torch.bfloat16, cuda, seed=2)
    x, p1, p2 = a1[0], a1[1:], a2[1:]
    ref = trb.fused_bottleneck2_fwd_ref(x, p1, p2)
    gemm = trb._Launcher.gemm

    def faulty(self, kind, what, a, N, **kw):
        if kind == trb._F41:
            kw["e0"] = torch.zeros_like(kw["e0"])
        return gemm(self, kind, what, a, N, **kw)

    monkeypatch.setattr(trb._Launcher, "gemm", faulty)
    bad = trb.fused_bottleneck2_fwd(x, p1, p2)
    torch.cuda.synchronize()
    assert (bad.float() - ref.float()).abs().max().item() > 10 * _y_tol(ref)


# ----------------------------- short-attention backward on the Hopper bodies

@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 136, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_short_attention_hopper_backward_matches_plain(cuda, D, S, causal,
                                                       p):
    """The dQ body with its own row term and the dK/dV body with the
    transposed draw (`sa_dq_sm90`, `sa_dkv_sm90`) on fused-QKV views,
    against the plain backward on the same lse and seed: each gradient to
    FLASH_TOL's normwise 1e-3; two launches, both on the Hopper route."""
    q, k, v, do, seed = _sa_case(2, S, 3, D, torch.bfloat16, seed=S + D + 3)
    assert tsa.short_bwd_route(q, k, v, do)[0] == tsa.BWD_WGMMA
    _, lse = tsa.short_attention_fwd(q, k, v, seed, p, causal)
    before = dict(tsa.short_attention_bwd.routes)
    grads = tsa.short_attention_bwd(q, k, v, do, lse, seed, p, causal)
    assert tsa.short_attention_bwd.routes == {
        **before, tsa.BWD_WGMMA: before[tsa.BWD_WGMMA] + 2}
    refs = tsa.short_attention_bwd_ref(q, k, v, do, lse, seed, p, causal)
    for name, got, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(got).all(), name
        assert _norm_err(got, r) <= FLASH_TOL[torch.bfloat16][1], (
            name, _norm_err(got, r))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,p", [(128, 0.1), (136, 0.5)])
def test_short_attention_hopper_backward_replays_the_plain_mask(cuda, D, S,
                                                                p):
    """Both backward kernels' keep bits, read out exactly. With q = 0
    every probability is 1/S. dK/dV: with dO[i, i - c] = 1 for the queries
    i in [c, c + D), dV[j, d] = Z[c + d, j] / S, nonzero exactly where
    (c + d, j) is kept (the transposed draw). dQ: with V and dO all e_0
    (dP = 1) and K[j, j - c] = 1, dQ[i, d] S / scale = Z[i, c + d] - D_i,
    D_i = mean_j Z[i, j] ~ 1: >= 0 where kept, ~ -1 where dropped (the
    forward-layout draw and the row term). Both must equal the plain
    stream's mask bit for bit."""
    from paddle_tpu_torch.ops import _dropout_rng

    B, H = 2, 3
    dt = torch.bfloat16
    seed = torch.tensor([77], device=cuda)
    want = _dropout_rng.keep_mask(seed, B, H, S, S, p)
    zero = torch.zeros(B, S, H, D, device=cuda, dtype=dt)
    lse = torch.full((B, H, S), math.log(S), device=cuda)
    e0 = torch.zeros(B, S, H, D, device=cuda, dtype=dt)
    e0[..., 0] = 1
    kept_t = torch.empty(B, H, S, S, dtype=torch.bool, device=cuda)
    kept_q = torch.empty(B, H, S, S, dtype=torch.bool, device=cuda)
    for c in range(0, S, D):
        w = min(D, S - c)
        eye = torch.zeros(S, D, device=cuda, dtype=dt)
        eye[c:c + w, :w] = torch.eye(w, device=cuda, dtype=dt)
        eye = eye[None, :, None, :].expand(B, S, H, D).contiguous()
        before = tsa.short_attention_bwd.routes[tsa.BWD_WGMMA]
        _, _, dv = tsa.short_attention_bwd(zero, zero, zero, eye, lse, seed,
                                           p)
        dq, _, _ = tsa.short_attention_bwd(zero, eye, e0, e0, lse, seed, p)
        assert tsa.short_attention_bwd.routes[tsa.BWD_WGMMA] == before + 4
        # dv [B, S(keys j), H, D(d)] -> kept[b, h, c + d, j]
        kept_t[:, :, c:c + w, :] = (dv[..., :w] != 0).permute(0, 2, 3, 1)
        z = dq[..., :w].float() * S * math.sqrt(D)
        kept_q[..., c:c + w] = (z > -0.5).permute(0, 2, 1, 3)
    assert torch.equal(kept_t, want)
    assert torch.equal(kept_q, want)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,causal", [(128, False), (136, True),
                                      (512, False)])
def test_short_attention_backward_bit_stable_in_a_cuda_graph(cuda, D, S,
                                                             causal):
    """64 Hopper backward calls (dQ with its row-term sweep, then dK/dV)
    back to back in one CUDA graph, replayed 3 times: every call gives the
    eager call's gradients bit for bit (one owner per output, a fixed
    order, the keep words of dQ's first sweep reread by its second)."""
    q, k, v, do, seed = _sa_case(8, S, 12, D, torch.bfloat16, seed=S + 5)
    _, lse = tsa.short_attention_fwd(q, k, v, seed, 0.1, causal)

    def bwd():
        return tsa.short_attention_bwd(q, k, v, do, lse, seed, 0.1, causal)

    ref = bwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd()
    torch.cuda.current_stream().wait_stream(side)
    calls = 64
    before = tsa.short_attention_bwd.routes[tsa.BWD_WGMMA]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [bwd() for _ in range(calls)]
    assert tsa.short_attention_bwd.routes[tsa.BWD_WGMMA] == before + 2 * calls
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        bad = [i for i, o in enumerate(outs)
               if not all(torch.equal(a, b) for a, b in zip(o, ref))]
        assert not bad, f"{len(bad)} of {calls} calls differ"


def test_short_attention_hopper_backward_refuses_what_it_does_not_admit(
        cuda):
    """Asked for the Hopper backward (kind 7) on f32 operands, or at
    S > 512 (the dQ body keeps a keep word a 64-key block, 8 at most), the
    C entry refuses (cudaErrorInvalidValue) instead of running another
    body."""
    for S, dtype in ((128, torch.float32), (520, torch.bfloat16)):
        q, k, v, do, seed = _sa_case(1, S, 2, 64, dtype, seed=4)
        _, ptrs, strides = _build.attention_views((q, k, v, do))
        lse = torch.zeros(1, 2, S, device=cuda)
        grads = torch.empty((3, *q.shape), dtype=dtype, device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tsa._launch(tsa._BWD_KIND[tsa.BWD_WGMMA], q, ptrs, strides, seed,
                        lse, lse.clone(), grads, None, 0.1, False, 0.125)


@pytest.mark.parametrize("kind", [1, 2, 4, 5])
def test_short_attention_entry_refuses_the_separate_backward_kinds(cuda,
                                                                    kind):
    """The C entry takes the forward kinds (0, 3) and the one-call
    backward kinds (6, 7) only: asked for one backward kernel alone, on
    operands kind 7 takes, it refuses (cudaErrorInvalidValue)."""
    q, k, v, do, seed = _sa_case(1, 128, 2, 64, torch.bfloat16, seed=4)
    _, ptrs, strides = _build.attention_views((q, k, v, do))
    lse = torch.zeros(1, 2, 128, device=cuda)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsa._launch(kind, q, ptrs, strides, seed, lse, lse.clone(), out,
                    out.clone(), 0.1, False, 0.125)


# sha256 (first 16 hex digits) of the bf16 dQ, dK and dV bytes of
# `_flash_bwd_digest`'s cases, recorded on an H100 from the Hopper
# backward bodies as they stood in flash_attention.cu before they moved to
# attention_sm90.cuh
FLASH_BWD_DIGESTS = {
    (64, 1024, True): "1236fb8f7d06f905",
    (64, 1024, False): "b2bf620a80b1d8f9",
    (64, 1000, True): "11223e05a8895f65",
    (64, 1000, False): "8a2ffb026430b8de",
    (128, 1024, True): "3a1832f4b01f996e",
    (128, 1024, False): "7f67401517f27d02",
    (128, 1000, True): "e6f1a09289a3e691",
    (128, 1000, False): "8a9e9484f217138f"}


def _flash_bwd_digest(D, S, causal):
    import hashlib

    import numpy as np

    rs = np.random.RandomState(S + D + causal)

    def mk():
        return torch.from_numpy(rs.standard_normal((2, S, 4, D)).astype(
            np.float32)).to(torch.bfloat16).cuda()

    q, k, v, do = (mk() for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal)
    h = hashlib.sha256()
    for t in (dq, dk, dv):
        h.update(t.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1024, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_bits_are_the_recorded_ones(cuda, D, S, causal):
    """The flash backward's Hopper bodies, now shared with the short
    attention (NoDropout, the caller's delta), give the gradients the
    bodies gave before the move, bit for bit."""
    before = dict(tfa.flash_attention_bwd_dq.routes)
    got = _flash_bwd_digest(D, S, causal)
    assert tfa.flash_attention_bwd_dq.routes[tfa.BWD_WGMMA] \
        == before[tfa.BWD_WGMMA] + 1
    assert got == FLASH_BWD_DIGESTS[(D, S, causal)]


# ------------------------------------------------- decode: the ring body

DECODE_CACHE_DTYPES = [torch.float32, torch.bfloat16, torch.float16,
                       torch.int8]


def _ring_pool(cache, B, H, Hkv, D, BS, pos, seed, qdtype=torch.float32):
    """q and a [N, BS, Hkv, D] pool (garbage in every block, block 0
    included) in `cache`'s dtype with its scales (int8) as the engine's
    permuted views, random distinct tables whose tails point at block 0."""
    q, k, v, tables, pos_t = _paged_case(B, H, Hkv, D, BS,
                                         max(p // BS + 1 for p in pos),
                                         sum(p // BS + 1 for p in pos) + 1,
                                         pos, seed)
    k, v = k.cuda(), v.cuda()
    if cache == torch.int8:
        (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
        ks, vs = ks.permute(0, 2, 1), vs.permute(0, 2, 1)
    else:
        k, v = k.to(cache), v.to(cache)
        ks = vs = None
    return (q.to(qdtype).cuda(), k.permute(0, 2, 1, 3), ks,
            v.permute(0, 2, 1, 3), vs, tables.cuda(), pos_t.cuda())


@pytest.mark.parametrize("cache", DECODE_CACHE_DTYPES)
@pytest.mark.parametrize("H,Hkv", [(32, 32), (32, 8)])
def test_ring_paged_kernel_matches_plain(cuda, cache, H, Hkv):
    """The ring body (all G query heads of a KV head in one CTA, rows
    through per-warp cp.async rings, int8 dequantised in registers) on
    BS = 16 pools against `paged_decode_attention_ref`, MHA and GQA 4:1,
    at pos 0, at block boundaries (15, 16, 31) and ragged: f32 query,
    1e-4 (online and split softmax against a two-pass softmax, in f32)."""
    pos = [0, 15, 16, 31, 700, 2047]
    args = _ring_pool(cache, len(pos), H, Hkv, 128, 16, pos, seed=H + Hkv)
    assert td.paged_route(args[1], args[3]) == td.PAGED_RING
    before = dict(td.paged_decode_attention.routes)
    got = td.paged_decode_attention(*args)
    assert td.paged_decode_attention.routes == {
        **before, td.PAGED_RING: before[td.PAGED_RING] + 1}
    torch.testing.assert_close(got, td.paged_decode_attention_ref(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache", DECODE_CACHE_DTYPES)
@pytest.mark.parametrize("H,Hkv", [(32, 32), (32, 8)])
@pytest.mark.parametrize("pos", [0, 15, 16, 2000, 4095])
def test_ring_dense_kernel_matches_plain(cuda, cache, H, Hkv, pos):
    """The ring body on a contiguous [B, Hkv, 4096, D] cache (no table,
    pos one scalar for every sequence) against `decode_attention_ref`:
    f32 query, 1e-5 abs; keys past pos hold 1e4 and must not count."""
    from paddle_tpu_torch.ops.decode_attn import (decode_attention,
                                                  decode_attention_ref)

    g = torch.Generator().manual_seed(pos + H + Hkv)
    B, D, T = 2, 128, 4096
    q = torch.randn(B, 1, H, D, generator=g)
    k = torch.randn(B, Hkv, T, D, generator=g)
    v = torch.randn(B, Hkv, T, D, generator=g)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = 1e4
    if cache == torch.int8:
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        ks, vs = ks[..., None], vs[..., None]
    else:
        kq, vq = k.to(cache), v.to(cache)
        ks = vs = torch.ones(B, Hkv, T, 1)
    args = [t.to(cuda) for t in (q, kq, ks, vq, vs)]
    before = dict(decode_attention.routes)
    got = decode_attention(*args, pos)
    assert decode_attention.routes == {
        **before, td.PAGED_RING: before[td.PAGED_RING] + 1}
    ref = decode_attention_ref(*args, pos)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5
    assert got.abs().max().item() < 100.0


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_ring_kernel_takes_every_query_dtype(cuda, qdtype):
    """Query and output in f32, bf16 or f16 over a bf16 pool: the output
    in the query's dtype, within one rounding of it of the plain
    version."""
    args = _ring_pool(torch.bfloat16, 3, 8, 2, 64, 16, [3, 40, 130],
                      seed=11, qdtype=qdtype)
    got = td.paged_decode_attention(*args)
    assert got.dtype == qdtype
    tol = 1e-4 if qdtype == torch.float32 else 1e-2
    assert (got.float() - td.paged_decode_attention_ref(*args).float()
            ).abs().max().item() <= tol


def test_ring_kernel_table_changes_no_bit(cuda):
    """The ring body reading the pool through a staged block table gives
    the bits it gives on the same rows gathered into a contiguous cache
    (no table: sequence b reads block b, the same split length); the first
    body agrees within f32 rounding."""
    args = _ring_pool(torch.bfloat16, 4, 16, 4, 128, 16, [0, 17, 600, 2047],
                      seed=5)
    q, kq, ks, vq, vs, tables, pos = args
    B, NB = tables.shape
    Hkv, BS, D = kq.shape[1:]

    def gathered(pool):                  # -> [B, Hkv, NB * BS, D]
        return pool[tables.long()].transpose(1, 2).reshape(B, Hkv, NB * BS,
                                                           D)

    staged = td._launch_paged(q, kq, ks, vq, vs, tables, pos,
                              td.paged_decode_attention, td.PAGED_RING)
    no_table = td._launch_paged(q, gathered(kq), None, gathered(vq), None,
                                None, pos, td.paged_decode_attention,
                                td.PAGED_RING)
    scalar = td._launch_paged(q, kq, ks, vq, vs, tables, pos,
                              td.paged_decode_attention, td.PAGED_SCALAR)
    assert torch.equal(staged, no_table)
    torch.testing.assert_close(staged, scalar, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,Hkv", [(8, 4), (32, 4)])
def test_ring_kernel_takes_gqa_ratios_other_than_four(cuda, H, Hkv):
    """At G = H / Hkv = 2 (one query head a CTA) and G = 8 (four a CTA,
    two CTAs a KV head) the route is the ring body and the result holds
    against the plain version at the f32 query's 1e-4."""
    args = _ring_pool(torch.bfloat16, 4, H, Hkv, 128, 16, [0, 16, 700, 2047],
                      seed=H + Hkv)
    assert td.paged_route(args[1], args[3]) == td.PAGED_RING
    before = dict(td.paged_decode_attention.routes)
    got = td.paged_decode_attention(*args)
    assert td.paged_decode_attention.routes == {
        **before, td.PAGED_RING: before[td.PAGED_RING] + 1}
    torch.testing.assert_close(got, td.paged_decode_attention_ref(*args),
                               rtol=1e-4, atol=1e-4)


def test_ring_kernel_row_stable_across_batch_gqa(cuda):
    """With four query heads a CTA (GQA 4:1) and an int8 pool, a
    sequence's output bits do not depend on its batchmates."""
    args = _ring_pool(torch.int8, 4, 16, 4, 128, 16, [5, 700, 1500, 33],
                      seed=8, qdtype=torch.bfloat16)
    q, kq, ks, vq, vs, tables, pos = args
    full = td.paged_decode_attention(*args)
    one = td.paged_decode_attention(q[2:3], kq, ks, vq, vs, tables[2:3],
                                    pos[2:3])
    assert torch.equal(full[2:3], one)


def test_ring_kernel_refuses_rows_it_cannot_read(cuda):
    """Asked for the ring body on 160-byte rows (bf16 D = 80), the C entry
    refuses (cudaErrorInvalidValue); the route gives the first body, which
    takes them."""
    args = _ring_pool(torch.bfloat16, 2, 4, 2, 80, 16, [3, 40], seed=2)
    q, kq, ks, vq, vs, tables, pos = args
    assert td.paged_route(kq, vq) == td.PAGED_SCALAR
    with pytest.raises(RuntimeError, match="CUDA error"):
        td._launch_paged(q, kq, ks, vq, vs, tables, pos,
                         td.paged_decode_attention, td.PAGED_RING)
    torch.testing.assert_close(td.paged_decode_attention(*args),
                               td.paged_decode_attention_ref(*args),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------- decode step programs as CUDA graphs

def _serve_model(cuda):
    """A llama-shaped 2-layer bf16 model, every float Linear of a decode
    step on the row-stable GEMV."""
    return gpt("llama2_7b", device=cuda, dtype="bfloat16", seed=0,
               num_layers=2, hidden_size=512, num_heads=8, num_kv_heads=4,
               intermediate_size=1376, vocab_size=4000)


def _graph_engine(cuda, variant, **kw):
    """A llama-shaped 2-layer bf16 model (every float Linear on the
    row-stable GEMV) in one of the serving variants, its engine (graphs),
    and the adapter pool for "adapters". The pool's blocks hold random
    K/V."""
    from paddle_tpu_torch.inference import AdapterPool, DecodeEngine
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    m = _serve_model(cuda)
    if variant == "int4":
        quantize_for_inference(m, "int4", min_features=0)
    pool = None
    if variant == "adapters":
        pool = AdapterPool(m, rank=8, slots=4)
        g = torch.Generator().manual_seed(1)
        for name in ("a", "b", "c"):
            pool.load(name, {k: (torch.randn(i, 8, generator=g) * 0.2,
                                 torch.randn(8, o, generator=g) * 0.2)
                             for k, (i, o) in pool.layers.items()})
    quant = "int8" if variant in ("int8_kv", "int4") else None
    eng = DecodeEngine(m, max_length=128, block_size=16,
                       decode_buckets=(1, 2, 4, 8), quant=quant,
                       adapters=pool, device=cuda, **kw)
    g = torch.Generator(device=cuda).manual_seed(3)
    for layer in eng.pool.tensors:
        for t in layer:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device=cuda))
            elif t.dtype == torch.float32:
                t.copy_(torch.rand(t.shape, generator=g, device=cuda) * 0.02)
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    return m, eng, pool


def _stage_rows(prog, n, seed, nb, sampled=False, aids=False):
    """Fill n real rows of a decode program's host arrays (the rest stay
    pad rows): distinct blocks, ragged positions, random tokens; sampled
    rows alternate greedy, sampled, sampled with a repetition penalty."""
    g = torch.Generator().manual_seed(seed)
    a = prog.stage()
    for i in range(n):
        pos = int(torch.randint(0, nb * 16 - 1, (1,), generator=g))
        a["tokens"][i, 0] = int(torch.randint(0, 4000, (1,), generator=g))
        a["pos"][i] = pos
        a["tables"][i, :pos // 16 + 1] = [1 + i * nb + j
                                          for j in range(pos // 16 + 1)]
        if aids:
            a["aids"][i] = i % 4
        if sampled and i % 3:
            a["greedy"][i] = 0
            a["seed"][i], a["ctr"][i] = 100 + i, 5
            a["temp"][i], a["top_k"][i], a["top_p"][i] = 0.8, 50, 0.9
            if i % 3 == 2:
                a["rep"][i] = 1.3
                a["hist"][i, :6] = [1, 2, 3, 4, 5, 6]
    return a


@pytest.mark.parametrize("variant,kind", [
    ("bf16", "greedy"), ("int8_kv", "greedy"), ("int4", "greedy"),
    ("adapters", "greedy"), ("bf16", "sampled"), ("adapters", "sampled")])
def test_step_program_replay_equals_eager(cuda, variant, kind):
    """Every decode bucket: the captured program's replay gives the eager
    run's logits and tokens bit for bit over the same static inputs (pad
    rows included), for bf16 weights and KV, int8 KV, int4 weights, LoRA
    adapters through BGMV and sampled rows with and without a penalty;
    and a second replay over new inputs does not read stale buffers."""
    from paddle_tpu_torch.inference.decode.step_graphs import StepProgram

    m, eng, pool = _graph_engine(cuda, variant)
    try:
        for b in eng.decode_buckets:
            graph = eng._on_scheduler(lambda b=b: eng._program(kind, b))
            assert graph.graph
            fields, body = eng._make_program(kind, b)
            eager = StepProgram("eager", fields, body, cuda)
            for seed in (b, b + 10):
                n = max(1, b - 1) if seed == b else b
                for prog in (graph, eager):
                    _stage_rows(prog, n, seed, eng._nb, kind == "sampled",
                                pool is not None)
                    prog.run()
                assert torch.equal(graph.outputs["logits"],
                                   eager.outputs["logits"]), (b, seed)
                assert graph.fetch("next", b) == eager.fetch("next", b)
    finally:
        eng.shutdown()
        if pool is not None:
            pool.detach()


def test_replays_count_the_launches_of_eager_steps(cuda):
    """N replays add to every wrapper's `.launches` and `.routes` what N
    eager runs of the same program add; building the graph adds
    nothing."""
    from paddle_tpu_torch.inference.decode.step_graphs import (
        StepProgram, counted_wrappers)

    m, eng, pool = _graph_engine(cuda, "adapters")
    wrappers = counted_wrappers()

    def counts():
        return [(w.launches, dict(getattr(w, "routes", {})))
                for w in wrappers]

    def delta(a, b):
        return [(y[0] - x[0], {r: y[1][r] - x[1].get(r, 0) for r in y[1]})
                for x, y in zip(a, b)]

    try:
        before = counts()
        graph = eng._on_scheduler(lambda: eng._program("greedy", 4))
        assert counts() == before
        fields, body = eng._make_program("greedy", 4)
        eager = StepProgram("eager", fields, body, cuda)
        deltas = []
        for prog in (eager, graph):
            c0 = counts()
            for i in range(5):
                _stage_rows(prog, 3, i, eng._nb, aids=True)
                prog.run()
            prog.fetch("next", 3)
            deltas.append(delta(c0, counts()))
        assert deltas[0] == deltas[1]
        assert tb.lora_delta.launches and tw.row_gemv.launches
        by = {w.__name__: d[0] for w, d in zip(wrappers, deltas[1])}
        assert by["lora_delta"] == 5 * 2 * 2         # 2 layers x 2 targets
        assert by["paged_decode_attention"] == 5 * 2
        assert graph.launches()["row_gemv"] == 2 * 4 + 1
    finally:
        eng.shutdown()
        pool.detach()


def test_engine_on_graphs_equals_eager_steps(cuda):
    """The same traffic through the default engine (graphs) and through
    `_eager_steps`: every sequence's tokens bit-equal, every decode step
    a replay, and no program built after `warmup()`."""
    from paddle_tpu_torch.inference import SamplingParams

    prompts = [[1, 2, 3, 4, 5], list(range(10, 40)), [7] * 17, [9, 8, 7]]
    samp = [None, SamplingParams(temperature=0.8, top_k=20, seed=4), None,
            SamplingParams(temperature=0.7, repetition_penalty=1.2, seed=9)]
    outs = []
    for eager in (False, True):
        m, eng, _ = _graph_engine(cuda, "bf16", _eager_steps=eager)
        with eng:
            warm = eng.warmup()
            built = eng.stats()["compiles"]
            streams = [eng.submit(p, 20, sampling=s)
                       for p, s in zip(prompts, samp)]
            outs.append([s.result() for s in streams])
            st = eng.stats()
        assert warm == {"decode": [1, 2, 4, 8],
                        "prefill": list(eng.prefill_buckets)}
        assert built == {"built": 8, "disk": 0} == st["compiles"]
        progs = st["step_programs"]
        assert all(p["graph"] != eager for p in progs.values())
        assert sum(p["replays"] for p in progs.values()) == st["steps"]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("draft", ["self", "perturbed"])
def test_speculation_on_graphs_equals_plain_greedy(cuda, draft):
    """Speculation on graphs (propose and verify replays): every
    sequence's tokens equal the plain engine's greedy tokens; the
    self-draft accepts every proposal."""
    from paddle_tpu_torch.inference import DecodeEngine

    m, plain, _ = _graph_engine(cuda, "bf16")
    prompts = [[1, 2, 3, 4, 5], list(range(10, 40)), [7] * 17, [9, 8, 7]]
    with plain:
        ref = [s.result() for s in [plain.submit(p, 24) for p in prompts]]
    d = m
    if draft == "perturbed":
        d = gpt("llama2_7b", device=cuda, dtype="bfloat16", seed=0,
                num_layers=2, hidden_size=512, num_heads=8, num_kv_heads=4,
                intermediate_size=1376, vocab_size=4000)
        with torch.no_grad():
            w = d.transformer.layers[1].mlp.down_proj.weight
            w.add_(torch.randn(w.shape, device=cuda,
                               generator=torch.Generator(device=cuda)
                               .manual_seed(5)).to(w.dtype) * 2e-3)
    with DecodeEngine(m, max_length=128, block_size=16,
                      decode_buckets=(1, 2, 4, 8), draft_model=d,
                      speculate_k=4, device=cuda) as eng:
        assert eng.warmup()["speculate_k"] == 4
        streams = [eng.submit(p, 24) for p in prompts]
        assert [s.result() for s in streams] == ref
    st = eng.stats()                     # after shutdown: pools drained
    sp = st["speculative"]
    assert sp["proposed"] == sp["accepted"] + sp["rejected"] > 0
    # a raising propose or verify program falls back to plain isolated
    # steps, whose tokens are plain greedy's too: none may have happened
    assert sp["fallbacks"] == 0 and st["isolation_rounds"] == 0
    progs = st["step_programs"]
    for kind in ("propose", "verify"):
        assert sum(p["replays"] for n, p in progs.items()
                   if n.startswith(kind)) == sp["rounds"] \
            == sp["verify_dispatches"]
    assert all(p["graph"] for p in progs.values())
    if draft == "self":
        assert sp["acceptance_rate"] == 1.0
    else:
        assert sp["rejected"] > 0
    assert st["blocks"]["allocated"] == 0
    assert st["draft_blocks"]["allocated"] == 0


# ---------------------------------------------------------------------------
# the serving runtime: supervised steps on graphs, resume on the card
# ---------------------------------------------------------------------------

_SERVE_PROMPTS = [[1, 2, 3, 4, 5], list(range(10, 40)), [7] * 17, [9, 8, 7]]
#: a near-tie of the 2-layer model's bf16 logits: a top-2 gap under this,
#: where a re-prefilled (cuBLAS) row and a decoded (GEMV) row may pick
#: either token
_RESUME_TIE = 0.25


def _serve_engine(cuda, m, **kw):
    """A warmed engine (every step program a CUDA graph) over `m`."""
    from paddle_tpu_torch.inference import DecodeEngine

    eng = DecodeEngine(m, max_length=128, block_size=16,
                       decode_buckets=(1, 2, 4, 8), default_timeout=120.0,
                       device=cuda, **kw)
    eng.warmup()
    return eng


def _wedge_once(seconds):
    """A fault hook that sleeps `seconds` in the first decode step of more
    than one sequence."""
    state = {"armed": True}

    def hook(tag, ids, info):
        if state["armed"] and tag == "decode" and len(ids) > 1:
            state["armed"] = False
            time.sleep(seconds)

    return hook


def _wedged_run(cuda, m):
    """The prompts through an engine whose first batched decode step
    sleeps past the step deadline once; returns the engine (open), its
    tokens and the launch counts read after the last token."""
    from paddle_tpu_torch.ops import counted_wrappers

    eng = _serve_engine(cuda, m, step_timeout=0.5, hang_grace=0.05,
                        supervise_interval=0.01, fault_hook=_wedge_once(1.5))
    got = [s.result() for s in [eng.submit(p, 24) for p in _SERVE_PROMPTS]]
    torch.cuda.synchronize()
    return eng, got, [w.launches for w in counted_wrappers()]


def test_a_resent_wedged_step_on_graphs_is_bit_equal(cuda):
    """A decode step whose worker hangs past `step_timeout` is sent again
    on a fresh worker, which replays the graph the scheduler thread
    captured: every sequence's tokens equal a fault-free engine's bit for
    bit, with one wedged step, no isolation round, replays = steps."""
    m = _serve_model(cuda)
    with _serve_engine(cuda, m) as ref_eng:
        ref = [s.result() for s in [ref_eng.submit(p, 24)
                                    for p in _SERVE_PROMPTS]]
    eng, got, _ = _wedged_run(cuda, m)
    eng.shutdown()
    st = eng.stats()
    assert got == ref
    assert st["wedged_steps"] == 1 and st["isolation_rounds"] == 0
    assert all(p["graph"] for p in st["step_programs"].values())
    assert sum(p["replays"] for n, p in st["step_programs"].items()
               if n.startswith(("greedy", "sampled"))) == st["steps"]
    assert st["blocks"]["allocated"] == 0


def test_an_abandoned_worker_launches_nothing(cuda):
    """The retired worker wakes after its step was re-sent and served: it
    finds its epoch stale and does no device work, so no kernel wrapper's
    launch count moves between the last token and its waking."""
    from paddle_tpu_torch.ops import counted_wrappers

    eng, got, counts = _wedged_run(cuda, _serve_model(cuda))
    try:
        give_up = time.monotonic() + 30.0
        while eng.stats()["abandoned_steps"] < 1 \
                and time.monotonic() < give_up:
            time.sleep(0.02)
        torch.cuda.synchronize()
        assert eng.stats()["abandoned_steps"] == 1
        assert [w.launches for w in counted_wrappers()] == counts
        assert sum(counts) > 0
    finally:
        eng.shutdown()


def test_one_engine_captures_while_another_replays(cuda):
    """Engine B captures its step programs (warmup, on its scheduler
    thread) while engine A's worker thread replays A's graphs under live
    traffic: A's streams keep A's tokens and B then serves the same
    tokens from its own graphs."""
    from paddle_tpu_torch.inference import DecodeEngine

    m = _serve_model(cuda)
    a = _serve_engine(cuda, m)
    ref = [s.result() for s in [a.submit(p, 24) for p in _SERVE_PROMPTS]]
    stop, during, bad = threading.Event(), [], []
    capturing = threading.Event()

    def traffic():
        while not stop.is_set():
            outs = [s.result() for s in [a.submit(p, 24)
                                         for p in _SERVE_PROMPTS]]
            if outs != ref:
                bad.append(outs)
            if capturing.is_set():
                during.append(1)

    t = threading.Thread(target=traffic)
    t.start()
    try:
        b = DecodeEngine(m, max_length=128, block_size=16,
                         decode_buckets=(1, 2, 4, 8), default_timeout=120.0,
                         device=cuda)
        capturing.set()
        b.warmup()
        capturing.clear()
        with b:
            assert [s.result() for s in [b.submit(p, 24)
                                         for p in _SERVE_PROMPTS]] == ref
    finally:
        stop.set()
        t.join(timeout=120)
        a.shutdown()
    assert not t.is_alive() and not bad
    assert all(p["graph"] for p in b.stats()["step_programs"].values())
    assert b.stats()["compiles"]["built"] == 8


def test_resume_committed_keeps_tokens_up_to_the_first_near_tie(cuda):
    """A stream resumed from 8 committed tokens re-prefills prompt +
    committed (cuBLAS chunks) where the uninterrupted run decoded them
    (GEMV), so the bits may differ: its tokens equal the uninterrupted
    continuation up to the first near-tie of the uninterrupted run's
    decode logits."""
    m = _serve_model(cuda)
    with _serve_engine(cuda, m) as eng:
        for p in _SERVE_PROMPTS:
            full = eng.submit(p, 24, keep_logits=24)
            ref = full.result()
            logits = torch.stack(full.logits)
            top = torch.topk(logits, 2, dim=-1).values
            gap = (top[:, 0] - top[:, 1])[8:]
            ties = (gap < _RESUME_TIE).nonzero()
            first_tie = int(ties[0]) if len(ties) else len(gap)
            got = eng.submit(p, 16, resume_committed=ref[:8]).result()
            assert len(got) == 16
            assert got[:first_tie] == ref[8:8 + first_tie], (p, first_tie)
        assert eng.stats()["resumed"] == len(_SERVE_PROMPTS)


# ---------------------------------------------------------------------------
# training recipes: the fp16 GradScaler, rewinds, AMP O2
# ---------------------------------------------------------------------------

def test_fp16_grad_scaler_skips_and_recovers(cuda):
    """An fp16 MLP under auto_cast O2 fp16: a loss made to overflow the
    fp16 gradients on steps 2 and 3 is skipped twice (parameters
    bit-equal, the optimizer's step counter unchanged), the scale halves
    on each and doubles after every two good steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import SGD

    g = torch.Generator(device=cuda).manual_seed(0)
    mlp = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.GELU(),
                              torch.nn.Linear(128, 64)).to(cuda)
    amp.decorate(mlp, level="O2", dtype="float16")
    opt = SGD(learning_rate=1e-2, parameters=mlp.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 16,
                            incr_every_n_steps=2)
    x = torch.randn(32, 64, generator=g, device=cuda)
    y = torch.randn(32, 64, generator=g, device=cuda)
    scales = []
    for i in range(8):
        before = [p.detach().clone() for p in mlp.parameters()]
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = torch.nn.functional.mse_loss(mlp(x), y)
        assert loss.dtype == torch.float32
        scaler.scale(loss * 1e9 if i in (2, 3) else loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        same = all(torch.equal(p, q) for p, q in zip(mlp.parameters(),
                                                      before))
        assert same == (i in (2, 3)), i
    s = 2.0 ** 16
    assert scales == [s, 2 * s, s, s / 2, s / 2, s, s, 2 * s]
    assert opt._step_count == 6
    assert all(p.dtype == torch.float16 for p in mlp.parameters())


def test_snapshot_restore_replays_gpt_tiny_through_flash(cuda):
    """gpt_tiny through the flash kernels under a warm-up schedule and a
    global-norm clip: `snapshot()` after 2 steps, 3 steps, then
    `restore()` and the scheduler's `set_state_dict` twice, each
    replaying the 3 steps bit for bit (losses, grad norms, parameters)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    m = gpt("gpt_tiny", device=cuda)
    sched = LinearWarmup(CosineAnnealingDecay(1e-3, T_max=10),
                         warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    eng = parallelize(m, AdamW(learning_rate=sched,
                               parameters=m.parameters(),
                               grad_clip=ClipGradByGlobalNorm(1.0)),
                      compute_dtype="bfloat16")
    ids = torch.randint(0, m.cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(0))

    def steps(n):
        out = []
        for _ in range(n):
            out.append((float(eng.train_batch(ids)),
                        float(eng.last_grad_norm)))
            sched.step()
        return out, [p.detach().clone() for p in m.parameters()]

    steps(2)
    snap, state = eng.snapshot(), sched.state_dict()
    before = tfa.flash_attention_fwd.launches
    ref, ref_params = steps(3)
    assert tfa.flash_attention_fwd.launches - before == 3 * m.cfg.num_layers
    for _ in range(2):
        eng.restore(snap)
        sched.set_state_dict(state)
        got, params = steps(3)
        assert got == ref
        assert all(torch.equal(p, q) for p, q in zip(params, ref_params))


def test_bert_tiny_under_o2_through_short_attention(cuda):
    """bert_tiny decorated O2 bf16, 3 dygraph steps under auto_cast and the
    GradScaler: every short-attention launch on a kernel route (one
    forward and two backward a layer and step), bf16 parameters and
    moments, finite losses; the same steps from the same generator seed
    again, bit for bit."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import bert_for_sequence_classification
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1024, (4, 64), generator=g).to(cuda)
    labels = torch.randint(0, 2, (4,), generator=g).to(cuda)
    runs = []
    for _ in range(2):
        m = bert_for_sequence_classification(
            "bert_tiny", device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(5))
        amp.decorate(m, level="O2", dtype="bfloat16")
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        scaler = amp.GradScaler()
        before = (tsa.short_attention_fwd.launches,
                  tsa.short_attention_bwd.launches)
        losses = []
        for _ in range(3):
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = TF.cross_entropy(m(ids), labels)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        per = 3 * m.cfg.num_hidden_layers
        assert (tsa.short_attention_fwd.launches - before[0],
                tsa.short_attention_bwd.launches - before[1]) == (per,
                                                                  2 * per)
        assert all(math.isfinite(x) for x in losses)
        assert opt.state_dict()["moment1_0"].dtype == torch.bfloat16
        assert all(p.dtype == torch.bfloat16 for p in m.parameters())
        runs.append(losses)
    assert runs[0] == runs[1]


def test_bert_tiny_under_o2_fp16_refuses_the_attention_kernels(cuda):
    """bert_tiny decorated O2 fp16 in training mode: its dropout attention
    reaches the short-attention kernels in fp16, which they do not take,
    so the forward raises TypeError and no short-attention launch is
    counted (no plain route runs on the card in its place)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import bert_for_sequence_classification

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1024, (4, 64), generator=g).to(cuda)
    m = bert_for_sequence_classification(
        "bert_tiny", device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(5))
    amp.decorate(m, level="O2", dtype="float16")
    before = tsa.short_attention_fwd.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        with amp.auto_cast(level="O2", dtype="float16"):
            m(ids)
    assert tsa.short_attention_fwd.launches == before


# ---------------------------------------------------------------------------
# LoRA fine-tuning and serving
# ---------------------------------------------------------------------------

def _lora_losses_and_norms(cuda, kernels):
    """A LLaMA-style gpt_tiny with r = 4 adapters on qkv and out, 3 bf16
    steps of AdamW over the adapters at S = 128, through the flash
    kernels or (the routing predicate patched) the plain attention."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn import lora
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.optimizer import AdamW

    m = gpt("gpt_tiny", device=cuda, rope=True, swiglu=True)
    lora.apply_lora(m, r=4, target_modules=("qkv", "out"),
                    generator=torch.Generator(device=cuda).manual_seed(1))
    frozen = {n: p.detach().clone() for n, p in m.named_parameters()
              if not p.requires_grad}
    eng = parallelize(m, AdamW(learning_rate=1e-2,
                               parameters=lora.lora_parameters(m)),
                      compute_dtype="bfloat16")
    ids = torch.randint(0, m.cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(0))
    supported = attention.flash_attention_supported
    if not kernels:
        attention.flash_attention_supported = lambda shape, causal: False
    before = tfa.flash_attention_fwd.launches
    try:
        losses = eng.train_batches([(ids,)] * 3)
    finally:
        attention.flash_attention_supported = supported
    launched = tfa.flash_attention_fwd.launches - before
    assert launched == (3 * m.cfg.num_layers if kernels else 0)
    assert all(torch.equal(p, frozen[n]) for n, p in m.named_parameters()
               if n in frozen)
    return losses.float().cpu(), eng.last_grad_norms.float().cpu()


def test_lora_training_through_flash_kernels_matches_plain(cuda):
    """Phase 4's bounds: loss within 1e-2 and the adapters' pre-clip
    grad norm within 5e-2, relative; the base bit-unchanged on both."""
    kl, kn = _lora_losses_and_norms(cuda, True)
    pl, pn = _lora_losses_and_norms(cuda, False)
    assert torch.isfinite(kl).all() and torch.isfinite(kn).all()
    assert ((kl - pl).abs() / pl.abs()).max() <= 1e-2
    assert ((kn - pn).abs() / pn.abs()).max() <= 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_out", [12288, 4096])     # qkv_proj, out_proj
def test_bgmv_rank8_decode_matches_plain(cuda, dtype, d_out):
    """The rank a fine-tuned r = 8 adapter serves at, llama2_7b's
    projections, a decode batch of 8: one launch on the cluster body,
    within 1e-5 of max |ref|."""
    x, A, B, ids = _bgmv_case(8, 1, 4096, d_out, 8, 4, dtype, seed=8)
    ref = tb.lora_delta_ref(x, A, B, ids)
    before = dict(tb.lora_delta.routes)
    got = tb.lora_delta(x.to(cuda), A.to(cuda), B.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert tb.lora_delta.routes == {
        **before, tb.ROUTE_CLUSTER: before[tb.ROUTE_CLUSTER] + 1}
    assert (got.cpu() - ref).abs().max().item() <= _bgmv_tol(ref)


def test_lora_generate_on_gpu_sampled_reruns_and_merge(cuda):
    """`generate` with live adapters on the card: greedy cached equals
    uncached, a sampled rerun is bit-equal, and an f32 LoRA model's merged
    logits are within 1e-4 of its unmerged ones."""
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.nn import lora

    m = gpt("gpt_tiny", device=cuda, rope=True, swiglu=True)
    lora.apply_lora(m, r=4, generator=torch.Generator(device=cuda)
                    .manual_seed(2))
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        for p in lora.lora_parameters(m):
            p.normal_(0.0, 0.05, generator=g)
    ids = torch.randint(0, m.cfg.vocab_size, (3, 9),
                        generator=torch.Generator().manual_seed(4))
    a = generate(m, ids, max_new_tokens=6)
    assert a.device.type == "cuda"
    assert torch.equal(a, generate(m, ids, max_new_tokens=6,
                                   use_cache=False))
    s1 = generate(m, ids, max_new_tokens=6, do_sample=True, top_k=20,
                  top_p=0.9, temperature=0.8, seed=7)
    assert torch.equal(s1, generate(m, ids, max_new_tokens=6,
                                    do_sample=True, top_k=20, top_p=0.9,
                                    temperature=0.8, seed=7))
    with torch.no_grad():
        unmerged = m(ids.to(cuda))
        lora.merge_lora(m)
        merged = m(ids.to(cuda))
    assert (merged - unmerged).abs().max() <= 1e-4 * unmerged.abs().max()


# ---------------------------------------------------------------------------
# the kernel operators under torch.export, and bucket programs
# ---------------------------------------------------------------------------

def _tiny_bert(device, quantize):
    from paddle_tpu_torch.models import bert_for_sequence_classification

    m = bert_for_sequence_classification(
        "bert_tiny", device=device, hidden_size=128, num_attention_heads=2,
        intermediate_size=256).to(torch.bfloat16).eval()
    if quantize:
        tq.quantize_for_inference(m, "int8", min_features=0)
    return m


def _bert_feeds(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [[torch.randint(1, 1024, (1, 128), generator=g),
             torch.randint(0, 2, (1, 128), generator=g)] for _ in range(n)]


@pytest.mark.parametrize("quantize", [False, True])
def test_exported_program_launches_the_kernels_on_their_routes(
        cuda, tmp_path, quantize):
    """A bf16 tiny BERT (head dim 64) exported on the card: the program
    names the operators, and running it (a bucket-1 graph replay, and op
    by op) launches the Hopper flash forward once a layer (and, int8, the
    wgmma GEMM for every quantized Linear of the layers), bit-equal to the
    eager model."""
    from paddle_tpu_torch import jit

    m = _tiny_bert(cuda, quantize)
    path = str(tmp_path / "bert")
    spec = [((1, 128), torch.int64)] * 2
    jit.save(m, path, input_spec=spec)
    layer = jit.load(path)
    assert "paddle_tpu_torch.flash_fwd.default" in layer.graph_ops
    assert ("paddle_tpu_torch.weight_only_matmul.default"
            in layer.graph_ops) == quantize
    feeds = _bert_feeds(2)
    with torch.no_grad():
        wants = [m(*(t.to(cuda) for t in f)) for f in feeds]
    tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] = 0
    tw.weight_only_matmul.routes[tw.ROUTE_PREFILL] = 0
    fwd, wo = tfa.flash_attention_fwd.launches, tw.weight_only_matmul.launches
    for f, want in zip(feeds, wants):
        assert torch.equal(layer(*f), want)
    for f, want in zip(feeds, wants):
        assert torch.equal(layer.eager(*f), want)
    # 2 feeds, 2 runs each (graph, op by op), 2 layers
    assert tfa.flash_attention_fwd.launches - fwd == 2 * 2 * 2
    assert tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] == 2 * 2 * 2
    # 2 layers x (qkv, out, fc1, fc2) on 128 rows: the wgmma GEMM; the
    # pooler and the classifier on one row: the decode GEMV
    n_gemm, n_gemv = (8, 2) if quantize else (0, 0)
    assert tw.weight_only_matmul.launches - wo == 4 * (n_gemm + n_gemv)
    assert tw.weight_only_matmul.routes[tw.ROUTE_PREFILL] == 4 * n_gemm


def test_operators_cpu_implementations_are_the_plain_versions(cuda):
    q, k, v = (torch.randn(1, 128, 2, 64) for _ in range(3))
    o, lse = tfa.flash_fwd(q, k, v, False, 0.125)
    ro, rlse = tfa.flash_attention_ref(q, k, v, causal=False, scale=0.125)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    x = torch.randn(5, 64)
    qw = torch.randint(-127, 127, (16, 64), dtype=torch.int8)
    s = torch.rand(16)
    assert torch.equal(tw.weight_only_matmul_op(x, qw, s, "int8"),
                       tw.weight_only_matmul_ref(x, qw, s, "int8"))
    launches = tfa.flash_attention_fwd.launches
    tfa.flash_attention_fwd(q, k, v, causal=False)
    assert tfa.flash_attention_fwd.launches == launches


@pytest.mark.parametrize("quantize", [False, True])
def test_bucket_graph_rows_equal_single_calls(cuda, tmp_path, quantize):
    """Each bucket program is one CUDA graph replay of the "fold" body
    whose rows equal the single calls (graph and op by op) bit for bit, up
    to bucket 32, and whose replays count the kernels' launches: one flash
    forward a layer a bucket; int8, one wgmma GEMM a Linear of the layers
    a bucket and, for the one-row pooler, the decode GEMV in launches of
    at most 16 rows (each example's own route)."""
    from paddle_tpu_torch import jit

    m = _tiny_bert(cuda, quantize)
    path = str(tmp_path / "bert")
    jit.save(m, path, input_spec=[((1, 128), torch.int64)] * 2)
    layer = jit.load(path)
    feeds = _bert_feeds(4, seed=1)
    singles = [layer(*f).float().cpu() for f in feeds]
    for f, one in zip(feeds, singles):
        assert torch.equal(layer.eager(*f).float().cpu(), one)
    for bucket in (1, 2, 4, 8, 16, 32):
        prog = layer.batched_call(bucket)
        assert prog.graph and prog.design == "fold"
        rows = [feeds[j % 4] for j in range(bucket)]
        stacked = [torch.stack(col).numpy() for col in zip(*rows)]
        tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] = 0
        tw.weight_only_matmul.routes[tw.ROUTE_PREFILL] = 0
        tw.weight_only_matmul.routes[tw.ROUTE_DECODE] = 0
        for _ in range(2):
            out, = prog(*stacked)
            for j in range(bucket):
                assert torch.equal(torch.from_numpy(out[j]), singles[j % 4])
        # 2 replays x 2 layers
        assert tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] == 2 * 2
        gemm, gemv = (2 * 2 * 4, 2 * 2 * -(-bucket // 16)) if quantize \
            else (0, 0)
        assert tw.weight_only_matmul.routes[tw.ROUTE_PREFILL] == gemm
        assert tw.weight_only_matmul.routes[tw.ROUTE_DECODE] == gemv
    assert layer.aot_stats()["compiles"] == 6


def _mlp(device, dtype):
    """The reference's batching test model: Linear(32, 32), ReLU,
    Linear(32, 32)."""
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(32, 32), torch.nn.ReLU(),
        torch.nn.Linear(32, 32)).to(device, dtype).eval()


@pytest.mark.parametrize("model", ["mlp f32", "mlp bf16", "bert int8"])
def test_batched_programs_keep_single_run_bits(cuda, tmp_path, model):
    """The reference's MLP (f32 and bf16; one row an example, where cuBLAS
    folded over the examples sums rows in another order) and the int8
    tiny BERT, batched at every bucket up to 32: each row equals the
    example's single run bit for bit (the products run once per example,
    the rest folds)."""
    from paddle_tpu_torch import jit

    path = str(tmp_path / "m")
    g = torch.Generator().manual_seed(2)
    if model.startswith("mlp"):
        dt = torch.float32 if model == "mlp f32" else torch.bfloat16
        jit.save(_mlp(cuda, dt), path, input_spec=[((1, 32), dt)])
        feeds = [[torch.rand(1, 32, generator=g).to(dt)] for _ in range(32)]
    else:
        jit.save(_tiny_bert(cuda, True), path,
                 input_spec=[((1, 128), torch.int64)] * 2)
        feeds = _bert_feeds(32, seed=2)
    layer = jit.load(path)
    singles = [layer(*f).float().cpu() for f in feeds]
    for bucket in (2, 3, 8, 17, 32):
        prog = layer.batched_call(bucket)
        assert prog.graph and prog.design == "fold"
        stacked = [torch.stack(col).float().numpy()
                   for col in zip(*feeds[:bucket])]
        out, = prog(*stacked)
        for j in range(bucket):
            assert torch.equal(torch.from_numpy(out[j]), singles[j]), \
                (bucket, j)


def test_weight_only_vmap_keeps_each_examples_route(cuda):
    """vmap of the weight-only operator: examples of one row, 32 of them,
    take the decode GEMV (two launches of 16 rows), bit-equal to their
    single calls; examples of 128 rows take one wgmma launch."""
    g = torch.Generator(device="cuda").manual_seed(3)
    qw = torch.randint(-127, 128, (768, 768), device=cuda, generator=g,
                       dtype=torch.int8)
    sc = torch.rand(768, device=cuda, generator=g) / 100

    def op(x):
        return tw.weight_only_matmul(x, qw, sc, "int8")

    for m, bucket, route, launches in ((1, 32, tw.ROUTE_DECODE, 2),
                                       (128, 4, tw.ROUTE_PREFILL, 1)):
        x = torch.randn(bucket, m, 768, device=cuda, generator=g,
                        dtype=torch.bfloat16)
        singles = [op(x[j]) for j in range(bucket)]
        for r in tw.weight_only_matmul.routes:
            tw.weight_only_matmul.routes[r] = 0
        out = torch.func.vmap(op)(x)
        assert tw.weight_only_matmul.routes[route] == launches
        assert sum(tw.weight_only_matmul.routes.values()) == launches
        for j in range(bucket):
            assert torch.equal(out[j], singles[j]), (m, j)


def test_subprocess_replica_on_the_card_replies_bit_equal(cuda, tmp_path):
    """One replica process (a fresh interpreter running `serve_replica`,
    on the card by default) serves an exported int8 tiny BERT over the
    coordination store: its reply equals this process's `Predictor.run`
    of the same artifact bit for bit, stamped with its generation, and
    its trace merges this process's spans with the replica's."""
    import os

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed.store import create_master_store
    from paddle_tpu_torch.inference import (Config, Predictor,
                                            SubprocessReplica)
    from paddle_tpu_torch.obs import flight, trace

    m = _tiny_bert(cuda, True)
    jit.save(m, str(tmp_path / "model"),
             input_spec=[((1, 128), torch.int64)] * 2)
    feeds = [t.numpy() for t in _bert_feeds(1)[0]]
    want = Predictor(Config(str(tmp_path / "model"))).run(feeds)[0]
    store = create_master_store()
    rep = None
    try:
        rep = SubprocessReplica("r0", store, str(tmp_path), 3,
                                artifact_name="model", start_timeout=300.0)
        trace.enable()
        with trace.root_span("cuda-replica") as root:
            outs, gen = rep.infer_stamped(feeds, timeout=120.0)
        assert gen == 3 and outs[0].dtype == want.dtype
        assert (outs[0] == want).all()
        pids = {s.pid for s in flight.recorder().spans_for(root.trace_id)}
        assert pids == {os.getpid(), rep.pid}
    finally:
        if rep is not None:
            rep.kill()
        store.close()


# ------------------------------------------------------------------ vision

def test_nms_on_the_card_equals_nms_on_the_cpu(cuda):
    """400 boxes (the postprocess's pre-NMS cap), scores with exact ties
    and IoU exactly at the threshold: the indices on the card equal the
    CPU's, and the scan reads the host only once every few rounds."""
    from paddle_tpu_torch.vision import ops

    g = torch.Generator().manual_seed(0)
    xy = torch.rand(400, 2, generator=g) * 600
    wh = torch.rand(400, 2, generator=g) * 200 + 5
    boxes = torch.cat([xy, xy + wh], 1)
    boxes[1] = torch.tensor([0.0, 0.0, 10.0, 5.0])
    boxes[0] = torch.tensor([0.0, 0.0, 10.0, 10.0])      # IoU 0.5 exactly
    for scores in (torch.rand(400, generator=g),
                   torch.randint(0, 7, (400,), generator=g).float()):
        for thr in (0.3, 0.5, 0.6):
            want = ops.nms(boxes, scores, thr)
            got = ops.nms(boxes.cuda(), scores.cuda(), thr)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want), thr


def test_vit_attention_shape_on_the_hopper_bodies(cuda):
    """ViT-B/16's attention (S = 197: 196 patches and the class token, 12
    heads of 64, non-causal, bf16; a tail tile with 5 valid keys of 64):
    forward, dQ and dK/dV each against the plain versions at FLASH_TOL,
    each launch on its Hopper body."""
    q, k, v, do = _flash_case(8, 197, 12, 64, torch.bfloat16, seed=197,
                              fused=True)
    assert tfa.flash_fwd_route(q, k, v)[0] == tfa.FWD_WGMMA
    assert tfa.flash_bwd_route(q, k, v, do)[0] == tfa.BWD_WGMMA
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=False)
    ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal=False)
    assert _err(out, ref) <= FLASH_TOL[torch.bfloat16][0]
    delta = tfa.attention_delta(ref, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta,
                                    causal=False)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta,
                                         causal=False)
    refs = tfa.flash_attention_bwd_ref(q, k, v, do, lse_ref, delta,
                                       causal=False)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert _norm_err(got, r) <= FLASH_TOL[torch.bfloat16][1], name


def test_small_vit_trains_through_the_flash_kernels(cuda):
    """A 2-layer ViT at 224 px (S = 197, heads of 64) trained by
    `parallelize` in bf16: every attention launch a step — 2 forward, 2
    dQ, 2 dK/dV — on the Hopper bodies, and the loss finite."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.vision.models import VisionTransformer

    m = VisionTransformer(embed_dim=128, depth=2, num_heads=2,
                          num_classes=10, device="cuda")
    eng = parallelize(m, AdamW(learning_rate=1e-3,
                               parameters=m.parameters()),
                      loss_fn=lambda mm, x, y: cross_entropy(mm(x), y).mean(),
                      compute_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 3, 224, 224, device="cuda", generator=g)
    y = torch.randint(0, 10, (4,), device="cuda", generator=g)
    wrappers = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    for w in wrappers:
        w.launches = 0
        for r in w.routes:
            w.routes[r] = 0
    losses = [float(eng.train_batch(x, y)) for _ in range(3)]
    assert all(math.isfinite(v) for v in losses)
    assert [w.launches for w in wrappers] == [6, 6, 6]
    assert tfa.flash_attention_fwd.routes[tfa.FWD_WGMMA] == 6
    assert tfa.flash_attention_bwd_dq.routes[tfa.BWD_WGMMA] == 6
    assert tfa.flash_attention_bwd_dkv.routes[tfa.BWD_WGMMA] == 6


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_small_ppyoloe_trains_and_postprocesses_on_the_card(cuda,
                                                            data_format):
    """PP-YOLOE at width 0.25 on 128 px images: a bf16 `parallelize`
    Momentum step on the card, the loss finite and near the CPU's f32 loss
    of the same weights, and `postprocess` returning numpy arrays."""
    import numpy as np

    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import PPYOLOE

    def build(device):
        return PPYOLOE(num_classes=4, width=0.25, max_boxes=4,
                       data_format=data_format, device=device, seed=1)

    rng = np.random.RandomState(0)
    shape = (2, 3, 128, 128) if data_format == "NCHW" else (2, 128, 128, 3)
    img = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    gb = torch.tensor([[[8.0, 8.0, 60.0, 70.0], [30.0, 20.0, 120.0, 90.0],
                        [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]] * 2)
    gl = torch.tensor([[1, 2, 0, 0]] * 2)
    gm = torch.tensor([[1.0, 1.0, 0.0, 0.0]] * 2)
    cpu = build("cpu")
    want = cpu.loss(img, gb, gl, gm).item()
    m = build("cuda")
    m.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        got = m.loss(img.cuda(), gb.cuda(), gl.cuda(), gm.cuda()).item()
    assert abs(got - want) <= 1e-4 * abs(want)
    eng = parallelize(m, Momentum(learning_rate=0.01, momentum=0.9,
                                  parameters=m.parameters()),
                      loss_fn=lambda mm, *b: mm.loss(*b),
                      compute_dtype="bfloat16")
    loss = float(eng.train_batch(img, gb, gl, gm))
    assert math.isfinite(loss)
    m.eval()
    dets = m.postprocess(img.cuda(), score_threshold=0.0)
    assert len(dets) == 2
    for bb, sc, lb in dets:
        assert bb.shape[1:] == (4,) and len(sc) == len(lb) <= 100
        assert np.isfinite(bb).all() and lb.dtype == np.int64


def test_roi_pools_on_the_card_equal_the_cpu_at_integer_edges(cuda):
    """Boxes whose bin edges fall on integers (0..6 in 3 bins: edges 2, 4)
    and on halves: the card's bins are the CPU's exactly (a CUDA division
    by a host scalar multiplies by its reciprocal; `vision.ops._div`
    divides by a device tensor), so the pooled maps are equal."""
    from paddle_tpu_torch.vision import ops

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 18, 40, 44, generator=g)
    boxes = torch.tensor([[0.0, 0.0, 6.0, 6.0], [1.5, 2.5, 7.5, 11.5],
                          [3.0, 1.0, 4.0, 1.05], [0.0, 0.0, 33.0, 21.0],
                          [4.0, 4.0, 31.0, 28.0], [2.0, 3.0, 2.0, 3.0]])
    for scale in (1.0, 0.5, 1.0 / 3):
        want = ops.roi_pool(x, boxes, [3, 3], 3, scale)
        got = ops.roi_pool(x.cuda(), boxes.cuda(), [3, 3], 3, scale)
        assert torch.equal(got.cpu(), want), scale
        want = ops.psroi_pool(x, boxes, [3, 3], 3, scale)
        got = ops.psroi_pool(x.cuda(), boxes.cuda(), [3, 3], 3, scale)
        assert torch.equal(got.cpu() == 0, want == 0), scale
        assert (got.cpu() - want).abs().max() <= 1e-6 * want.abs().max()


def test_detection_ops_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """RoIAlign forward and backward, DCNv2 forward and backward, the
    YOLOv3 loss and its gradient, `yolo_box`, `matrix_nms` and the
    proposal ops at small shapes: floats within 1e-5 of the CPU's
    (gradients normwise), every index and count equal (TF32 off)."""
    import numpy as np

    from paddle_tpu_torch.vision import ops

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    rng = np.random.RandomState(1)

    def both(fn, *arrays):
        outs = []
        for dev in ("cpu", "cuda"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_(
                a.dtype == np.float32) for a in arrays]
            out = fn(*ts)
            out.float().sum().backward() if out.requires_grad else None
            outs.append((out.detach().cpu(), [t.grad.cpu() for t in ts
                                              if t.grad is not None]))
        (a, ga), (b, gb) = outs
        assert (b - a).abs().max() <= 1e-5 * max(a.abs().max(), 1e-30)
        for u, v in zip(ga, gb):
            assert (v - u).norm() <= 1e-5 * u.norm()

    x = rng.randn(2, 8, 50, 60).astype(np.float32)
    xy = rng.uniform(0, 180, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (12, 2))],
                           1).astype(np.float32)
    both(lambda f, b: ops.roi_align(f, b, torch.tensor([5, 7]), 7, 0.25, 0,
                                    True) * 1.5, x, boxes)
    xd = rng.randn(2, 6, 9, 9).astype(np.float32)
    off = rng.randn(2, 18, 9, 9).astype(np.float32)
    w = (rng.randn(6, 6, 3, 3) * 0.2).astype(np.float32)
    mask = rng.rand(2, 9, 9, 9).astype(np.float32)
    both(lambda a, o, ww, m: ops.deform_conv2d(a, o, ww, None, 1, 1, 1, 1, 1,
                                               m), xd, off, w, mask)
    anchors = [10, 13, 16, 30, 33, 23]
    head = rng.randn(2, 3 * 85, 13, 13).astype(np.float32)
    gt = np.zeros((2, 6, 4), np.float32)
    gt[:, :4, :2] = rng.uniform(0.1, 0.9, (2, 4, 2))
    gt[:, :4, 2:] = rng.uniform(0.05, 0.3, (2, 4, 2))
    labels = rng.randint(0, 80, (2, 6))
    both(lambda h, g_: ops.yolo_loss(h, g_, torch.from_numpy(labels).to(
        h.device), anchors, [0, 1, 2], 80, 0.7, 32, use_label_smooth=False),
        head, gt)
    size = torch.tensor([[416, 416], [400, 380]])
    bc, sc = ops.yolo_box(torch.from_numpy(head), size, anchors, 80, 0.01,
                          32)
    bg, sg = ops.yolo_box(torch.from_numpy(head).cuda(), size.cuda(),
                          anchors, 80, 0.01, 32)
    assert (bg.cpu() - bc).abs().max() <= 1e-5 * bc.abs().max()
    assert (sg.cpu() - sc).abs().max() <= 1e-5 * sc.abs().max()
    want = ops.matrix_nms(bc, sc.transpose(1, 2) * 40, 0.05, 0.05, -1, 50,
                          background_label=-1, return_index=True)
    got = ops.matrix_nms(bg, sg.transpose(1, 2) * 40, 0.05, 0.05, -1, 50,
                         background_label=-1, return_index=True)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert (got[0].cpu() - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    ys, xs = np.meshgrid(np.arange(12) * 8.0, np.arange(14) * 8.0,
                         indexing="ij")
    anc = np.stack([xs - 16, ys - 16, xs + 16, ys + 16], -1)[:, :, None]
    anc = np.repeat(anc, 3, 2).astype(np.float32)
    inputs = [rng.randn(2, 3, 12, 14).astype(np.float32),
              (rng.randn(2, 12, 12, 14) * 0.5).astype(np.float32),
              np.array([[96.0, 112.0], [90.0, 100.0]], np.float32), anc,
              np.ones_like(anc)]
    want = ops.generate_proposals(*(torch.from_numpy(a) for a in inputs),
                                  200, 60, 0.7, 0.0, return_rois_num=True)
    got = ops.generate_proposals(*(torch.from_numpy(a).cuda()
                                   for a in inputs), 200, 60, 0.7, 0.0,
                                 return_rois_num=True)
    assert torch.equal(got[2].cpu(), want[2])
    assert (got[0].cpu() - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    outs, restore, nums = ops.distribute_fpn_proposals(
        got[0], 2, 5, 4, 56, rois_num=got[2])
    wouts, wrestore, wnums = ops.distribute_fpn_proposals(
        want[0], 2, 5, 4, 56, rois_num=want[2])
    assert torch.equal(restore.cpu(), wrestore)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(nums, wnums))


@pytest.mark.parametrize("name,size", [("resnext50_32x4d", 64),
                                       ("googlenet", 64),
                                       ("shufflenet_v2_x0_5", 64),
                                       ("mobilenet_v3_small", 64)])
def test_cnn_zoo_step_on_the_card_matches_the_cpu(cuda, name, size,
                                                  monkeypatch):
    """One f32 Momentum step with the batch norms on their running
    statistics: the card's loss and grad norm within 1e-4 of the CPU's
    on the same weights (TF32 off, as in `chip_smoke.py`: cuDNN's TF32
    convolutions moved the grad norm by 1.4e-4); ResNeXt's blocks stay
    off the fused route."""
    import os

    import numpy as np

    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn import BatchNorm2D
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.ops import fused_resblock
    from paddle_tpu_torch.vision import models

    def loss_fn(m, x, y):
        out = m(x)
        out = out[0] if isinstance(out, tuple) else out
        return cross_entropy(out, y).mean()

    def step(device, state):
        m = getattr(models, name)(num_classes=10, data_format="NHWC",
                                  device=device, seed=3)
        m.load_state_dict(state)
        for bn in m.modules():
            if isinstance(bn, BatchNorm2D):
                bn._use_global_stats = True
        eng = parallelize(m, Momentum(learning_rate=0.05, momentum=0.9,
                                      parameters=m.parameters()),
                          loss_fn=loss_fn)
        loss = float(eng.train_batch(x.to(device), y.to(device)))
        return m, (loss, float(eng.last_grad_norm))

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, size, size, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    state = {k: v.clone() for k, v in getattr(models, name)(
        num_classes=10, data_format="NHWC", device="cpu",
        seed=3).state_dict().items()}
    _, want = step("cpu", state)
    before = fused_resblock.fused_bottleneck_fwd.launches
    old = os.environ.get("PADDLE_TPU_FUSED_RESBLOCK")
    os.environ["PADDLE_TPU_FUSED_RESBLOCK"] = "1"
    try:
        _, got = step("cuda", state)
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_FUSED_RESBLOCK")
        else:
            os.environ["PADDLE_TPU_FUSED_RESBLOCK"] = old
    assert fused_resblock.fused_bottleneck_fwd.launches == before
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, want)), \
        (got, want)
