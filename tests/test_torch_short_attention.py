"""Port parity of the short-attention kernels' plain versions
(`paddle_tpu_torch.ops.short_attention`) and of the dropout bit stream
(`ops._dropout_rng`) on the CPU.

* p = 0: forward and all three gradients against the JAX package's
  `short_attention` in interpret mode (as tests/test_short_attention.py
  runs it), f32, atol 1e-5.
* p > 0: the TPU's in-kernel stream cannot be reproduced, so the port is
  held to its own definition: the kept share within 4 sigma of 1 - p, the
  output equal to an explicit composition with the materialised mask, the
  gradients equal to autograd through that composition (f32, 1e-5), the
  same seed giving the same bits and other (b, h) other masks.
* The Philox4x32-10 stream against Random123's known-answer vectors and
  the mask's element layout against the formula the kernels compute.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops.pallas import short_attention as jsa

from paddle_tpu_torch.ops import _dropout_rng as rng
from paddle_tpu_torch.nn import functional as TF

tsa = importlib.import_module("paddle_tpu_torch.ops.short_attention")


def _qkv(B, S, H, D, seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _t(a, grad=False):
    return torch.from_numpy(a.copy()).requires_grad_(grad)


def _seed(s):
    return torch.tensor([s], dtype=torch.int64)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,D", [(2, 16, 3, 8), (1, 40, 2, 24)])
def test_plain_matches_jax_kernel_at_p0(causal, B, S, H, D):
    q, k, v, cot = _qkv(B, S, H, D, seed=S + D)
    jseed = jnp.zeros((1,), jnp.int32)
    with jax.default_matmul_precision("highest"):
        jout = jsa.short_attention(*map(jnp.asarray, (q, k, v)), jseed, 0.0,
                                   causal)
        jgrads = jax.grad(lambda a, b, c: jnp.sum(
            jsa.short_attention(a, b, c, jseed, 0.0, causal) * cot),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    out = tsa.short_attention(tq, tk, tv, _seed(0), 0.0, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    out.backward(torch.from_numpy(cot))
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("S", [128, 136])
def test_kept_share_within_4_sigma(p, S):
    B, H = 3, 4
    keep = rng.keep_mask(_seed(1234), B, H, S, S, p)
    n = keep.numel()
    share = keep.double().mean().item()
    assert abs(share - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), share
    z = rng.dropout_mask(_seed(1234), B, H, S, S, p)
    assert set(torch.unique(z).tolist()) == {0.0, np.float32(1 / (1 - p))}


def _composed(q, k, v, mask, causal):
    """Attention with the materialised dropout factor, by autograd."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    probs = torch.softmax(s, dim=-1) * mask
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_equals_composition_with_materialised_mask(causal, p):
    B, S, H, D = 2, 24, 3, 16
    q, k, v, cot = _qkv(B, S, H, D, seed=7)
    seed = _seed(99)
    mask = rng.dropout_mask(seed, B, H, S, S, p)
    leaves = [_t(x, grad=True) for x in (q, k, v)]
    out = tsa.short_attention(*leaves, seed, p, causal)
    out.backward(torch.from_numpy(cot))
    refs = [_t(x, grad=True) for x in (q, k, v)]
    ref = _composed(*refs, mask, causal)
    ref.backward(torch.from_numpy(cot))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    for name, a, b in zip("qkv", leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5,
                                   msg=f"d{name}")
    # the plain backward is the gradient of the plain forward
    o, lse = tsa.short_attention_ref(*refs, seed, p, causal)
    auto = torch.autograd.grad(o, refs, torch.from_numpy(cot))
    plain = tsa.short_attention_bwd_ref(*refs, torch.from_numpy(cot),
                                        lse.detach(), seed, p, causal)
    for a, b in zip(plain, auto):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_same_seed_same_bits_other_heads_other_masks():
    B, S, H, D = 2, 32, 2, 8
    q, k, v, _ = _qkv(B, S, H, D, seed=3)
    tq, tk, tv = map(_t, (q, k, v))
    a = tsa.short_attention(tq, tk, tv, _seed(5), 0.3)
    b = tsa.short_attention(tq, tk, tv, _seed(5), 0.3)
    c = tsa.short_attention(tq, tk, tv, _seed(6), 0.3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    keep = rng.keep_mask(_seed(5), B, H, S, S, 0.3)
    heads = [keep[i, j] for i in range(B) for j in range(H)]
    for x in range(len(heads)):
        for y in range(x + 1, len(heads)):
            assert not torch.equal(heads[x], heads[y]), (x, y)


def test_supported_gate_agrees_with_jax():
    shapes = [(8, 128, 12, 64), (8, 1024, 12, 64), (8, 130, 12, 64),
              (8, 512, 12, 64), (8, 136, 12, 40), (2, 64, 4, 12),
              (1, 8, 1, 8)]
    for shape in shapes:
        assert tsa.supported(shape, None, None) == jsa.supported(
            shape, None, None), shape
        assert not tsa.supported(shape, np.zeros(1), None)
    for p in (-0.1, 0.0, 0.1, 0.999, 1.0, 1.5):
        assert tsa.supports_p(p) == jsa.supports_p(p), p
    # what the card's kernels add: D <= 256, f32 or bf16
    assert not tsa.supported((1, 128, 1, 264), None, None)
    assert not tsa.supported((1, 128, 1, 64), None, torch.float16)


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = rng.philox4x32(*(torch.tensor(c) for c in ctr),
                             *(torch.tensor(x) for x in key))
        assert tuple(int(w) for w in got) == want


def test_mask_layout_is_the_kernels_formula():
    """Element (b, h, i, j) is word 2 * bit3(i) + bit3(j) of Philox at
    counter (j & ~8, i & ~8, h, b) under key (seed lo, seed hi)."""
    seed = (0x1234_5678 << 32) | 0x9ABC_DEF0
    B, H, Sq, Sk, p = 2, 3, 40, 24, 0.25
    keep = rng.keep_mask(_seed(seed), B, H, Sq, Sk, p)
    thr = rng.keep_threshold(p)
    r = np.random.RandomState(0)
    for _ in range(64):
        b, h, i, j = (r.randint(n) for n in (B, H, Sq, Sk))
        words = rng.philox4x32(*(torch.tensor(x) for x in
                                 (j & ~8, i & ~8, h, b)),
                               torch.tensor(seed & 0xFFFFFFFF),
                               torch.tensor(seed >> 32))
        w = words[2 * ((i >> 3) & 1) + ((j >> 3) & 1)]
        assert bool(keep[b, h, i, j]) == (int(w) >= thr), (b, h, i, j)


def test_sdpa_routes_cpu_dropout_to_the_plain_short_attention():
    """Training-mode dropout on a shape the kernels take goes through the
    short-attention route (here its plain versions, so no kernel counts);
    a seed drawn from the caller's generator makes two calls equal."""
    q, k, v, _ = _qkv(2, 32, 2, 16, seed=11)
    tq, tk, tv = map(_t, (q, k, v))
    counts = (tsa.short_attention_fwd.launches,
              tsa.short_attention_bwd.launches)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(42)
        outs.append(TF.scaled_dot_product_attention(
            tq, tk, tv, dropout_p=0.1, generator=g))
    assert torch.equal(*outs)
    g = torch.Generator().manual_seed(42)
    seed = rng.draw_seed(g)
    ref = tsa.short_attention_ref(tq, tk, tv, seed, 0.1)[0]
    assert torch.equal(outs[0], ref)
    assert (tsa.short_attention_fwd.launches,
            tsa.short_attention_bwd.launches) == counts
    # eval mode is plain attention, no dropout
    ev = TF.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.1,
                                         training=False)
    torch.testing.assert_close(ev, tsa.short_attention_ref(
        tq, tk, tv, seed, 0.0)[0], rtol=0, atol=1e-6)


def test_sdpa_composed_paths_match_jax():
    """`attn_mask` without dropout (the additive-bias path) against the
    JAX package's, f32; with dropout and a mask, the composed path equals
    the same composition with the stream's materialised mask."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    B, S, H, D = 2, 16, 2, 8
    q, k, v, _ = _qkv(B, S, H, D, seed=4)
    keep = np.ones((B, S), np.float32)
    keep[:, 11:] = 0
    bias = np.where(keep[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jout = JF.scaled_dot_product_attention(
            *(paddle.to_tensor(x) for x in (q, k, v)),
            attn_mask=paddle.to_tensor(bias)).numpy()
    tq, tk, tv = map(_t, (q, k, v))
    out = TF.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    g = torch.Generator().manual_seed(8)
    got = TF.scaled_dot_product_attention(
        tq, tk, tv, attn_mask=torch.from_numpy(bias), dropout_p=0.2,
        generator=g)
    seed = rng.draw_seed(torch.Generator().manual_seed(8))
    mask = rng.dropout_mask(seed, B, H, S, S, 0.2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(D) \
        + torch.from_numpy(bias)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1) * mask, tv)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="additive"):
        TF.scaled_dot_product_attention(tq, tk, tv,
                                        attn_mask=torch.ones(B, 1, 1, S,
                                                             dtype=bool))


def _meta_qkv(B, S, H, D, dtype=torch.bfloat16):
    """q, k, v as views of one fused [B, S, 3, H, D] tensor (BERT's QKV)
    without memory: meta tensors keep the shapes, strides and offsets."""
    return torch.empty(B, S, 3, H, D, dtype=dtype, device="meta").unbind(2)


@pytest.mark.parametrize("case,shape,dtype,route", [
    ("bert_base", (128, 128, 12, 64), torch.bfloat16, "wgmma"),
    ("S = 512", (16, 512, 12, 64), torch.bfloat16, "wgmma"),
    ("S = 136", (32, 136, 12, 64), torch.bfloat16, "wgmma"),
    ("D = 128", (8, 128, 4, 128), torch.bfloat16, "wgmma"),
    ("bert_base f32", (128, 128, 12, 64), torch.float32, "mma"),
    ("D = 256", (2, 64, 3, 256), torch.bfloat16, "mma"),
    ("D = 32", (2, 128, 3, 32), torch.bfloat16, "mma"),
    ("S = 520", (1, 520, 2, 64), torch.bfloat16, "mma"),
])
def test_fwd_route_predicate_on_the_slices_shapes(case, shape, dtype, route):
    q, k, v = _meta_qkv(*shape, dtype=dtype)
    want = {"wgmma": tsa.FWD_WGMMA, "mma": tsa.FWD_MMA}[route]
    assert tsa.short_fwd_route(q, k, v)[0] == want, case


def test_fwd_route_predicate_refuses_what_tma_cannot_describe():
    """A base off 16 bytes keeps the mma.sync body; views with a stride
    along D are launched as unit-stride copies, which the route returns
    and the Hopper body takes."""
    q, k, v = _meta_qkv(2, 128, 4, 64)
    assert tsa.short_fwd_route(q, k, v)[0] == tsa.FWD_WGMMA
    strided = torch.empty(2, 128, 4, 128, dtype=torch.bfloat16,
                          device="meta")[..., ::2]
    route, ops, _, strides = tsa.short_fwd_route(strided, k, v)
    assert route == tsa.FWD_WGMMA
    assert ops[0] is not strided and strides[0] == (32768, 256, 64, 1)
    base = torch.empty(2 * 128 * 4 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    assert tsa.short_fwd_route(base[4:].view(2, 128, 4, 64), k, v)[0] \
        == tsa.FWD_MMA


def test_fwd_route_counts_name_both_bodies_and_a_cpu_call_counts_none():
    """`short_attention_fwd.routes` counts launches by body where the
    kernel is launched; the plain version on the CPU launches none."""
    assert set(tsa.short_attention_fwd.routes) == {tsa.FWD_MMA,
                                                   tsa.FWD_WGMMA}
    q, k, v, _ = _qkv(1, 32, 2, 64, seed=12)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    before = dict(tsa.short_attention_fwd.routes)
    tsa.short_attention_fwd(tq, tk, tv, _seed(3), 0.1)
    assert tsa.short_attention_fwd.routes == before


@pytest.mark.parametrize("case,shape,dtype,route", [
    ("bert_base", (128, 128, 12, 64), torch.bfloat16, "wgmma"),
    ("S = 512", (16, 512, 12, 64), torch.bfloat16, "wgmma"),
    ("S = 136", (32, 136, 12, 64), torch.bfloat16, "wgmma"),
    ("D = 128", (8, 128, 4, 128), torch.bfloat16, "wgmma"),
    ("D = 40", (32, 128, 12, 40), torch.bfloat16, "wgmma"),
    ("bert_base f32", (128, 128, 12, 64), torch.float32, "mma"),
    ("D = 256", (2, 64, 3, 256), torch.bfloat16, "mma"),
    ("D = 32", (2, 128, 3, 32), torch.bfloat16, "mma"),
    ("S = 520", (1, 520, 2, 64), torch.bfloat16, "mma"),
])
def test_bwd_route_predicate_on_the_slices_shapes(case, shape, dtype, route):
    """`short_bwd_route` takes the Hopper bodies where the forward's
    Hopper body is taken (bf16, 32 < D <= 128, TMA-describable views,
    S <= 512) and the mma.sync bodies elsewhere."""
    q, k, v = _meta_qkv(*shape, dtype=dtype)
    do = torch.empty(shape, dtype=dtype, device="meta")
    want = {"wgmma": tsa.BWD_WGMMA, "mma": tsa.BWD_MMA}[route]
    assert tsa.short_bwd_route(q, k, v, do)[0] == want, case
    assert (tsa.short_bwd_route(q, k, v, do)[0] == tsa.BWD_WGMMA) \
        == (tsa.short_fwd_route(q, k, v)[0] == tsa.FWD_WGMMA), case


def test_bwd_route_predicate_refuses_what_tma_cannot_describe():
    """The route looks at dO as well: a dO off 16 bytes or of another
    dtype keeps the mma.sync bodies; a dO with a stride along D is
    launched as a unit-stride copy, which the route returns."""
    q, k, v = _meta_qkv(2, 128, 4, 64)
    do = torch.empty(2, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    assert tsa.short_bwd_route(q, k, v, do)[0] == tsa.BWD_WGMMA
    base = torch.empty(2 * 128 * 4 * 64 + 4, dtype=torch.bfloat16,
                       device="meta")
    assert tsa.short_bwd_route(q, k, v, base[4:].view(2, 128, 4, 64))[0] \
        == tsa.BWD_MMA
    assert tsa.short_bwd_route(q, k, v, do.float())[0] == tsa.BWD_MMA
    strided = torch.empty(2, 128, 4, 128, dtype=torch.bfloat16,
                          device="meta")[..., ::2]
    route, ops, _, strides = tsa.short_bwd_route(q, k, v, strided)
    assert route == tsa.BWD_WGMMA
    assert ops[3] is not strided and strides[3] == (32768, 256, 64, 1)


def test_bwd_route_counts_name_both_bodies_and_a_cpu_call_counts_none():
    """`short_attention_bwd.routes` counts launches by body (two a call)
    where the kernels are launched; the plain version on the CPU launches
    none."""
    assert set(tsa.short_attention_bwd.routes) == {tsa.BWD_MMA,
                                                   tsa.BWD_WGMMA}
    q, k, v, do = _qkv(1, 32, 2, 64, seed=13)
    tq, tk, tv, tdo = (_t(x).to(torch.bfloat16) for x in (q, k, v, do))
    before = (dict(tsa.short_attention_bwd.routes),
              tsa.short_attention_bwd.launches)
    _, lse = tsa.short_attention_fwd(tq, tk, tv, _seed(3), 0.1)
    tsa.short_attention_bwd(tq, tk, tv, tdo, lse, _seed(3), 0.1)
    assert (tsa.short_attention_bwd.routes,
            tsa.short_attention_bwd.launches) == before
