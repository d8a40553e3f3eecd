"""Port parity of CSR-pattern attention on the CPU: the port's
`ops.block_sparse_attention` (tables, plain version, autograd) and
`nn.functional.sparse_attention` / `flash_attn_unpadded` against the JAX
package on the same numpy inputs from a seed. The JAX block-sparse kernel
runs as its own tests run it (`interpret=True`, and its `_bs_reference`).

Tolerances: f32 throughout; the block-sparse and SDDMM outputs 2e-5
absolute (f32 softmax and products summed in another order), gradients
5e-5 absolute; `flash_attn_unpadded` 2e-4 against the per-segment dense
reference, as tests/test_sparse_attention.py; the tables are equal.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF

from paddle_tpu_torch.nn import functional as tF

# the modules (their packages export functions of the same names)
jbs = importlib.import_module("paddle_tpu.ops.pallas.block_sparse_attention")
tbs = importlib.import_module("paddle_tpu_torch.ops.block_sparse_attention")

ATOL, GRAD_ATOL = 2e-5, 5e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _csr_from_mask(mask2d):
    """token mask [S, S] -> (offset [S + 1], columns [nnz]) int64."""
    counts = mask2d.sum(1)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offset, np.nonzero(mask2d)[1].astype(np.int64)


def _block_mask(nb, seed, density=0.4):
    rng = np.random.default_rng(seed)
    bm = rng.uniform(0, 1, (nb, nb)) < density
    bm[np.arange(nb), np.arange(nb)] = True
    return bm


def _token_mask(block_mask, bs):
    return np.kron(block_mask, np.ones((bs, bs), bool))


def _tables_cases():
    bs = 16
    exact = _token_mask(_block_mask(6, 0), bs)
    holed = exact.copy()
    holed[17, 20] = False                       # a hole in tile (1, 1)
    rnd = np.random.default_rng(1).uniform(0, 1, (96, 96)) < 0.1
    empty_row = _token_mask(np.array([[1, 0, 0], [0, 0, 0], [1, 1, 1]],
                                     bool), 32)
    return {"exact": (exact, bs), "holed": (holed, bs),
            "random": (rnd, bs), "empty row block": (empty_row, 32)}


TABLE_CASES = _tables_cases()


@pytest.mark.parametrize("name", sorted(TABLE_CASES))
def test_csr_to_block_tables_matches_jax(name):
    mask, bs = TABLE_CASES[name]
    S = mask.shape[0]
    off, col = _csr_from_mask(mask)
    want = jbs.csr_to_block_tables(off, col, S, bs)
    got = tbs.csr_to_block_tables(off, col, S, bs)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2]
    assert got[2] == (name in ("exact", "empty row block"))


def test_csr_to_block_tables_counts_duplicates_once():
    """A listed pair repeated does not make a holed tile exact."""
    mask = _token_mask(np.eye(2, dtype=bool), 8)
    mask[0, 1] = False
    off, col = _csr_from_mask(mask)
    col = np.insert(col, 0, col[0])           # row 0 lists one column twice
    off[1:] += 1
    assert tbs.csr_to_block_tables(off, col, 16, 8)[2] is False
    assert jbs.csr_to_block_tables(off, col, 16, 8)[2] is False


def _bs_case(BH, S, D, bs, seed):
    nq = S // bs
    bm = _block_mask(nq, seed)
    bm[1 % nq] = False                           # a query block with no keys
    off, col = _csr_from_mask(_token_mask(bm, bs))
    bidx, bcnt, exact = tbs.csr_to_block_tables(off, col, S, bs)
    assert exact
    q, k, v = (_rand((BH, S, D), seed + i) for i in range(3))
    return q, k, v, bidx, bcnt


@pytest.mark.parametrize("BH,S,D,bs", [(3, 256, 32, 128), (2, 96, 8, 16)])
def test_block_sparse_ref_matches_jax(BH, S, D, bs):
    q, k, v, bidx, bcnt = _bs_case(BH, S, D, bs, seed=BH)
    scale = 0.25
    want = np.asarray(jbs._bs_reference(
        *map(jnp.asarray, (q, k, v, bidx, bcnt)), scale=scale,
        block_size=bs))
    got = tbs.block_sparse_attention_ref(
        *map(torch.from_numpy, (q, k, v, bidx, bcnt)), scale, bs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the query block with no listed key gives exactly 0
    assert not got.numpy()[:, bs:2 * bs].any()


def test_block_sparse_matches_jax_interpret_kernel():
    q, k, v, bidx, bcnt = _bs_case(3, 256, 32, 128, seed=7)
    want = np.asarray(jbs.block_sparse_attention(
        *map(jnp.asarray, (q, k, v, bidx, bcnt)), 0.25, 128,
        interpret=True))
    before = tbs.block_sparse_attention.launches
    got = tbs.block_sparse_attention(
        *map(torch.from_numpy, (q, k, v, bidx, bcnt)), 0.25, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tbs.block_sparse_attention.launches == before   # CPU: no kernel


def test_block_sparse_gradients_match_jax_vjp():
    q, k, v, bidx, bcnt = _bs_case(2, 96, 8, 16, seed=3)
    g = _rand(q.shape, 11)
    _, vjp = jax.vjp(lambda a, b, c: jbs.block_sparse_attention(
        a, b, c, jnp.asarray(bidx), jnp.asarray(bcnt), 0.3, 16),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tbs.block_sparse_attention(*leaves, torch.from_numpy(bidx),
                                     torch.from_numpy(bcnt), 0.3, 16)
    out.backward(torch.from_numpy(g))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, rtol=0)


def test_block_sparse_checks_shapes():
    q = torch.zeros(2, 256, 16)
    idx = torch.zeros(2, 1, dtype=torch.int32)
    cnt = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):                  # S % block_size
        tbs.block_sparse_attention(q[:, :200], q[:, :200], q[:, :200], idx,
                                   cnt, 1.0, 128)
    with pytest.raises(ValueError):                  # table rows != nq
        tbs.block_sparse_attention(q, q, q, idx[:1], cnt[:1], 1.0, 128)
    with pytest.raises(ValueError):                  # k of another shape
        tbs.block_sparse_attention(q, q[:1], q, idx, cnt, 1.0, 128)


# ----------------------------------------------------------- the public op

def _op_inputs(B, H, S, D, masks, seed):
    """q, k, v [B, H, S, D] and the CSR of per-(b, h) token masks."""
    q, k, v = (_rand((B, H, S, D), seed + i) for i in range(3))
    csr = [_csr_from_mask(m) for m in masks]
    width = max(len(c) for _, c in csr)
    offset = np.stack([o for o, _ in csr]).reshape(B, H, S + 1)
    columns = np.stack([np.pad(c, (0, width - len(c))) for _, c in csr]
                       ).reshape(B, H, width)
    return q, k, v, offset, columns


def _jax_op(q, k, v, offset, columns, kpm=None, am=None, g=None):
    """The JAX package's F.sparse_attention; with g, also d(sum(out * g))
    for q, k, v through its autograd (jax.vjp underneath)."""
    ts = [paddle.to_tensor(a, stop_gradient=g is None) for a in (q, k, v)]
    out = jF.sparse_attention(
        *ts, paddle.to_tensor(offset), paddle.to_tensor(columns),
        key_padding_mask=None if kpm is None else paddle.to_tensor(kpm),
        attn_mask=None if am is None else paddle.to_tensor(am))
    if g is None:
        return out.numpy(), None
    (out * paddle.to_tensor(g)).sum().backward()
    return out.numpy(), [t.grad.numpy() for t in ts]


def _port_op(q, k, v, offset, columns, kpm=None, am=None, g=None):
    ts = [torch.from_numpy(a).requires_grad_(g is not None)
          for a in (q, k, v)]
    out = tF.sparse_attention(
        *ts, torch.from_numpy(offset), torch.from_numpy(columns),
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        attn_mask=None if am is None else torch.from_numpy(am))
    if g is None:
        return out.detach().numpy(), None
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _block_route_case():
    B, H, S, D = 1, 2, 512, 16
    mask = _token_mask(_block_mask(4, 5), 128)
    mask[128:256] = False                        # a query block with no keys
    return _op_inputs(B, H, S, D, [mask] * (B * H), seed=20)


def _sddmm_case(with_masks):
    B, H, S, D = 2, 2, 16, 8
    rng = np.random.default_rng(9)
    masks = []
    for _ in range(B * H):                       # a pattern per head
        m = rng.uniform(0, 1, (S, S)) > 0.6
        m |= np.eye(S, dtype=bool)
        masks.append(m)
    args = _op_inputs(B, H, S, D, masks, seed=30)
    if not with_masks:
        return args, None, None
    kpm = np.where(rng.uniform(0, 1, (B, S)) < 0.2, -1e4, 0.0).astype(
        np.float32)
    am = (0.5 * rng.standard_normal((S, S))).astype(np.float32)
    return args, kpm, am


@pytest.mark.parametrize("route", ["block", "sddmm", "sddmm with masks"])
def test_sparse_attention_matches_jax(route, monkeypatch):
    calls = []
    real = tbs.block_sparse_attention
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.functional.attention.block_sparse_attention",
        lambda *a: calls.append(1) or real(*a))
    if route == "block":
        args, kpm, am = _block_route_case(), None, None
    else:
        args, kpm, am = _sddmm_case(route == "sddmm with masks")
    g = _rand(args[0].shape, 40)
    want, wgrads = _jax_op(*args, kpm, am, g)
    got, grads = _port_op(*args, kpm, am, g)
    assert len(calls) == (route == "block")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip(grads, wgrads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0)


def test_sparse_attention_block_route_empty_rows_and_dense_reference():
    """Rows with no key give 0, the rest the dense masked softmax."""
    q, k, v, offset, columns = _block_route_case()
    got, _ = _port_op(q, k, v, offset, columns)
    mask = _token_mask(_block_mask(4, 5), 128)
    mask[128:256] = False
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(mask, s, -np.inf)
    with np.errstate(invalid="ignore"):
        p = np.exp(s - s.max(-1, keepdims=True))
        p = np.nan_to_num(p / p.sum(-1, keepdims=True))
    np.testing.assert_allclose(got, np.einsum("bhqk,bhkd->bhqd", p, v),
                               atol=ATOL, rtol=0)
    assert not got[:, :, 128:256].any()


def test_sparse_attention_unshared_exact_pattern_takes_sddmm(monkeypatch):
    """Exact tiles that differ between heads: the SDDMM route, as JAX."""
    B, H, S, D = 1, 2, 256, 8
    masks = [_token_mask(np.eye(2, dtype=bool), 128),
             _token_mask(np.ones((2, 2), bool), 128)]
    args = _op_inputs(B, H, S, D, masks, seed=50)
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.functional.attention.block_sparse_attention",
        lambda *a: pytest.fail("the block route took an unshared CSR"))
    got, _ = _port_op(*args)
    want, _ = _jax_op(*args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ------------------------------------------------------ flash_attn_unpadded

def _segments_ref(q, k, v, cu, scale, causal):
    ref = np.zeros_like(q)
    for i in range(len(cu) - 1):
        s, e = cu[i], cu[i + 1]
        qs, ks, vs = (t[s:e].transpose(1, 0, 2) for t in (q, k, v))
        sc = qs @ ks.transpose(0, 2, 1) * scale
        if causal:
            sc = np.where(np.tril(np.ones((e - s, e - s), bool)), sc, -1e30)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        ref[s:e] = ((p / p.sum(-1, keepdims=True)) @ vs).transpose(1, 0, 2)
    return ref


@pytest.mark.parametrize("lens,H,D,scale,causal,seed", [
    ([5, 3, 7], 2, 8, 0.3, False, 1),
    ([4, 6], 1, 4, 0.5, True, 4),
])
def test_flash_attn_unpadded_matches_jax(lens, H, D, scale, causal, seed):
    """The cases of tests/test_sparse_attention.py."""
    total = sum(lens)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q, k, v = (_rand((total, H, D), seed + i) for i in range(3))
    want, _ = jF.flash_attn_unpadded(
        *(paddle.to_tensor(a) for a in (q, k, v, cu, cu)), max(lens),
        max(lens), scale, causal=causal)
    got, none = tF.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in (q, k, v, cu, cu)), max(lens),
        max(lens), scale, causal=causal)
    assert none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               _segments_ref(q, k, v, cu, scale, causal),
                               atol=2e-4, rtol=2e-4)


def test_flash_attn_unpadded_refuses_dropout_and_probabilities():
    x = torch.zeros(4, 1, 4)
    cu = torch.tensor([0, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tF.flash_attn_unpadded(x, x, x, cu, cu, 4, 4, 1.0, dropout=0.1)
    with pytest.raises(NotImplementedError):
        tF.flash_attn_unpadded(x, x, x, cu, cu, 4, 4, 1.0,
                               return_softmax=True)


# ------------------------------------------- the kernel's body (CUDA route)

@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 40, 1), (torch.bfloat16, 33, 0),
    (torch.bfloat16, 32, 0), (torch.bfloat16, 256, 0),
    (torch.float32, 64, 0), (torch.float32, 128, 0)])
def test_block_sparse_route_by_dtype_and_head_dim(dtype, D, want):
    """`block_sparse_route`: the flash forward's Hopper body under the
    block-table policy (BS_WGMMA = 1) for bf16 at 32 < D <= 128 with
    D % 8 == 0, `bs_fwd` (BS_MMA = 0) for f32, D <= 32 and D > 128 (the
    range the flash Hopper body takes)."""
    q = torch.zeros(2, 256, D, dtype=dtype)
    assert (tbs.BS_MMA, tbs.BS_WGMMA) == (0, 1)
    assert tbs.block_sparse_route(q, q, q, D ** -0.5) == want


def test_block_sparse_route_needs_aligned_operands_and_a_scale():
    """The Hopper body's tensor maps need 16-byte aligned bases, and its
    softmax a positive scale: anything else takes `bs_fwd`."""
    q = torch.zeros(2, 256, 64, dtype=torch.bfloat16)
    assert tbs.block_sparse_route(q, q, q, 0.125) == tbs.BS_WGMMA
    flat = torch.zeros(2 * 256 * 64 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 256, 64)                 # 2 bytes off
    assert odd.data_ptr() % 16 != 0
    assert tbs.block_sparse_route(odd, q, q, 0.125) == tbs.BS_MMA
    assert tbs.block_sparse_route(q, q, odd, 0.125) == tbs.BS_MMA
    assert tbs.block_sparse_route(q, q, q, 0.0) == tbs.BS_MMA
    assert tbs.block_sparse_route(q, q.float(), q, 0.125) == tbs.BS_MMA


def test_block_sparse_cpu_call_counts_no_route():
    """A CPU call takes the plain version: no body's count moves."""
    q, k, v, bidx, bcnt = _bs_case(2, 256, 64, 128, seed=5)
    before = dict(tbs.block_sparse_attention.routes)
    tbs.block_sparse_attention(*map(torch.from_numpy, (q, k, v, bidx, bcnt)),
                               0.125, 128)
    assert tbs.block_sparse_attention.routes == before
    assert set(before) == {tbs.BS_MMA, tbs.BS_WGMMA}
