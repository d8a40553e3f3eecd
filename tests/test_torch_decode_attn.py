"""Port parity: single-query decode attention
(`paddle_tpu_torch.ops.decode_attn`) against the JAX package's
`paged_decode_attention` — its Pallas kernel in interpret mode and its XLA
gather path — on the cases of tests/test_decode_attn.py: MHA and GQA,
float and int8 pools, positions mid-block and in the first block, table
tails at block 0, garbage in every block; and its dense
`decode_attention` (Pallas kernel in interpret mode) on that file's MHA,
GQA, float-cache, uneven-ratio and future-mask cases. The port runs on
the CPU (the plain versions); the CUDA kernels are compared with them in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas.decode_attn import decode_attention as jda
from paddle_tpu.ops.pallas.decode_attn import paged_decode_attention as jpda

from paddle_tpu_torch.models.gpt import _quant_kv
from paddle_tpu_torch.ops import decode_attn as td

# f32 softmax and products in another order: 3e-5 absolute, the JAX
# suite's own tolerance for these cases
ATOL = 3e-5


def _case(B, H, Hkv, D, BS, NB, N, pos, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kq = rng.randn(N, Hkv, BS, D).astype(np.float32)
    vq = rng.randn(N, Hkv, BS, D).astype(np.float32)
    avail = list(range(1, N))
    rng.shuffle(avail)
    tables = np.zeros((B, NB), np.int32)
    for b in range(B):
        used = pos[b] // BS + 1
        tables[b, :used] = [avail.pop() for _ in range(used)]
    return q, kq, vq, tables, np.asarray(pos, np.int32)


CASES = {
    "gqa_mid_block": dict(B=2, H=4, Hkv=2, D=8, BS=4, NB=3, N=8,
                          pos=[5, 10]),
    "mha_ragged": dict(B=3, H=4, Hkv=4, D=16, BS=4, NB=4, N=12,
                       pos=[2, 9, 15]),
    "first_block_pos0": dict(B=1, H=2, Hkv=2, D=8, BS=4, NB=2, N=4,
                             pos=[0]),
}


def _jax(q, kq, ks, vq, vs, tables, pos, use_kernel):
    return np.asarray(jpda(*(jnp.asarray(a) for a in
                             (q, kq, ks, vq, vs, tables, pos)),
                           use_kernel=use_kernel, interpret=True))


def _port(q, kq, ks, vq, vs, tables, pos):
    t = [None if a is None else torch.from_numpy(np.asarray(a))
         for a in (q, kq, ks, vq, vs, tables, pos)]
    return td.paged_decode_attention(*t).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_float_pool_matches_jax(name, use_kernel):
    q, kq, vq, tables, pos = _case(**CASES[name], seed=len(name))
    ones = np.ones(kq.shape[:-1] + (1,), np.float32)
    ref = _jax(q, kq, ones, vq, ones, tables, pos, use_kernel)
    np.testing.assert_allclose(_port(q, kq, None, vq, None, tables, pos),
                               ref, atol=ATOL)
    # explicit unit scales are the same function
    np.testing.assert_allclose(_port(q, kq, ones, vq, ones, tables, pos),
                               ref, atol=ATOL)


@pytest.mark.parametrize("name", ["gqa_mid_block", "mha_ragged"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_int8_pool_matches_jax(name, use_kernel):
    q, kq, vq, tables, pos = _case(**CASES[name], seed=7)
    k8, ks = (t.numpy() for t in _quant_kv(torch.from_numpy(kq)))
    v8, vs = (t.numpy() for t in _quant_kv(torch.from_numpy(vq)))
    ks, vs = ks[..., None], vs[..., None]                 # [N, Hkv, BS, 1]
    ref = _jax(q, k8, ks, v8, vs, tables, pos, use_kernel)
    np.testing.assert_allclose(_port(q, k8, ks, v8, vs, tables, pos), ref,
                               atol=ATOL)


def test_tail_blocks_and_block0_never_attended():
    """Poison block 0 and every block no table references: the result
    must not move."""
    q, kq, vq, tables, pos = _case(**CASES["mha_ragged"], seed=3)
    base = _port(q, kq, None, vq, None, tables, pos)
    used = set(tables[tables > 0].tolist())
    poisoned_k, poisoned_v = kq.copy(), vq.copy()
    for blk in range(kq.shape[0]):
        if blk not in used:
            poisoned_k[blk] = 1e4
            poisoned_v[blk] = 1e4
    # rows past pos inside the last used block are masked too
    got = _port(q, poisoned_k, None, poisoned_v, None, tables, pos)
    np.testing.assert_allclose(got, base, atol=ATOL)


def test_strided_engine_view_equals_kernel_layout():
    """The engine passes a permuted view of its [N, BS, Hkv, D] pool; it
    must give the contiguous kernel-layout result."""
    q, kq, vq, tables, pos = _case(**CASES["gqa_mid_block"], seed=11)
    k_eng = torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 1, 3)))
    v_eng = torch.from_numpy(np.ascontiguousarray(vq.transpose(0, 2, 1, 3)))
    view_k, view_v = k_eng.permute(0, 2, 1, 3), v_eng.permute(0, 2, 1, 3)
    assert not view_k.is_contiguous()
    got = td.paged_decode_attention(
        torch.from_numpy(q), view_k, None, view_v, None,
        torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(),
                               _port(q, kq, None, vq, None, tables, pos),
                               atol=1e-6)


def test_validation_errors():
    q, kq, vq, tables, pos = (torch.from_numpy(a) for a in
                              _case(**CASES["gqa_mid_block"]))
    with pytest.raises(ValueError):                    # q_len 2
        td.paged_decode_attention(q.expand(2, 2, 4, 8), kq, None, vq, None,
                                  tables, pos)
    with pytest.raises(ValueError):                    # one scale only
        td.paged_decode_attention(q, kq, torch.ones(8, 2, 4), vq, None,
                                  tables, pos)
    with pytest.raises(ValueError):                    # H % Hkv
        td.paged_decode_attention(q[:, :, :3], kq, None, vq, None, tables,
                                  pos)


# ------------------------------------------------- dense (contiguous cache)

def _quant(x):
    """tests/test_decode_attn.py's per-row int8 quantisation."""
    amax = np.abs(x).max(-1, keepdims=True)
    s = np.maximum(amax, 1e-8) / 127.0
    return (np.clip(np.round(x / s), -127, 127).astype(np.int8),
            s.astype(np.float32))


def _dense_case(B, T, H, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32))


DENSE_CASES = {   # tests/test_decode_attn.py: (B, T, H, Hkv, D, pos, int8)
    "int8_mha": (2, 32, 4, 4, 8, 20, True),
    "int8_gqa": (2, 16, 8, 2, 8, 9, True),
    "float_cache": (1, 16, 2, 2, 8, 5, False),
    "float_gqa_last_row": (2, 24, 6, 3, 16, 23, False),
}


def _dense_both(q, kq, ks, vq, vs, pos):
    want = np.asarray(jda(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs)),
                          pos, interpret=True))
    got = td.decode_attention(*(torch.from_numpy(a)
                                for a in (q, kq, ks, vq, vs)), pos)
    return got.numpy(), want


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_decode_attention_matches_jax(name):
    B, T, H, Hkv, D, pos, int8 = DENSE_CASES[name]
    q, k, v = _dense_case(B, T, H, Hkv, D)
    if int8:
        (kq, ks), (vq, vs) = _quant(k), _quant(v)
    else:
        kq, vq = k, v
        ks = vs = np.ones(k.shape[:-1] + (1,), np.float32)
    before = td.decode_attention.launches
    got, want = _dense_both(q, kq, ks, vq, vs, pos)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert td.decode_attention.launches == before      # CPU: no kernel


def test_dense_decode_attention_mask_excludes_future():
    q, k, v = _dense_case(1, 12, 2, 2, 8)
    k[:, :, 5:] = 100.0
    v[:, :, 5:] = 100.0
    ones = np.ones(k.shape[:-1] + (1,), np.float32)
    got, want = _dense_both(q, k, ones, v, ones, 4)
    assert np.abs(got).max() < 50.0
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dense_decode_attention_refuses_what_jax_refuses():
    q, k, v = _dense_case(1, 8, 6, 4, 8)          # 6 heads over 4 kv heads
    ones = torch.ones(1, 4, 8, 1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError):
        td.decode_attention(t[0], t[1], ones, t[2], ones, 3)
    with pytest.raises(ValueError):
        jda(*(jnp.asarray(a) for a in (q, k, ones.numpy(), v,
                                       ones.numpy())), 3, interpret=True)
    q2 = torch.zeros(1, 2, 4, 8)                    # q_len 2
    kv = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError):
        td.decode_attention(q2, kv, ones, kv, ones, 3)
    with pytest.raises(ValueError):                 # scales of another shape
        td.decode_attention(q2[:, :1], kv, ones[:, :, :4], kv, ones, 3)


def _meta_pool(N, BS, Hkv, D, dtype, offset=0):
    """The engine's [N, BS, Hkv, D] pool as the kernel layout's view
    (permuted, no copy), on the meta device: shapes, strides and offsets
    without memory."""
    flat = torch.empty(N * BS * Hkv * D + offset, dtype=dtype, device="meta")
    return flat[offset:].view(N, BS, Hkv, D).permute(0, 2, 1, 3)


@pytest.mark.parametrize("case,D,dtype,route", [
    ("llama2_7b bf16", 128, torch.bfloat16, "ring"),
    ("llama2_7b int8", 128, torch.int8, "ring"),
    ("gpt_base bf16", 64, torch.bfloat16, "ring"),
    ("int8 D = 64", 64, torch.int8, "ring"),
    ("f32 D = 64", 64, torch.float32, "ring"),
    ("f32 D = 128", 128, torch.float32, "ring"),
    ("bf16 D = 256", 256, torch.bfloat16, "ring"),
    ("bf16 D = 80: 160-byte rows", 80, torch.bfloat16, "scalar"),
    ("bf16 D = 16: 32-byte rows", 16, torch.bfloat16, "scalar"),
    ("f32 D = 256: 1 KB rows", 256, torch.float32, "scalar"),
    ("int8 D = 32: 32-byte rows", 32, torch.int8, "scalar"),
    ("int8 D = 512: 64 lanes of 8 bytes", 512, torch.int8, "scalar"),
    ("int8 D = 256", 256, torch.int8, "ring"),
])
def test_paged_route_predicate_on_row_widths(case, D, dtype, route):
    """The ring body takes rows of 64, 128, 256 or 512 bytes that 4 to 32
    lanes read (16 bytes a lane; 8 of an int8 row, so int8 rows stop at
    256 bytes); the first body the rest."""
    pool = _meta_pool(9, 16, 4, D, dtype)
    want = {"ring": td.PAGED_RING, "scalar": td.PAGED_SCALAR}[route]
    assert td.paged_route(pool, pool) == want, case


def test_paged_route_predicate_needs_16_byte_rows():
    """A base or a stride off 16 bytes keeps the first body; a contiguous
    [B, Hkv, T, D] cache (the dense decode) takes the ring body."""
    assert td.paged_route(_meta_pool(9, 16, 4, 128, torch.bfloat16, 4),
                          _meta_pool(9, 16, 4, 128, torch.bfloat16)) \
        == td.PAGED_SCALAR
    odd = torch.empty(9, 16, 4, 136, dtype=torch.bfloat16,
                      device="meta")[..., :128].permute(0, 2, 1, 3)
    assert odd.stride(-1) == 1
    assert td.paged_route(odd, odd) == td.PAGED_RING      # 272-byte rows
    odd = torch.empty(9, 16, 4, 132, dtype=torch.bfloat16,
                      device="meta")[..., :128].permute(0, 2, 1, 3)
    assert td.paged_route(odd, odd) == td.PAGED_SCALAR    # 264-byte rows
    dense = torch.empty(8, 32, 4096, 128, dtype=torch.int8, device="meta")
    assert td.paged_route(dense, dense) == td.PAGED_RING


def test_route_counts_name_every_body_and_a_cpu_call_counts_none():
    """Both wrappers count launches by body where the kernel is launched;
    their plain versions on the CPU launch none."""
    for w in (td.paged_decode_attention, td.decode_attention):
        assert set(w.routes) == {td.PAGED_SCALAR, td.PAGED_RING}
    c = CASES["mha_ragged"]
    q, kq, vq, tables, pos = _case(**c)
    before = (dict(td.paged_decode_attention.routes),
              dict(td.decode_attention.routes))
    _port(q, kq, None, vq, None, tables, pos)
    dq, dk, dv = _dense_case(1, 16, 2, 2, 8)
    ones = torch.ones(1, 2, 16, 1)
    td.decode_attention(*(torch.from_numpy(a) for a in (dq, dk)), ones,
                        torch.from_numpy(dv), ones, 5)
    assert (td.paged_decode_attention.routes,
            td.decode_attention.routes) == before


@pytest.mark.parametrize("form", ["int", "numpy int32", "0-d tensor"])
def test_dense_decode_attention_takes_pos_as_a_scalar(form):
    """The dense wrapper reads pos as one scalar for every sequence (an
    int, a numpy integer or a 0-d tensor: on the card it is passed as a
    launch argument, with no [B] tensor made); each form gives what the
    JAX kernel gives at that position."""
    B, T, H, Hkv, D, pos, _ = DENSE_CASES["float_gqa_last_row"]
    q, k, v = _dense_case(B, T, H, Hkv, D, seed=4)
    ones = np.ones(k.shape[:-1] + (1,), np.float32)
    p = {"int": 11, "numpy int32": np.int32(11),
         "0-d tensor": torch.tensor(11)}[form]
    want = np.asarray(jda(*(jnp.asarray(a) for a in (q, k, ones, v, ones)),
                          11, interpret=True))
    got = td.decode_attention(*(torch.from_numpy(a)
                                for a in (q, k, ones, v, ones)), p)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
