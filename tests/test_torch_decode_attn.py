"""Port parity: paged single-query decode attention
(`paddle_tpu_torch.ops.decode_attn`) against the JAX package's
`paged_decode_attention` — its Pallas kernel in interpret mode and its XLA
gather path — on the cases of tests/test_decode_attn.py: MHA and GQA,
float and int8 pools, positions mid-block and in the first block, table
tails at block 0, garbage in every block. The port runs on the CPU (the
plain version); the CUDA kernel is compared with it in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
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
