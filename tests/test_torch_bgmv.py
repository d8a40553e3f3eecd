"""Port parity of the BGMV LoRA product (`paddle_tpu_torch.ops.bgmv`)
against the JAX `lora_delta` on the same numpy inputs: the scalar-slot
path (gather + two matmuls) and the batched path's plain version (what a
CPU tensor takes; the CUDA kernel is held against it on the card in
`tests/test_torch_cuda.py`), in f32 and bf16, against the JAX fallback
(`use_kernel=False`) and the Pallas kernel in interpret mode.
Tolerance: 1e-5 relative, normwise (f32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.bgmv import lora_delta as jlora_delta

from paddle_tpu_torch.ops import bgmv

SLOTS, RANK = 5, 4


def _case(seed, b=3, s=2, d_in=24, d_out=20, r=RANK):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, d_in).astype(np.float32)
    A = rng.randn(SLOTS, d_in, r).astype(np.float32)
    B = rng.randn(SLOTS, r, d_out).astype(np.float32)
    A[0] = 0.0
    B[0] = 0.0
    return x, A, B


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - ref) \
        / max(np.linalg.norm(ref), 1e-30)


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax_x(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids", [[0, 2, 3], [4, 4, 1], [0, 0, 0]])
def test_batched_ids_match_jax_fallback(dtype, ids):
    x, A, B = _case(sum(ids) + 1)
    ids = np.asarray(ids, np.int32)
    ref = np.asarray(jlora_delta(_jax_x(x, dtype), A, B, ids,
                                 use_kernel=False))
    got = bgmv.lora_delta(_torch_x(x, dtype), torch.from_numpy(A),
                          torch.from_numpy(B), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-5
    # slot-0 rows are exact zeros (the no-adapter lane)
    for i, slot in enumerate(ids):
        if slot == 0:
            assert not got[i].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slot", [0, 3])
def test_scalar_slot_matches_jax(dtype, slot):
    """A scalar id (a prefill chunk): the plain gather and two matmuls,
    against JAX's scalar path, and the same as the batched row."""
    x, A, B = _case(10 + slot, b=1, s=5)
    ref = np.asarray(jlora_delta(_jax_x(x, dtype), A, B, np.int32(slot)))
    got = bgmv.lora_delta(_torch_x(x, dtype), torch.from_numpy(A),
                          torch.from_numpy(B),
                          torch.tensor(slot, dtype=torch.int32))
    assert _rel(got.numpy(), ref) <= 1e-5
    row = bgmv.lora_delta(_torch_x(x, dtype), torch.from_numpy(A),
                          torch.from_numpy(B),
                          torch.tensor([slot], dtype=torch.int32))
    assert _rel(got.numpy(), row.numpy()) <= 1e-5


def test_plain_version_matches_pallas_kernel_interpret():
    """The JAX Pallas kernel in interpret mode on the same inputs."""
    x, A, B = _case(7, b=3, s=2, d_in=16, d_out=8)
    ids = np.asarray([0, 2, 3], np.int32)
    ker = np.asarray(jlora_delta(x, A, B, ids, use_kernel=True,
                                 interpret=True))
    got = bgmv.lora_delta(torch.from_numpy(x), torch.from_numpy(A),
                          torch.from_numpy(B), torch.from_numpy(ids))
    assert _rel(got.numpy(), ker) <= 1e-5


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    x, A, B = _case(3)
    before = bgmv.lora_delta.launches
    ids = torch.tensor([1, 2, 0], dtype=torch.int32)
    got = bgmv.lora_delta(torch.from_numpy(x), torch.from_numpy(A),
                          torch.from_numpy(B), ids)
    ref = bgmv.lora_delta_ref(torch.from_numpy(x), torch.from_numpy(A),
                              torch.from_numpy(B), ids)
    assert torch.equal(got, ref)
    assert bgmv.lora_delta.launches == before


@pytest.mark.parametrize("ids", [np.zeros((3, 1), np.int32),
                                 np.zeros(2, np.int32)])
def test_other_id_shapes_raise(ids):
    x, A, B = _case(4)
    with pytest.raises(ValueError, match="ids must be scalar or"):
        bgmv.lora_delta(torch.from_numpy(x), torch.from_numpy(A),
                        torch.from_numpy(B), torch.from_numpy(ids))
