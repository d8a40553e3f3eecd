"""Port parity of the training path: `gpt("gpt_tiny")` at S=128 with the
same weights trains 5 steps through `paddle_tpu_torch.distributed.
parallelize` (AdamW lr 1e-3, ClipGradByGlobalNorm(1.0)) and through the
JAX package's `dist.parallelize` on a one-device mesh, on the same batch.

Per-step loss and pre-clip grad norm are held to a relative bound, and
the final parameters (`convert.state_to_jax`) to 2 * lr * steps: AdamW
normalises each update to about lr, so a gradient entry near zero whose
sign differs between the two sides moves its parameter by up to lr the
other way on each step. The parameters' moves (final minus initial) are
held normwise, ||move_port - move_jax|| / ||move_jax||.

* float32: loss 1e-4, grad norm 1e-3 (f32 sums in another order), each
  leaf's move 1e-3 (largest reading 3.0e-4, a QKV bias);
* compute_dtype="bfloat16": loss 1e-2, grad norm 5e-2 (products and
  activations rounded to bf16 at different places), the whole model's
  move 1e-1 (reading 3.2e-2).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip

from paddle_tpu_torch.convert import load_jax_state, state_to_jax
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

LR, STEPS, B, S = 1e-3, 5, 4, 128
TOL = {None: (1e-4, 1e-3), "bfloat16": (1e-2, 5e-2)}
DELTA_TOL = {None: 1e-3, "bfloat16": 1e-1}


def _normwise(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _named(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _ids():
    return np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(autouse=True)
def _restore_global_mesh():
    """`dist.parallelize(mesh=...)` installs its mesh as the process-wide
    hybrid group; put the previous one back so later files of this
    worker see what they would have seen."""
    prev = dist.get_hybrid_communicate_group()
    yield
    dist.set_hybrid_communicate_group(prev)


def _jax_run(compute_dtype):
    paddle.seed(0)
    jm = jgpt("gpt_tiny")
    init = _named(jm)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters(),
                                 grad_clip=JClip(1.0))
    ids = paddle.to_tensor(_ids())
    with jax.default_matmul_precision("highest"):
        eng = dist.parallelize(
            jm, opt, mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]),
            compute_dtype=compute_dtype)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(eng.train_batch(ids)))
            norms.append(float(eng.last_grad_norm))
    return init, losses, norms, _named(jm)


def _torch_run(init, compute_dtype):
    tm = gpt("gpt_tiny", device="cpu")
    load_jax_state(tm, init)
    opt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    eng = parallelize(tm, opt, compute_dtype=compute_dtype)
    ids = torch.from_numpy(_ids()).long()
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(eng.train_batch(ids)))
        norms.append(float(eng.last_grad_norm))
    return losses, norms, state_to_jax(tm), eng


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_training_matches_jax_engine(compute_dtype):
    init, jl, jn, jparams = _jax_run(compute_dtype)
    tl, tn, tparams, eng = _torch_run(init, compute_dtype)
    loss_tol, norm_tol = TOL[compute_dtype]
    np.testing.assert_allclose(tl, jl, rtol=loss_tol, err_msg="loss")
    np.testing.assert_allclose(tn, jn, rtol=norm_tol, err_msg="grad norm")
    assert tl[-1] < tl[0]
    assert set(tparams) == set(jparams)
    for name, ref in jparams.items():
        np.testing.assert_allclose(tparams[name], ref, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)
    # what the 5 updates moved, normwise: per leaf in f32, where it sees
    # the decay term (1e-2 of a LayerNorm weight's move); over the whole
    # model in bf16, whose near-zero gradients (the key bias's is zero
    # analytically) make small leaves' moves noise on both sides
    moved = {n: _normwise(tparams[n] - init[n], ref - init[n])
             for n, ref in jparams.items()}
    if compute_dtype is None:
        assert max(moved.values()) <= DELTA_TOL[None], moved
    else:
        whole = _normwise(*(np.concatenate([(p[n] - init[n]).ravel()
                                            for n in sorted(jparams)])
                            for p in (tparams, jparams)))
        assert whole <= DELTA_TOL[compute_dtype], (whole, moved)
    assert eng.stats["steps"] == STEPS
    # the f32 masters stay f32 under a bf16 compute dtype
    assert all(p.dtype == torch.float32 for p in eng.model.parameters())


def test_adamw_update_matches_jax_with_decay():
    """Three AdamW steps with a large decay on given gradients (one step's
    gradients tiny, one's large) against the JAX package's
    `AdamW._update_one` on the same numbers, f32 to 1e-6 (a few ulps);
    a port without the decay term is off by lr * wd * |p| = 1.5e-2 |p|
    a step."""
    import jax.numpy as jnp

    lr, wd = 0.05, 0.3
    rng = np.random.RandomState(1)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=wd,
                                  parameters=paddle.nn.Linear(2, 2)
                                  .parameters())
    jp = jnp.asarray(p0)
    state = {"moment1": jnp.zeros(64), "moment2": jnp.zeros(64)}
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = AdamW(learning_rate=lr, weight_decay=wd, parameters=[tp])
    for t, g in enumerate(grads, start=1):
        jp, state = jopt._update_one(jp, jnp.asarray(g), state, lr,
                                     jnp.asarray(t, jnp.int32))
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6, err_msg=f"step {t}")
    assert topt.last_grad_norm is None


def test_train_batches_stacks_losses_and_norms():
    """train_batches is train_batch in a loop: the same trajectory."""
    init = _named(jgpt("gpt_tiny"))
    ids = torch.from_numpy(_ids()).long()
    runs = []
    for fused in (False, True):
        tm = gpt("gpt_tiny", device="cpu")
        load_jax_state(tm, init)
        eng = parallelize(tm, AdamW(learning_rate=LR,
                                    parameters=tm.parameters()))
        if fused:
            losses = eng.train_batches([(ids,)] * 3)
            norms = eng.last_grad_norms
        else:
            losses = torch.stack([eng.train_batch(ids) for _ in range(3)])
            norms = None
        runs.append((losses, norms, eng))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert runs[1][1].shape == (3,)
    assert runs[1][2].stats["steps"] == 3
    assert float(runs[1][2].eval_batch(ids)) < float(runs[1][0][0])


def test_engine_refuses_what_is_not_ported():
    tm = gpt("gpt_tiny", device="cpu")
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    later = "later slice, ROADMAP Queue 1, item 6: more than one device"
    with pytest.raises(NotImplementedError, match=later):
        parallelize(tm, opt, mesh=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match=later):
        parallelize(tm, opt, sharding_stage=2)
    recipes = "LR schedulers .*ROADMAP Queue 1, item 2: training recipes"
    with pytest.raises(NotImplementedError, match=recipes):
        AdamW(learning_rate=lambda step: 1e-3, parameters=tm.parameters())
    scheduled = AdamW(learning_rate=LR, parameters=tm.parameters())
    scheduled.param_groups[0]["lr"] = lambda step: 1e-3
    with pytest.raises(NotImplementedError, match=recipes):
        parallelize(tm, scheduled)
    with pytest.raises(RuntimeError, match="without an optimizer"):
        parallelize(tm).train_batch(torch.zeros(1, 8, dtype=torch.long))
    assert parallelize(tm, opt, mesh=["cpu"]).device == torch.device("cpu")
