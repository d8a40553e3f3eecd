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

The training recipes are held to the same f32 tolerances: gpt_tiny under
schedules and clips through both engines, state carried from the JAX
engine (`convert`), and the port engine's rewinds (bit for bit).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as dist
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state, state_to_jax
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.models import bert_for_sequence_classification, gpt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

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
    with pytest.raises(RuntimeError, match="without an optimizer"):
        parallelize(tm).train_batch(torch.zeros(1, 8, dtype=torch.long))
    assert parallelize(tm, opt, mesh=["cpu"]).device == torch.device("cpu")


# ---------------------------------------------------------------------------
# training recipes: schedules, clips, carried and rewound state
# ---------------------------------------------------------------------------

RECIPE_STEPS = 6


def _recipe(name, lr_mod, opt_mod, clip_mod, params):
    """(optimizer, scheduler) of a named recipe, built from one package's
    modules (the JAX package's or the port's)."""
    if name == "stepdecay-sgd":
        sched = lr_mod.StepDecay(0.05, step_size=2, gamma=0.5)
        return opt_mod.SGD(learning_rate=sched, parameters=params), sched
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(1e-3, T_max=8),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    return (opt_mod.AdamW(learning_rate=sched, parameters=params,
                          grad_clip=clip_mod.ClipGradByNorm(1.0)), sched)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A private compile cache for this module's JAX engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_COMPILE_CACHE",
                  str(tmp_path_factory.mktemp("jax_cache")))
        yield


@pytest.mark.parametrize("recipe", ["stepdecay-sgd",
                                    "warmup-cosine-adamw-clipnorm"])
def test_scheduled_training_matches_jax_engine(recipe, jax_cache):
    """gpt_tiny under a schedule through the JAX engine's `train_batches`
    (which steps the scheduler once a micro-step) and through the port's,
    both `train_batches` and `train_batch` with the scheduler stepped by
    hand: the port's two runs bit-equal, and each against JAX within the
    f32 tolerances of `_torch_run` (loss 1e-4, grad norm 1e-3, each
    leaf's move 1e-3 normwise)."""
    import paddle_tpu.nn as jnn

    paddle.seed(0)
    jm = jgpt("gpt_tiny")
    init = _named(jm)
    jo, jsched = _recipe(recipe, jlr, paddle.optimizer, jnn, jm.parameters())
    ids = _ids()
    with jax.default_matmul_precision("highest"):
        jeng = dist.parallelize(
            jm, jo, mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]))
        jl = np.asarray(jeng.train_batches(
            [(paddle.to_tensor(ids),)] * RECIPE_STEPS).numpy())
        jn = np.asarray(jeng.last_grad_norms)
    jparams = _named(jm)
    runs = []
    for fused in (True, False):
        tm = gpt("gpt_tiny", device="cpu")
        load_jax_state(tm, init)
        opt, sched = _recipe(recipe, tlr, topt, tnn,
                             tm.parameters())
        eng = parallelize(tm, opt)
        tids = torch.from_numpy(ids).long()
        if fused:
            losses = eng.train_batches([(tids,)] * RECIPE_STEPS)
            norms = eng.last_grad_norms
        else:
            losses, norms = [], []
            for _ in range(RECIPE_STEPS):
                losses.append(eng.train_batch(tids))
                norms.append(eng.last_grad_norm)
                sched.step()
            losses, norms = torch.stack(losses), torch.stack(norms)
        runs.append((losses, norms, state_to_jax(tm), sched.last_epoch))
    (fl, fn, fp, fe), (hl, hn, hp, he) = runs
    torch.testing.assert_close(fl, hl, rtol=0, atol=0)
    torch.testing.assert_close(fn, hn, rtol=0, atol=0)
    assert all(np.array_equal(fp[n], hp[n]) for n in fp)
    assert fe == he == jsched.last_epoch == RECIPE_STEPS
    np.testing.assert_allclose(fl.numpy(), jl, rtol=1e-4, err_msg="loss")
    np.testing.assert_allclose(fn.numpy(), jn, rtol=1e-3, err_msg="norm")
    assert fl[-1] < fl[0]
    moved = {n: _normwise(fp[n] - init[n], ref - init[n])
             for n, ref in jparams.items()}
    assert max(moved.values()) <= DELTA_TOL[None], moved


def _jax_adamw_engine(steps, sched):
    paddle.seed(0)
    jm = jgpt("gpt_tiny")
    init = _named(jm)
    jo = paddle.optimizer.AdamW(learning_rate=sched,
                                parameters=jm.parameters(),
                                grad_clip=JClip(1.0))
    jeng = dist.parallelize(
        jm, jo, mesh=dist.build_mesh(dp=1, devices=jax.devices()[:1]))
    ids = paddle.to_tensor(_ids())
    for _ in range(steps):
        jeng.train_batch(ids)
        sched.step()
    return jm, jo, jeng, init


def test_state_carried_from_the_jax_engine(jax_cache):
    """Three JAX steps under a cosine schedule, then the state carried into
    the port twice — the optimizer's `state_dict` (after
    `sync_optimizer_state`, scheduler included) and the engine's tree —
    and two more steps on each side: the port's two carried runs
    bit-equal, and against JAX within `_torch_run`'s f32 tolerances. The
    engine trees' keys are the JAX engine's."""
    with jax.default_matmul_precision("highest"):
        jm, jo, jeng, _ = _jax_adamw_engine(
            3, jlr.CosineAnnealingDecay(1e-3, T_max=10))
        jeng.sync_optimizer_state()
        # to numpy now: the next steps donate the engine's buffers
        leaf = lambda t: np.asarray(t.numpy())  # noqa: E731
        opt_state = {k: v if k in ("_step_count", "LR_Scheduler")
                     else leaf(v) for k, v in jo.state_dict().items()}
        tree = jeng.state_dict()
        tree = {"model": {n: leaf(v) for n, v in tree["model"].items()},
                "buffers": {n: leaf(v) for n, v in tree["buffers"].items()},
                "opt": {n: {k: leaf(v) for k, v in slots.items()}
                        for n, slots in tree["opt"].items()},
                "step": tree["step"]}
        carried = _named(jm)
        ids = paddle.to_tensor(_ids())
        jl, jn = [], []
        for _ in range(2):
            jl.append(float(jeng.train_batch(ids)))
            jn.append(float(jeng.last_grad_norm))
            jo._learning_rate.step()
    jparams = _named(jm)
    names = [n for n, _ in jm.named_parameters()]
    runs = []
    for via in ("optimizer", "engine"):
        tm = gpt("gpt_tiny", device="cpu")
        load_jax_state(tm, carried)
        sched = tlr.CosineAnnealingDecay(1e-3, T_max=10)
        opt = AdamW(learning_rate=sched, parameters=tm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        eng = parallelize(tm, opt)
        if via == "optimizer":
            opt.set_state_dict(convert.optimizer_state_from_jax(
                opt_state, names, tm))
            assert sched.last_epoch == 3
        else:
            eng.load_state_dict(convert.engine_state_from_jax(tree))
            for _ in range(3):
                sched.step()
        assert opt._step_count == 3
        tids = torch.from_numpy(_ids()).long()
        tl, tn = [], []
        for _ in range(2):
            tl.append(float(eng.train_batch(tids)))
            tn.append(float(eng.last_grad_norm))
            sched.step()
        runs.append((tl, tn, state_to_jax(tm), eng))
    assert runs[0][:2] == runs[1][:2]
    for tl, tn, tparams, eng in runs:
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg="loss")
        np.testing.assert_allclose(tn, jn, rtol=1e-3, err_msg="grad norm")
        moved = {n: _normwise(tparams[n] - carried[n], ref - carried[n])
                 for n, ref in jparams.items()}
        assert max(moved.values()) <= DELTA_TOL[None], moved
    ptree = runs[1][3].state_dict()      # the engine route: 3 + 2 steps
    assert set(ptree) == set(tree)
    assert set(ptree["model"]) == set(tree["model"])
    assert set(ptree["buffers"]) == set(tree["buffers"])
    assert {n: set(s) for n, s in ptree["opt"].items()} == {
        n: set(s) for n, s in tree["opt"].items()}
    assert ptree["step"] == 5


def _bert_engine(seed=0):
    gen = torch.Generator().manual_seed(11)
    m = bert_for_sequence_classification("bert_tiny", device="cpu",
                                         seed=seed, generator=gen)
    sched = tlr.LinearWarmup(tlr.PolynomialDecay(1e-3, decay_steps=6),
                             warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return m, sched, parallelize(m, opt)


def _bert_steps(eng, sched, batch, n):
    out = []
    for _ in range(n):
        out.append((float(eng.train_batch(*batch)),
                    float(eng.last_grad_norm)))
        sched.step()
    return out, {k: v.detach().clone()
                 for k, v in eng.model.state_dict().items()}


def test_snapshot_restore_replays_bert_tiny_with_dropout():
    """bert_tiny with hidden and attention dropout 0.1 from its generator,
    AdamW under a warm-up schedule: 3 steps, `snapshot()`, 3 steps; then
    `restore()` plus the scheduler's own `set_state_dict`, twice, each
    replaying the same 3 steps bit for bit (losses, grad norms,
    parameters)."""
    m, sched, eng = _bert_engine()
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randint(0, 1024, (4, 32))),
             torch.from_numpy(rng.randint(0, 2, (4,))))
    _bert_steps(eng, sched, batch, 3)
    snap, sched_state = eng.snapshot(), sched.state_dict()
    ref, ref_params = _bert_steps(eng, sched, batch, 3)
    for _ in range(2):
        eng.restore(snap)
        sched.set_state_dict(sched_state)
        got, params = _bert_steps(eng, sched, batch, 3)
        assert got == ref
        assert all(torch.equal(params[k], v) for k, v in ref_params.items())
    # without rewinding the generator the replay differs: dropout counts
    eng.restore(snap)
    sched.set_state_dict(sched_state)
    m.bert.embeddings.dropout.generator.manual_seed(12345)
    assert _bert_steps(eng, sched, batch, 3)[0] != ref


def test_state_dict_into_a_fresh_engine_continues_the_run():
    """gpt_tiny (no dropout): `state_dict()` of an engine 3 steps in,
    loaded into a freshly built engine, which then takes the first
    engine's next 3 steps bit for bit; a second restore of one snapshot
    equals the first."""
    init = _named(jgpt("gpt_tiny"))
    ids = torch.from_numpy(_ids()).long()
    engines = []
    for _ in range(2):
        tm = gpt("gpt_tiny", device="cpu")
        load_jax_state(tm, init)
        sched = tlr.CosineAnnealingDecay(1e-3, T_max=10)
        engines.append((parallelize(tm, AdamW(
            learning_rate=sched, parameters=tm.parameters(),
            grad_clip=ClipGradByNorm(1.0))), sched))
    (a, sa), (b, sb) = engines
    for _ in range(3):
        a.train_batch(ids)
        sa.step()
    b.load_state_dict(a.state_dict())
    sb.set_state_dict(sa.state_dict())
    runs = []
    for eng, sched in engines:
        runs.append([])
        for _ in range(3):
            runs[-1].append((float(eng.train_batch(ids)),
                             float(eng.last_grad_norm)))
            sched.step()
    assert runs[0] == runs[1]
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                b.model.parameters()))
    assert a.state_dict()["step"] == b.state_dict()["step"] == 6


def test_rprop_through_the_engine_matches_a_hand_computed_update():
    """Rprop under the port's engine keeps the eager semantics (the step
    size starts at the learning rate; the JAX engine zeros it, ROADMAP
    Queue 3): three steps of least squares against numpy."""
    rng = np.random.RandomState(9)
    x = rng.randn(16, 5).astype(np.float32)
    y = rng.randn(16, 3).astype(np.float32)
    lin = torch.nn.Linear(5, 3)
    w, b = (lin.weight.detach().numpy().astype(np.float64).copy(),
            lin.bias.detach().numpy().astype(np.float64).copy())
    lr = 0.01
    eng = parallelize(lin, topt.Rprop(learning_rate=lr,
                                      parameters=lin.parameters()),
                      loss_fn=lambda m, xx, yy: ((m(xx) - yy) ** 2).mean())
    state = {k: (np.zeros_like(v), np.full_like(v, lr))
             for k, v in (("w", w), ("b", b))}
    for _ in range(3):
        eng.train_batch(torch.from_numpy(x), torch.from_numpy(y))
        r = 2.0 * (x @ w.T + b - y) / y.size
        for k, g in (("w", r.T @ x), ("b", r.sum(0))):
            prev, size = state[k]
            sign = np.sign(g * prev)
            size = np.clip(np.where(sign > 0, size * 1.2,
                                    np.where(sign < 0, size * 0.5, size)),
                           1e-5, 50.0)
            g = np.where(sign < 0, 0.0, g)
            if k == "w":
                w = w - np.sign(g) * size
            else:
                b = b - np.sign(g) * size
            state[k] = (g, size)
    np.testing.assert_allclose(lin.weight.detach().numpy(), w, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lin.bias.detach().numpy(), b, rtol=1e-6,
                               atol=1e-6)
