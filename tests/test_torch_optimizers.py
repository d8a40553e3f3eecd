"""Port parity of the optimizers and clips: `paddle_tpu_torch.optimizer`
and `paddle_tpu_torch.nn.clip` against the JAX package's.

* The eleven per-parameter optimizers: three `step()`s of the port on
  given gradients (one step's tiny, one's large) against the JAX class's
  `_update_one` on the same numbers. f32: parameters and slots to 1e-6
  (relative and absolute, a few ulps of sums taken in another order).
  bf16 parameters (AMP O2): the slots are bf16 as the reference makes
  them, and parameters and slots agree within 8 bf16 ulps (2**-8 each)
  of the largest magnitude. The reference rounds to bf16 after each
  operation of an update (up to eight in Adadelta's chain of two square
  roots and a quotient), the port once from f32; the largest gap read is
  5.7 ulps (Adadelta's second moment), the others at most 3.
* LBFGS on a least-squares problem, with and without `strong_wolfe`:
  the iterates to 1e-5.
* The clips and clip functions, `need_clip = False` included: 1e-6.
* The arguments the reference ignores and the port gives Paddle's
  meaning are checked against hand-computed numpy updates (1e-6); those
  the port refuses raise NotImplementedError.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
import paddle_tpu.optimizer as jopt

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip

LR = 0.05
# name: (port class, JAX class, keyword arguments of both)
CASES = {
    "SGD": (topt.SGD, jopt.SGD, dict(weight_decay=0.1)),
    "Momentum": (topt.Momentum, jopt.Momentum,
                 dict(momentum=0.9, weight_decay=0.1)),
    "Momentum-nesterov": (topt.Momentum, jopt.Momentum,
                          dict(momentum=0.8, use_nesterov=True)),
    "Adam": (topt.Adam, jopt.Adam, dict(weight_decay=0.05)),
    "AdamW": (topt.AdamW, jopt.AdamW, dict(weight_decay=0.3)),
    "Adagrad": (topt.Adagrad, jopt.Adagrad, dict(weight_decay=0.1)),
    "RMSProp": (topt.RMSProp, jopt.RMSProp, dict(momentum=0.5)),
    "RMSProp-centered": (topt.RMSProp, jopt.RMSProp,
                         dict(centered=True, rho=0.9)),
    "Adadelta": (topt.Adadelta, jopt.Adadelta, dict(weight_decay=0.1)),
    "Adamax": (topt.Adamax, jopt.Adamax, dict(weight_decay=0.1)),
    "Lamb": (topt.Lamb, jopt.Lamb, dict(lamb_weight_decay=0.05)),
    "Rprop": (topt.Rprop, jopt.Rprop, {}),
    "ASGD": (topt.ASGD, jopt.ASGD, dict(weight_decay=0.1)),
}
BF16_ULPS = 8 * 2.0 ** -8


def _jax_params():
    return paddle.nn.Linear(2, 2).parameters()


def _to_jnp(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _close(got, ref, dtype, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
    else:
        tol = BF16_ULPS * max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= tol, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_jax_update_one(name, dtype):
    tcls, jcls, kw = CASES[name]
    rng = np.random.RandomState(3)
    p0 = rng.randn(2, 32).astype(np.float32)
    grads = [rng.randn(2, 32).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tp = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    t = tcls(learning_rate=LR, parameters=[tp], **kw)
    j = jcls(learning_rate=LR, parameters=_jax_params(), **kw)
    jp = _to_jnp(p0, dtype)
    state = {s: jnp.zeros_like(jp) for s in j._state_names}
    if name == "Rprop":          # the eager `_ensure_state`
        state["step_size"] = jnp.full_like(jp, LR)
    for step, g in enumerate(grads, start=1):
        jp, state = j._update_one(jp, _to_jnp(g, dtype), state,
                                  jnp.asarray(LR, jnp.float32),
                                  jnp.asarray(step, jnp.int32))
        tp.grad = torch.from_numpy(g).to(tdt)
        t.step()
        _close(tp.detach().float().numpy(), jp, dtype, f"{name} step {step}")
        sd = t.state_dict()
        assert sd["_step_count"] == step
        for s, v in state.items():
            assert sd[f"{s}_0"].dtype == tdt, s
            _close(sd[f"{s}_0"].float().numpy(), v, dtype,
                   f"{name} slot {s} step {step}")


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """Five LBFGS steps on 0.5 |A x - b|^2 (A 12 x 6): the iterates to
    1e-5."""
    rng = np.random.RandomState(5)
    A = rng.randn(12, 6).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    kw = dict(learning_rate=1.0, max_iter=4, history_size=5,
              line_search_fn=line_search)

    jx = paddle.to_tensor(np.zeros(6, np.float32))
    jx.stop_gradient = False
    jo = jopt.LBFGS(parameters=[jx], **kw)

    def jclosure():
        jo.clear_grad()
        r = paddle.to_tensor(A) @ jx - paddle.to_tensor(b)
        loss = 0.5 * (r * r).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.zeros(6))
    to = topt.LBFGS(parameters=[tx], **kw)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def tclosure():
        to.clear_grad()
        r = At @ tx - bt
        loss = 0.5 * (r * r).sum()
        loss.backward()
        return loss

    with jax.default_matmul_precision("highest"):
        for step in range(5):
            jl = jo.step(jclosure)
            tl = to.step(tclosure)
            np.testing.assert_allclose(tx.detach().numpy(), jx.numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step}")
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert to.state_dict()["_step_count"] == 5
    x_star = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(tx.detach().numpy(), x_star, atol=1e-3)


def test_lbfgs_is_refused_by_the_engine():
    from paddle_tpu_torch.distributed import parallelize

    m = torch.nn.Linear(2, 2)
    with pytest.raises(TypeError, match="LBFGS"):
        parallelize(m, topt.LBFGS(parameters=m.parameters()),
                    loss_fn=lambda mm, x: mm(x).sum())


def _grads(seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * k
            for s, k in (((4, 8), 2.0), ((8,), 0.5), ((3, 3), 4.0))]


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_clips_match_jax(kind):
    """The eager clips with the middle parameter's `need_clip = False`,
    and the port's pre-clip global norm over all the gradients."""
    make = {"global": (lambda m: m.ClipGradByGlobalNorm(1.5)),
            "norm": (lambda m: m.ClipGradByNorm(1.5)),
            "value": (lambda m: m.ClipGradByValue(0.7, min=-0.4))}[kind]
    gs = _grads()
    need = [True, False, True]
    jparams = [types.SimpleNamespace(need_clip=n) for n in need]
    jout = make(jclip)(list(zip(jparams, [paddle.to_tensor(g)
                                          for g in gs])))
    tgrads = [torch.from_numpy(g.copy()) for g in gs]
    tparams = []
    for n in need:
        p = torch.nn.Parameter(torch.zeros(1))
        p.need_clip = n
        tparams.append(p)
    norm = make(tclip)(tgrads, tparams)
    for (_, jg), tg in zip(jout, tgrads):
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in gs)), rtol=1e-6)
    # without params every gradient is clipped
    tgrads = [torch.from_numpy(g.copy()) for g in gs]
    make(tclip)(tgrads)
    jout = make(jclip)([(types.SimpleNamespace(), paddle.to_tensor(g))
                        for g in gs])
    for (_, jg), tg in zip(jout, tgrads):
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_functions_match_jax(norm_type):
    gs = _grads(11)
    jps = [types.SimpleNamespace(grad=paddle.to_tensor(g)) for g in gs]
    jtotal = jclip.clip_grad_norm_(jps, 3.0, norm_type=norm_type)
    tps = []
    for g in gs:
        p = torch.nn.Parameter(torch.zeros(g.shape))
        p.grad = torch.from_numpy(g.copy())
        tps.append(p)
    ttotal = tclip.clip_grad_norm_(tps, 3.0, norm_type=norm_type)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
    jclip.clip_grad_value_(jps, 0.3)
    tclip.clip_grad_value_(tps, 0.3)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="error_if_nonfinite"):
        tclip.clip_grad_norm_(tps, 1.0, error_if_nonfinite=True)


def _adam_moments(g, m, v, t, b1=0.9, b2=0.999, eps=1e-8):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return m, v, (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)


def test_adamw_decay_fun_and_lr_ratio_have_paddle_meaning():
    """`apply_decay_param_fun` by name (no decay on "b") and
    `lr_ratio` (half the rate for "b", decay included), against numpy."""
    rng = np.random.RandomState(2)
    w0, b0 = rng.randn(3, 4).astype(np.float32), rng.randn(4).astype(
        np.float32)
    tw, tb = (torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in (w0, b0))
    lr, wd = 0.1, 0.2
    opt = topt.AdamW(learning_rate=lr, weight_decay=wd,
                     parameters=[("w", tw), ("b", tb)],
                     apply_decay_param_fun=lambda n: n != "b",
                     lr_ratio=lambda p: 0.5 if p is tb else 1.0)
    ref = {"w": [w0.astype(np.float64), 0.0, 0.0, lr, wd],
           "b": [b0.astype(np.float64), 0.0, 0.0, lr * 0.5, 0.0]}
    for t in (1, 2):
        gw, gb = rng.randn(3, 4), rng.randn(4)
        tw.grad = torch.from_numpy(gw.astype(np.float32))
        tb.grad = torch.from_numpy(gb.astype(np.float32))
        opt.step()
        for key, g in (("w", gw.astype(np.float32)),
                       ("b", gb.astype(np.float32))):
            p, m, v, a, d = ref[key]
            m, v, u = _adam_moments(g, m, v, t)
            ref[key] = [p * (1 - a * d) - a * u, m, v, a, d]
    np.testing.assert_allclose(tw.detach().numpy(), ref["w"][0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.detach().numpy(), ref["b"][0], rtol=1e-6,
                               atol=1e-6)


def test_adagrad_initial_accumulator_value():
    rng = np.random.RandomState(4)
    p0 = rng.randn(16).astype(np.float32)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = topt.Adagrad(0.1, parameters=[tp], initial_accumulator_value=0.5)
    p, mom = p0.astype(np.float64), np.full(16, 0.5)
    for _ in range(2):
        g = rng.randn(16).astype(np.float32)
        tp.grad = torch.from_numpy(g)
        opt.step()
        mom = mom + g * g
        p = p - 0.1 * g / (np.sqrt(mom) + 1e-6)
    np.testing.assert_allclose(tp.detach().numpy(), p, rtol=1e-6, atol=1e-6)


def test_lamb_exclude_from_weight_decay_fn():
    rng = np.random.RandomState(6)
    w0, b0 = (rng.randn(*s).astype(np.float32) for s in ((4, 4), (4,)))
    tw, tb = (torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in (w0, b0))
    lr, wd = 0.01, 0.1
    opt = topt.Lamb(lr, lamb_weight_decay=wd, parameters=[tw, tb],
                    exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    ref = {0: [w0.astype(np.float64), 0.0, 0.0, wd],
           1: [b0.astype(np.float64), 0.0, 0.0, 0.0]}
    for t in (1, 2):
        gs = [rng.randn(4, 4).astype(np.float32),
              rng.randn(4).astype(np.float32)]
        tw.grad, tb.grad = (torch.from_numpy(g) for g in gs)
        opt.step()
        for k, g in enumerate(gs):
            p, m, v, d = ref[k]
            m, v, u = _adam_moments(g, m, v, t, eps=1e-6)
            r = u + d * p
            trust = np.linalg.norm(p) / np.linalg.norm(r)
            ref[k] = [p - lr * trust * r, m, v, d]
    for tp, k in ((tw, 0), (tb, 1)):
        np.testing.assert_allclose(tp.detach().numpy(), ref[k][0],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda ps: topt.Adam(parameters=ps, lazy_mode=True),
    lambda ps: topt.Adam(parameters=ps, amsgrad=True),
    lambda ps: topt.AdamW(parameters=ps, multi_precision=True),
    lambda ps: topt.AdamW(parameters=ps, amsgrad=True),
    lambda ps: topt.LBFGS(parameters=ps, weight_decay=0.1),
    lambda ps: topt.LBFGS(parameters=ps,
                          grad_clip=tclip.ClipGradByNorm(1.0)),
    lambda ps: tclip.ClipGradByGlobalNorm(1.0, auto_skip_clip=True),
])
def test_arguments_the_reference_ignores_are_refused(make):
    with pytest.raises(NotImplementedError, match="ignores"):
        make([torch.nn.Parameter(torch.zeros(2))])


def test_optimizer_surface():
    """get_lr / set_lr / set_lr_scheduler, minimize, clear_grad, and the
    state dict round trip into a fresh optimizer (load_state_dict is
    set_state_dict)."""
    from paddle_tpu_torch.optimizer import lr as tlr

    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.Momentum(0.1, parameters=[p])
    assert opt.get_lr() == 0.1
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    sched = tlr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt.set_lr_scheduler(sched)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    opt.minimize((p * p).sum())
    np.testing.assert_allclose(p.detach().numpy(), 1 - 0.5 * 2.0)
    opt.clear_grad()
    assert p.grad is None
    sched.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = topt.Momentum(0.1, parameters=[q])
    opt2.set_lr_scheduler(tlr.StepDecay(0.5, step_size=1, gamma=0.5))
    opt2.load_state_dict(opt.state_dict())
    assert opt2._learning_rate() == sched() == 0.25
    for o, t in ((opt, p), (opt2, q)):
        o.minimize((t * t).sum())
    torch.testing.assert_close(q, p, rtol=0, atol=0)
    assert opt2.state_dict()["_step_count"] == 2
    with pytest.raises(TypeError, match="learning_rate"):
        topt.SGD(learning_rate=lambda s: 0.1, parameters=[p])
