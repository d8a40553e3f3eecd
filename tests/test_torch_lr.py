"""Port parity of the 17 LR schedulers: `paddle_tpu_torch.optimizer.lr`
against `paddle_tpu.optimizer.lr`, value for value (``==`` on the
floats) over 60 `step()` calls after construction. Halfway through, the
port's scheduler is carried through `state_dict()` into a freshly built
one, which must continue the uninterrupted JAX schedule exactly.
(`LinearWarmup` with an inner scheduler needs the port's nested state
for that: the reference's `state_dict` drops the inner scheduler.)"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60


def _warmup_cosine(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(0.1, T_max=30),
                          warmup_steps=10, start_lr=0.0, end_lr=0.1)


CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=8,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20, 41],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.3, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.3, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.2, decay_steps=25,
                                                   end_lr=0.01, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.2, decay_steps=13, end_lr=0.0, cycle=True),
    "LinearWarmup-number": lambda m: m.LinearWarmup(0.5, warmup_steps=7,
                                                    start_lr=0.01,
                                                    end_lr=0.4),
    "LinearWarmup-cosine": _warmup_cosine,
    "LinearWarmup-polynomial": lambda m: m.LinearWarmup(
        m.PolynomialDecay(2e-5, decay_steps=20, end_lr=0.0),
        warmup_steps=2, start_lr=0.0, end_lr=2e-5),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.4, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.3, [10, 25, 26],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.3, step_size=7, gamma=0.6),
    "LambdaDecay": lambda m: m.LambdaDecay(0.2, lambda e: 0.97 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.2, lambda e: 0.9 if e % 3 else 1.01),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=0.002),
    "ReduceOnPlateau-max-abs": lambda m: m.ReduceOnPlateau(
        0.1, mode="max", threshold=0.01, threshold_mode="abs", patience=1),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=17, eta_min=0.001),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=0.01),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=50),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        0.5, total_steps=40, phase_pct=0.25, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, step_size_down=7, mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "LinearLR": lambda m: m.LinearLR(0.3, total_steps=35),
}

# a metric that improves, stalls, improves, stalls (ReduceOnPlateau);
# None entries are skipped by the scheduler
_METRIC = [1.0, 0.8, 0.79995, 0.8, 0.81, None, 0.7, 0.7, 0.7, 0.69,
           0.69, 0.69, 0.69, 0.5, 0.5, 0.6]


def _metric(i):
    return _METRIC[i % len(_METRIC)]


def _step(sched, i, tensor=False):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        m = _metric(i)
        if tensor and m is not None:
            m = torch.tensor(m, dtype=torch.float64)
        sched.step(m)
    else:
        sched.step()


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_matches_jax(name):
    make = CASES[name]
    j, t = make(jlr), make(tlr)
    assert t() == j() and t.last_epoch == j.last_epoch
    for i in range(STEPS):
        if i == STEPS // 2:
            # mid-schedule round trip into a fresh scheduler
            fresh = make(tlr)
            fresh.set_state_dict(t.state_dict())
            t = fresh
        _step(j, i)
        _step(t, i, tensor=True)
        assert t() == j(), (name, i, t(), j())
        assert t.last_epoch == j.last_epoch
        assert isinstance(t(), float) and math.isfinite(t())


def test_warmup_restores_its_inner_scheduler():
    """The reference drops the inner scheduler from `state_dict`, so its
    restored warm-up resumes the inner schedule from wherever the inner
    object stands; the port's resumes it where it was saved."""
    t = _warmup_cosine(tlr)
    for _ in range(15):
        t.step()
    saved = t.state_dict()
    assert saved["lr_sched"]["last_epoch"] == 6   # stepped at epochs 10-15
    t.step()
    want = t()
    for _ in range(4):
        t.step()
    t.set_state_dict(saved)
    t.step()
    assert t() == want
    j = _warmup_cosine(jlr)
    assert "lr_sched" not in j.state_dict()


def test_schedule_drives_an_optimizer():
    """The optimizer reads the schedule at each step; the user steps it."""
    from paddle_tpu_torch.optimizer import SGD

    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.1)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = SGD(learning_rate=sched, parameters=[p])
    lrs = []
    for _ in range(5):
        p.grad = torch.ones(1)
        lrs.append(opt.get_lr())
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.5, 0.5, 0.05, 0.05, 0.005],
                               rtol=1e-12)
    np.testing.assert_allclose(p.detach().numpy(), [-sum(lrs)], rtol=1e-6)
    assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == 5
