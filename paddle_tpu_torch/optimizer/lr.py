"""Learning-rate schedulers (counterpart of paddle_tpu/optimizer/lr.py):
the `LRScheduler` base and its 17 schedules, pure Python on floats.

They follow Paddle's eager convention: an optimizer built with a scheduler
as its ``learning_rate`` reads ``scheduler()`` when it steps, and the user
calls ``scheduler.step()`` (once per batch or epoch). The reference's
quirks are kept, since the tests hold the values equal:

* every constructor calls `step()` once, so `last_epoch` starts at 0;
* `LinearWarmup.get_lr` steps its inner scheduler inside `get_lr` once
  the warm-up has ended;
* `ReduceOnPlateau.step(metrics)` ignores a None metric. It takes a
  Python number or a 0-d tensor; `.item()` on a tensor is its one host
  read.

One difference: `LinearWarmup.state_dict()` also holds its inner
scheduler's state (under ``"lr_sched"``), so a restored warm-up resumes
the inner schedule where it was. The reference keeps only plain values,
which drops the inner scheduler (ROADMAP Queue 3).
"""
from __future__ import annotations

import math
import numbers

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "MultiplicativeDecay", "ReduceOnPlateau", "CosineAnnealingDecay",
           "CosineAnnealingWarmRestarts", "OneCycleLR", "CyclicLR",
           "LinearLR"]

_PLAIN = (int, float, bool, str, list)


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        """The scheduler's plain attributes (numbers, strings, lists),
        copied."""
        return {k: list(v) if isinstance(v, list) else v
                for k, v in self.__dict__.items() if isinstance(v, _PLAIN)}

    def set_state_dict(self, state):
        self.__dict__.update({k: list(v) if isinstance(v, list) else v
                              for k, v in state.items()})

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * (self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        if self.cycle:
            div = math.ceil(t / float(self.decay_steps)) if t > 0 else 1
            steps = self.decay_steps * div
        else:
            steps = self.decay_steps
            t = min(t, steps)
        return ((self.base_lr - self.end_lr) * ((1 - t / steps) ** self.power)
                + self.end_lr)


class LinearWarmup(LRScheduler):
    """A linear ramp from `start_lr` to `end_lr` over `warmup_steps`, then
    `learning_rate`: a number, or a scheduler stepped once per step from
    then on."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        inner = isinstance(learning_rate, LRScheduler)
        self.lr_sched = learning_rate if inner else None
        self.final_lr = None if inner else learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * self.last_epoch
                    / self.warmup_steps + self.start_lr)
        if self.lr_sched is not None:
            self.lr_sched.step()
            return self.lr_sched()
        return self.final_lr

    def state_dict(self):
        state = super().state_dict()
        if self.lr_sched is not None:
            state["lr_sched"] = self.lr_sched.state_dict()
        return state

    def set_state_dict(self, state):
        state = dict(state)
        inner = state.pop("lr_sched", None)
        super().set_state_dict(state)
        if inner is not None and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)

    set_dict = set_state_dict
    state_keys = state_dict


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma
                               ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    """lr_t = lr_{t-1} * lr_lambda(t): the product of the factors of
    epochs 1..t."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for e in range(1, self.last_epoch + 1):
            lr *= self.lr_lambda(e)
        return lr


class ReduceOnPlateau(LRScheduler):
    """Scale the rate by `factor` once the metric has not improved for
    more than `patience` steps; `step(metrics)` is driven by the user."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        cur = (float(metrics) if isinstance(metrics, numbers.Real)
               else float(metrics.item()))
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.best is None:
            better = True
        elif self.mode == "min":
            thr = (self.best * (1 - self.threshold)
                   if self.threshold_mode == "rel"
                   else self.best - self.threshold)
            better = cur < thr
        else:
            thr = (self.best * (1 + self.threshold)
                   if self.threshold_mode == "rel"
                   else self.best + self.threshold)
            better = cur > thr
        if better:
            self.best = cur
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_i = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        self.T_cur = last_epoch
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * max(self.T_cur, 0) / self.T_i)) / 2

    def step(self, epoch=None):
        self.last_epoch += 1
        self.T_cur += 1
        if self.T_cur >= self.T_i:
            self.T_cur = 0
            self.T_i *= self.T_mult
        self.last_lr = self.get_lr()


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        if three_phase:
            raise NotImplementedError(
                "OneCycleLR(three_phase=True): the reference accepts it and "
                "runs the two-phase schedule")
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        up = self.phase_pct * self.total_steps
        t = self.last_epoch
        if t <= up:
            return self._anneal(self.initial_lr, self.max_lr, t / max(up, 1))
        return self._anneal(self.max_lr, self.end_lr,
                            (t - up) / max(self.total_steps - up, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        if scale_fn is not None:
            raise NotImplementedError(
                "CyclicLR(scale_fn=...): the reference accepts it and "
                "ignores it")
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x <= self.step_up:
            pct = x / self.step_up
        else:
            pct = 1 - (x - self.step_up) / self.step_down
        amp = (self.max_lr - self.base_lr) * pct
        if self.mode == "triangular2":
            amp = amp / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        f = (self.start_factor
             + (self.end_factor - self.start_factor) * t / self.total_steps)
        return self.base_lr * f
