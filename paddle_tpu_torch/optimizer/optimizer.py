"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py): the
Paddle optimizer surface on `torch.optim.Optimizer`, and SGD, Momentum,
Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax, Lamb, Rprop, ASGD and
LBFGS.

Each `step()` computes what the JAX class's `_update_one` computes, over
all parameters that have a gradient at once with multi-tensor
`torch._foreach_*` calls (Rprop and LBFGS excepted): the optional
`grad_clip` first (its pre-clip global norm kept in `last_grad_norm`,
else None), then the update at ``get_lr()`` — the number given, or
``float(scheduler())`` when `learning_rate` is an `lr.LRScheduler`, which
the user steps (Paddle's eager convention). The step counter
(`_step_count`, which feeds the bias corrections) is the optimizer's,
counted on every `step()` as in the reference. The arithmetic is f32 on
f32 working copies of non-f32 tensors, which are written back; every
per-parameter slot is zeros in the parameter's dtype and on its device
(the reference's `_ensure_state`), so under AMP O2 a bf16 parameter has
bf16 moments.

State: `state_dict()` is Paddle's, in the reference's layout —
``_step_count``, ``{slot}_{i}`` by parameter order (over all groups),
``LR_Scheduler`` when the rate is a scheduler — and it holds everything
`step()` depends on. It overrides torch's, and `load_state_dict` is an
alias of `set_state_dict`, so what one returns the other takes.
`set_state_dict` copies into the slots that exist (so one dict can be
loaded twice) and casts to the parameter's dtype and device.

Arguments the reference accepts and ignores are given Paddle's meaning
where the ROADMAP (Queue 3) decided so: AdamW's `apply_decay_param_fun`
(decay only where it returns True; it is called with the parameter's
name, from ``named_parameters()`` when the optimizer was given those,
else its ``.name`` or its index) and `lr_ratio` (a function of the
parameter scaling its rate, decay included), Adagrad's
`initial_accumulator_value` (the moment's start) and Lamb's
`exclude_from_weight_decay_fn` (no decay where it returns True for the
parameter). The others raise `NotImplementedError` when set: Adam's and
AdamW's `lazy_mode`, `multi_precision` and `amsgrad`, and LBFGS's
`weight_decay` and `grad_clip`.
"""
from __future__ import annotations

import numbers

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Rprop", "ASGD",
           "LBFGS"]

#: keys a parameter group may hold: the port has one set of options
_GROUP_KEYS = {"params", "param_names", "lr"}


def _decay_value(weight_decay):
    """Paddle's weight_decay: a number, None, or an L2Decay-style object
    with `coeff` / `_coeff`."""
    if weight_decay is None or isinstance(weight_decay, numbers.Real):
        return float(weight_decay or 0.0)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


def _ignored(owner, **args):
    """Raise for an argument the reference accepts and ignores, when it is
    set to anything but its default."""
    for name, (value, default) in args.items():
        if value != default:
            raise NotImplementedError(
                f"{owner}({name}={value!r}): the reference accepts the "
                f"argument and ignores it; the port refuses it")


def _f32(ts):
    """f32 working tensors: the tensors themselves when every one is f32,
    else views of one flat f32 copy of them all (two launches, where a
    copy each would take one a tensor)."""
    ts = list(ts)
    if all(t.dtype == torch.float32 for t in ts):
        return ts
    flat = torch.cat([t.reshape(-1) for t in ts]).float()
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def _write_back(dsts, srcs):
    """Copy each f32 working tensor into its destination (casting to the
    destination's dtype) unless they are the same tensor."""
    pairs = [(d, s) for d, s in zip(dsts, srcs)
             if d.data_ptr() != s.data_ptr()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class Optimizer(torch.optim.Optimizer):
    """The Paddle surface: `get_lr`, `set_lr`, `set_lr_scheduler`,
    `step`, `minimize`, `clear_grad`, `state_dict`, `set_state_dict`.
    Subclasses name their per-parameter slots in `_slots` and implement
    `_update(params, grads, lr, t)`."""

    _slots = ()

    def __init__(self, learning_rate, parameters, weight_decay=None,
                 grad_clip=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {learning_rate!r}")
        self._learning_rate = learning_rate
        super().__init__(parameters, {"lr": self.get_lr()})
        for group in self.param_groups:
            extra = set(group) - _GROUP_KEYS
            if extra:
                raise NotImplementedError(
                    f"parameter groups with options of their own "
                    f"({sorted(extra)}): the port's optimizers apply one "
                    f"set of options to every parameter, as the "
                    f"reference's do")
        self._weight_decay = _decay_value(weight_decay)
        self._grad_clip = grad_clip
        self._step_count = 0
        self.last_grad_norm = None

    # -- parameters ------------------------------------------------------
    @property
    def _parameter_list(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _param_names(self):
        """{parameter: name}: from ``named_parameters()`` when the
        optimizer was given those, else the parameter's ``.name``, else
        its index."""
        names = {}
        i = 0
        for g in self.param_groups:
            given = g.get("param_names")
            for j, p in enumerate(g["params"]):
                names[p] = (given[j] if given else
                            getattr(p, "name", None) or str(i))
                i += 1
        return names

    # -- learning rate ---------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        if not isinstance(scheduler, LRScheduler):
            raise TypeError(f"expected an LRScheduler, got {scheduler!r}")
        self._learning_rate = scheduler

    # -- slots -----------------------------------------------------------
    def _init_slot(self, p, name, lr):
        return torch.zeros_like(p)

    def _slot_lists(self, params, lr):
        """[[slot of each param] for each slot name], made on first use."""
        out = [[] for _ in self._slots]
        for p in params:
            st = self.state[p]
            for k, name in enumerate(self._slots):
                if name not in st:
                    st[name] = self._init_slot(p, name, lr)
                out[k].append(st[name])
        return out

    # -- step ------------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for p in self._parameter_list
                  if p.grad is not None and p.requires_grad]
        self._step_count += 1
        self.last_grad_norm = None
        if not params:
            return loss
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            self.last_grad_norm = self._grad_clip(grads, params)
        lr = self.get_lr()
        for group in self.param_groups:
            group["lr"] = lr
        self._update(params, grads, lr, self._step_count)
        return loss

    def _update(self, params, grads, lr, t):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward of `loss`, then `step()`; returns (None, [(param,
        grad)])."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    # -- state -----------------------------------------------------------
    def state_dict(self):
        """``_step_count``, ``{slot}_{i}`` (the slot tensors themselves)
        and ``LR_Scheduler``."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            st = self.state.get(p)
            if st:
                for name in self._slots:
                    if name in st:
                        out[f"{name}_{i}"] = st[name]
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def _set_slot(self, p, name, value):
        """Slot `name` of `p` := `value` (a tensor or an array), in p's
        dtype and on its device, copied into the slot when it exists."""
        v = torch.as_tensor(value).to(device=p.device, dtype=p.dtype)
        st = self.state[p]
        if name in st and st[name].shape == v.shape:
            st[name].copy_(v)
        else:
            st[name] = v.clone()

    def set_state_dict(self, state):
        self._step_count = int(state.get("_step_count", 0))
        for i, p in enumerate(self._parameter_list):
            for name in self._slots:
                if f"{name}_{i}" in state:
                    self._set_slot(p, name, state[f"{name}_{i}"])
        if ("LR_Scheduler" in state
                and isinstance(self._learning_rate, LRScheduler)):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    load_state_dict = set_state_dict


class SGD(Optimizer):
    """``p -= lr * (g + wd * p)``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, params, grads, lr, t):
        p32, g32 = _f32(params), _f32(grads)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_add_(p32, g32, alpha=-lr)
        _write_back(params, p32)


class Momentum(Optimizer):
    """``g' = g + wd * p``, ``v = mu * v + g'``, then ``p -= lr * v``, or
    ``p -= lr * (g' + mu * v)`` with Nesterov."""

    _slots = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _update(self, params, grads, lr, t):
        mu = self._momentum
        (vel,) = self._slot_lists(params, lr)
        p32, g32, v32 = _f32(params), _f32(grads), _f32(vel)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_mul_(v32, mu)
        torch._foreach_add_(v32, g32)
        upd = (torch._foreach_add(g32, v32, alpha=mu) if self._nesterov
               else v32)
        torch._foreach_add_(p32, upd, alpha=-lr)
        _write_back(params, p32)
        _write_back(vel, v32)


class Adam(Optimizer):
    """Moments and bias correction in f32; `weight_decay` is an L2 term
    added to the gradient."""

    _slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        _ignored(type(self).__name__, lazy_mode=(lazy_mode, False),
                 multi_precision=(multi_precision, False),
                 amsgrad=(amsgrad, False))
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _lists(self, params, grads, lr):
        """The f32 params and gradients, the two moment slots and their f32
        values."""
        m, v = self._slot_lists(params, lr)
        return _f32(params), _f32(grads), (m, v), (_f32(m), _f32(v))

    def _adam_step(self, g32, m32, v32, t):
        """Advance the f32 moments in place; returns (mhat, sqrt(vhat) +
        eps)."""
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1 - b2)
        denom = torch._foreach_div(v32, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(m32, 1 - b1 ** t)
        return upd, denom

    def _update(self, params, grads, lr, t):
        p32, g32, (m, v), (m32, v32) = self._lists(params, grads, lr)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        upd, denom = self._adam_step(g32, m32, v32, t)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        _write_back(m, m32)
        _write_back(v, v32)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p *= 1 - lr * wd`` before the
    update, on every parameter unless `apply_decay_param_fun` says
    otherwise; `lr_ratio(param)` scales a parameter's rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         amsgrad)
        self._wd = (float(weight_decay)
                    if isinstance(weight_decay, numbers.Real)
                    else float(getattr(weight_decay, "_coeff", 0.01)))
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun
        self._decay = None

    def _decays(self, params):
        if self._apply_decay_param_fun is None:
            return [self._wd] * len(params)
        if self._decay is None:
            fn = self._apply_decay_param_fun
            self._decay = {p: bool(fn(n))
                           for p, n in self._param_names().items()}
        return [self._wd if self._decay[p] else 0.0 for p in params]

    def _update(self, params, grads, lr, t):
        p32, g32, (m, v), (m32, v32) = self._lists(params, grads, lr)
        lrs = ([lr * float(self._lr_ratio(p)) for p in params]
               if self._lr_ratio is not None else [lr] * len(params))
        upd, denom = self._adam_step(g32, m32, v32, t)
        torch._foreach_mul_(upd, lrs)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(p32, [1.0 - a * w for a, w in
                                  zip(lrs, self._decays(params))])
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        _write_back(m, m32)
        _write_back(v, v32)


class Adagrad(Optimizer):
    """``m += g'^2``, ``p -= lr * g' / (sqrt(m) + eps)``; the moment
    starts at `initial_accumulator_value`."""

    _slots = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _init_slot(self, p, name, lr):
        return torch.full_like(p, self._init_acc)

    def _update(self, params, grads, lr, t):
        (mom,) = self._slot_lists(params, lr)
        p32, g32, m32 = _f32(params), _f32(grads), _f32(mom)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_addcmul_(m32, g32, g32)
        denom = torch._foreach_sqrt(m32)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        _write_back(mom, m32)


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g'^2`` (centered: minus the squared
    running mean of g'), ``mom = momentum mom + lr g' / sqrt(ms + eps)``,
    ``p -= mom``."""

    _slots = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _update(self, params, grads, lr, t):
        rho = self._rho
        slots = self._slot_lists(params, lr)
        p32, g32 = _f32(params), _f32(grads)
        ms, mg, mom = (_f32(s) for s in slots)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, g32, g32, value=1 - rho)
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, g32, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(p32, mom)
        _write_back(params, p32)
        for dst, src in zip(slots, (ms, mg, mom)):
            _write_back(dst, src)


class Adadelta(Optimizer):
    """``asg = rho asg + (1 - rho) g'^2``, ``u = g' sqrt(asu + eps) /
    sqrt(asg + eps)``, ``asu = rho asu + (1 - rho) u^2``, ``p -= lr u``."""

    _slots = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _update(self, params, grads, lr, t):
        rho, eps = self._rho, self._epsilon
        asg_s, asu_s = self._slot_lists(params, lr)
        p32, g32, asg, asu = (_f32(x) for x in (params, grads, asg_s,
                                                 asu_s))
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, g32, g32, value=1 - rho)
        num = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_mul(g32, num)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        torch._foreach_add_(p32, upd, alpha=-lr)
        _write_back(params, p32)
        _write_back(asg_s, asg)
        _write_back(asu_s, asu)


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g'``, ``u = max(b2 u, |g'|)``, ``p -= lr /
    (1 - b1^t) * m / (u + eps)``."""

    _slots = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _update(self, params, grads, lr, t):
        b1 = self._beta1
        m_s, u_s = self._slot_lists(params, lr)
        p32, g32, m32, u32 = (_f32(x) for x in (params, grads, m_s, u_s))
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1 - b1)
        torch._foreach_mul_(u32, self._beta2)
        torch._foreach_maximum_(u32, torch._foreach_abs(g32))
        den = torch._foreach_add(u32, self._epsilon)
        upd = torch._foreach_mul(m32, lr / (1 - b1 ** t))
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(p32, upd)
        _write_back(params, p32)
        _write_back(m_s, m32)
        _write_back(u_s, u32)


class Lamb(Optimizer):
    """Adam's moments, ``r = mhat / (sqrt(vhat) + eps) + wd p`` and a
    per-parameter trust ratio ``|p| / |r|`` (1 when either is 0):
    ``p -= lr * trust * r``. No decay where
    `exclude_from_weight_decay_fn(param)` is True."""

    _slots = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, params, grads, lr, t):
        b1, b2 = self._beta1, self._beta2
        m_s, v_s = self._slot_lists(params, lr)
        p32, g32, m32, v32 = (_f32(x) for x in (params, grads, m_s, v_s))
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1 - b2)
        den = torch._foreach_div(v32, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        r = torch._foreach_div(m32, 1 - b1 ** t)
        torch._foreach_div_(r, den)
        wds = [0.0 if self._exclude_fn is not None and self._exclude_fn(p)
               else self._lamb_wd for p in params]
        r = [torch.add(ri, pi, alpha=w) if w else ri
             for ri, pi, w in zip(r, p32, wds)]
        w_norm = torch.stack(torch._foreach_norm(p32))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        torch._foreach_mul_(r, list((trust * lr).unbind()))
        torch._foreach_sub_(p32, r)
        _write_back(params, p32)
        _write_back(m_s, m32)
        _write_back(v_s, v32)


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown by `etas[1]` where
    the gradient kept its sign, shrunk by `etas[0]` where it flipped (and
    that element's gradient then taken as 0), clipped to
    `learning_rate_range`; ``p -= sign(g) * size``. The step size starts
    at the learning rate (the reference's eager `_ensure_state`)."""

    _slots = ("prev_grad", "step_size")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self.lr_min, self.lr_max = (float(x) for x in learning_rate_range)
        self.eta_minus, self.eta_plus = (float(x) for x in etas)

    def _init_slot(self, p, name, lr):
        if name == "step_size":
            return torch.full_like(p, lr)
        return torch.zeros_like(p)

    def _update(self, params, grads, lr, t):
        prev_s, size_s = self._slot_lists(params, lr)
        for p, g, prev, size in zip(params, grads, prev_s, size_s):
            p32, g32 = p.float(), g.float()
            sign = torch.sign(g32 * prev.float())
            s = size.float()
            s = torch.where(sign > 0, s * self.eta_plus,
                            torch.where(sign < 0, s * self.eta_minus, s))
            s = s.clamp(self.lr_min, self.lr_max)
            g_eff = torch.where(sign < 0, torch.zeros_like(g32), g32)
            p32 = p32 - torch.sign(g_eff) * s
            p.copy_(p32)
            prev.copy_(g_eff)
            size.copy_(s)


class ASGD(Optimizer):
    """SGD, ``p -= lr * (g + wd p)``, and the running average of the
    iterates in the ``avg`` slot: ``avg += (p - avg) / max(t, 1)``."""

    _slots = ("avg",)

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, params, grads, lr, t):
        (avg_s,) = self._slot_lists(params, lr)
        p32, g32, a32 = _f32(params), _f32(grads), _f32(avg_s)
        if self._weight_decay:
            g32 = torch._foreach_add(g32, p32, alpha=self._weight_decay)
        torch._foreach_add_(p32, g32, alpha=-lr)
        diff = torch._foreach_sub(p32, a32)
        torch._foreach_div_(diff, float(max(t, 1)))
        torch._foreach_add_(a32, diff)
        _write_back(params, p32)
        _write_back(avg_s, a32)


class LBFGS(Optimizer):
    """Limited-memory BFGS driven by a closure (``step(closure)``: the
    closure clears the gradients, computes the loss, runs backward and
    returns the loss): the two-loop recursion over a history of (s, y)
    pairs, at most `max_iter` iterations and `max_eval` closure calls a
    step, and the optional ``"backtracking"`` (Armijo) or
    ``"strong_wolfe"`` (Armijo plus the curvature condition) line search.
    It has no per-parameter update, so `distributed.parallelize` refuses
    it; the history is not part of `state_dict()` (as in the
    reference)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        _ignored("LBFGS", weight_decay=(weight_decay, None),
                 grad_clip=(grad_clip, None))
        super().__init__(learning_rate, parameters, None, None)
        self.max_iter = int(max_iter)
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        self.line_search_fn = line_search_fn
        self.max_eval = (int(max_eval) if max_eval is not None
                         else self.max_iter * 5 // 4)
        self._s_hist = []
        self._y_hist = []

    def _flat_grad(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .float().reshape(-1) for p in self._parameter_list])

    def _flat_params(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._parameter_list])

    def _assign(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _direction(self, flat_grad):
        q = -flat_grad
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._y_hist:
            y, s = self._y_hist[-1], self._s_hist[-1]
            q = q * (torch.dot(s, y) / torch.clamp_min(torch.dot(y, y),
                                                       1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    @torch.no_grad()
    def step(self, closure):
        """Returns the last loss as a float."""
        evals = [0]

        def f():
            evals[0] += 1
            with torch.enable_grad():
                return float(closure().detach())

        cur = f()
        flat_grad = self._flat_grad()
        for _ in range(self.max_iter):
            if evals[0] >= self.max_eval:
                break
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            d = self._direction(flat_grad)
            lr = self.get_lr()
            x0 = self._flat_params()
            if self.line_search_fn in ("strong_wolfe", "backtracking"):
                # the line search shares the evaluation budget, keeping
                # one for the gradient at the accepted point
                budget = max(0, self.max_eval - evals[0] - 1)
                lr = self._backtrack(
                    f, x0, d, cur, flat_grad, lr, max_ls=min(10, budget),
                    curvature=self.line_search_fn == "strong_wolfe")
            self._assign(x0 + lr * d)
            new_loss = f()
            new_flat = self._flat_grad()
            s = lr * d
            y = new_flat - flat_grad
            if float(torch.dot(y, s)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
            done = abs(new_loss - cur) < self.tolerance_change
            cur = new_loss
            flat_grad = new_flat
            if done:
                break
        self._step_count += 1
        return cur

    def _backtrack(self, f, x0, d, f0, g0, lr, c1=1e-4, c2=0.9, shrink=0.5,
                   max_ls=10, curvature=False):
        """Armijo backtracking; with `curvature` also the strong Wolfe
        condition |g1.d| <= c2 |g0.d|, stepping further while the slope
        still descends."""
        gd = float(torch.dot(g0, d))
        for _ in range(max_ls):
            self._assign(x0 + lr * d)
            if f() <= f0 + c1 * lr * gd:
                if not curvature:
                    return lr
                g1d = float(torch.dot(self._flat_grad(), d))
                if abs(g1d) <= c2 * abs(gd):
                    return lr
                if g1d < 0:
                    lr /= shrink
                    continue
            lr *= shrink
        return lr
