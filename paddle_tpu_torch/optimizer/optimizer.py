"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

`AdamW` computes exactly what the JAX package's `AdamW._update_one` does
on its engine path: moments, bias correction and decoupled weight decay
in f32, the step counter starting at 1, the decay applied to every
parameter, and the optional `grad_clip` applied to all gradients first.
The update runs as multi-tensor `torch._foreach_*` calls.
"""
from __future__ import annotations

import numbers

import torch

__all__ = ["AdamW"]


def _lr_value(learning_rate):
    if not isinstance(learning_rate, numbers.Real):
        raise NotImplementedError(
            f"learning rate {learning_rate!r}: LR schedulers are not ported "
            f"yet (a later slice, ROADMAP 'Training still lacks'); pass a "
            f"number")
    return float(learning_rate)


class AdamW(torch.optim.Optimizer):
    """Paddle signature (``learning_rate``, ``beta1``, ``beta2``,
    ``epsilon``, ``parameters``, ``weight_decay``, ``grad_clip``).
    With a `grad_clip`, each `step()` keeps the pre-clip global norm that
    the clip took in `last_grad_norm` (else None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        defaults = dict(lr=_lr_value(learning_rate), beta1=float(beta1),
                        beta2=float(beta2), eps=float(epsilon),
                        weight_decay=float(weight_decay), step=0)
        super().__init__(parameters, defaults)
        self._grad_clip = grad_clip
        self.last_grad_norm = None

    def _state(self, p):
        st = self.state[p]
        if not st:
            st["moment1"] = torch.zeros_like(p)
            st["moment2"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._grad_clip is not None:
            self.last_grad_norm = self._grad_clip(
                [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None])
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            group["step"] += 1
            self._update(group, params)
        return loss

    def _update(self, group, params):
        lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
        b1, b2, t = group["beta1"], group["beta2"], group["step"]
        states = [self._state(p) for p in params]
        # f32 views: the tensors themselves when they are f32 (the usual
        # masters), else f32 copies written back at the end
        p32 = [p.float() for p in params]
        g32 = [p.grad.float() for p in params]
        m32 = [st["moment1"].float() for st in states]
        v32 = [st["moment2"].float() for st in states]
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1 - b2)
        denom = torch._foreach_div(v32, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m32, 1 - b1 ** t)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(p32, 1.0 - lr * wd)
        torch._foreach_sub_(p32, upd)
        for p, st, a, m, v in zip(params, states, p32, m32, v32):
            for dst, src in ((p, a), (st["moment1"], m), (st["moment2"], v)):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
