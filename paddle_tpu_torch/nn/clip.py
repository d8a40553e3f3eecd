"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py and the
engine's `_clip_grads`, paddle_tpu/distributed/engine.py).

A clip is called as ``clip(grads, params=None)`` on a list of gradients,
clips them in place and returns the pre-clip global norm of all of them
(a 0-d f32 tensor), which the optimizers keep in `last_grad_norm` and the
engine reports. Each clip acts as the JAX engine's `_clip_grads` makes it
act: the norms are taken in f32, the scale is ``min(1, clip_norm /
max(norm, 1e-12))`` (the reference's eager ``clip_norm / max(norm,
clip_norm)`` is the same function), and ClipGradByValue clamps. When
`params` is given, a gradient whose parameter has ``need_clip = False``
is left as it is (and out of a global-norm clip's norm), as the
reference's eager clips do.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "global_norm"]


def global_norm(grads):
    """sqrt of the sum of squares of every gradient, taken in f32; a 0-d
    f32 tensor on the gradients' device."""
    grads = [g.float() for g in grads]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _clippable(grads, params):
    """The gradients whose parameter does not say ``need_clip = False``,
    and whether that is all of them."""
    if params is None:
        return grads, True
    keep = [g for g, p in zip(grads, params)
            if getattr(p, "need_clip", True) is not False]
    return keep, len(keep) == len(grads)


def _scale(clip_norm, norm):
    return torch.clamp(clip_norm / norm.clamp_min(1e-12), max=1.0)


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-12))``
    where `norm` is the global norm over all of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        if auto_skip_clip:
            raise NotImplementedError(
                "ClipGradByGlobalNorm(auto_skip_clip=True): the reference "
                "accepts it and ignores it")
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, grads, params=None):
        grads = list(grads)
        clipped, every = _clippable(grads, params)
        norm = global_norm(clipped)
        total = norm if every else global_norm(grads)
        if clipped:
            scale = _scale(self.clip_norm, norm)
            torch._foreach_mul_(clipped, scale.to(clipped[0].device))
        return total


class ClipGradByNorm:
    """Scale each gradient by ``min(1, clip_norm / max(its norm,
    1e-12))``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, grads, params=None):
        grads = list(grads)
        if not grads:
            return global_norm(grads)
        norms = torch._foreach_norm([g.float() for g in grads])
        total = torch.linalg.vector_norm(torch.stack(norms))
        keep = (range(len(grads)) if params is None else
                [i for i, p in enumerate(params)
                 if getattr(p, "need_clip", True) is not False])
        if keep:
            scales = _scale(self.clip_norm,
                            torch.stack([norms[i] for i in keep]))
            torch._foreach_mul_([grads[i] for i in keep],
                                list(scales.unbind()))
        return total


class ClipGradByValue:
    """Clamp every gradient element to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    @torch.no_grad()
    def __call__(self, grads, params=None):
        grads = list(grads)
        total = global_norm(grads)
        clipped, _ = _clippable(grads, params)
        if clipped:
            torch._foreach_clamp_min_(clipped, self.min)
            torch._foreach_clamp_max_(clipped, self.max)
        return total


def _params(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place by ``min(max_norm /
    max(total, 1e-6), 1)``, total being their `norm_type` norm (f32;
    ``inf``: the largest magnitude). Returns the total."""
    if error_if_nonfinite:
        raise NotImplementedError(
            "clip_grad_norm_(error_if_nonfinite=True): the reference "
            "accepts it and ignores it")
    grads = [p.grad for p in _params(parameters) if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / total.clamp_min(1e-6), max=1.0)
    torch._foreach_mul_(grads, scale.to(grads[0].device))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the parameters' gradients in place to [-clip_value,
    clip_value]."""
    grads = [p.grad for p in _params(parameters) if p.grad is not None]
    if grads:
        torch._foreach_clamp_min_(grads, -float(clip_value))
        torch._foreach_clamp_max_(grads, float(clip_value))
