"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py and the
engine's `_clip_grads`, paddle_tpu/distributed/engine.py)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "global_norm"]


def global_norm(grads):
    """sqrt of the sum of squares of every gradient, taken in f32; a 0-d
    f32 tensor on the gradients' device."""
    grads = [g.float() for g in grads]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class ClipGradByGlobalNorm:
    """Scale every gradient by ``min(1, clip_norm / max(norm, 1e-12))``
    where `norm` is the global norm over all of them."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, grads):
        """Clip `grads` (a list of tensors) in place; returns the pre-clip
        global norm."""
        grads = list(grads)
        norm = global_norm(grads)
        if grads:
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            torch._foreach_mul_(grads, scale.to(grads[0].device))
        return norm
