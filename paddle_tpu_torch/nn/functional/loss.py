"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

`cross_entropy` is the hard-label softmax cross entropy of the JAX
package's `_ce_hard` custom VJP: the logsumexp is taken in f32 from
``logits - max``, the loss is cast back to the logits' dtype, and the
backward is one pass, ``d_logits = (softmax - onehot) * mask * g`` in f32,
so autograd never builds log-softmax or a scattered gradient over the
whole [T, V] logits.
"""
from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["cross_entropy", "cross_entropy_share"]


class _CrossEntropyHard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, ignore_index, denom, out_dtype):
        m = logits.amax(dim=-1, keepdim=True)
        sumexp = torch.exp((logits - m).float()).sum(dim=-1)
        lse = m[..., 0].float() + torch.log(sumexp)
        mask = label != ignore_index
        safe = torch.where(mask, label, torch.zeros_like(label))
        picked = logits.gather(-1, safe[..., None])[..., 0].float()
        loss = torch.where(mask, lse - picked, torch.zeros_like(lse))
        if denom is None:
            denom = mask.sum().float().clamp_min(1.0)
        else:
            denom = torch.tensor(float(denom), device=logits.device)
        ctx.save_for_backward(logits, safe, mask, lse, denom)
        return (loss.sum() / denom).to(out_dtype or logits.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, safe, mask, lse, denom = ctx.saved_tensors
        scale = g.float() / denom * mask.float()
        d = torch.exp(logits.float() - lse[..., None])
        d.scatter_add_(-1, safe[..., None],
                       torch.full_like(lse[..., None], -1.0))
        d.mul_(scale[..., None])
        return d.to(logits.dtype), None, None, None, None


@amp_op("cross_entropy")
def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Hard-label softmax cross entropy over the last axis, averaged over
    the positions whose label is not `ignore_index` (at least 1). input
    [..., V] logits; label [...] int (or [..., 1]). Returns the loss in
    the logits' dtype. Only ``reduction="mean"`` is ported."""
    if reduction != "mean":
        raise NotImplementedError(f"cross_entropy(reduction={reduction!r}) "
                                  f"is not ported yet; only 'mean' is")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    return _CrossEntropyHard.apply(input, label.long(), int(ignore_index),
                                   None, None)


@amp_op("cross_entropy")
def cross_entropy_share(input, label, denom):
    """This rank's share of a mean cross entropy taken over more rows than
    it holds: the sum over its rows divided by `denom` (the global count),
    in f32, so the shares of all ranks sum to the global mean (the
    context-parallel loss)."""
    return _CrossEntropyHard.apply(input, label.long(), -100, denom,
                                   torch.float32)
