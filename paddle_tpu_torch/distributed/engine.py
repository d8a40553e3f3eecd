"""Single-device training engine (counterpart of
paddle_tpu/distributed/engine.py's `parallelize` / `ShardedTrainStep`).

One `train_batch` is what the JAX engine's compiled `_make_step` is:
forward and loss, backward, the pre-clip global grad norm, the clip and
the optimizer update — here as eager PyTorch on the model's own device.
``compute_dtype="bfloat16"`` means what it means there: every float
parameter is cast to a bf16 copy for the step (a differentiable cast
through `torch.func.functional_call`, so the gradients arrive in f32 on
the f32 masters that the optimizer keeps), and float batch inputs are
cast too. Nothing is moved: the engine trains where the caller built the
model, and batches are brought to that device.

Only one device is ported: a mesh of more than one device and
``sharding_stage != 0`` raise `NotImplementedError` (a later slice).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..nn.clip import global_norm

__all__ = ["parallelize", "ShardedTrainStep"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_LATER = ("is not ported yet: the port trains on one device (multi-device "
          "meshes and sharding come with a later slice, ROADMAP 'Training "
          "still lacks')")


def _dtype(d):
    if d is None or isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unsupported compute_dtype {d!r}")
    return _DTYPES[d]


def _mesh_size(mesh):
    size = getattr(mesh, "size", None)
    return int(size() if callable(size) else len(mesh))


class _LossOf(nn.Module):
    """`loss_fn(model, *batch)` as a module, so `functional_call` can swap
    the model's parameters for their compute-dtype copies."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch):
        return self.loss_fn(self.model, *batch)


class ShardedTrainStep:
    """`loss_fn(model, *batch)` plus the optimizer update, one step per
    `train_batch`. Attributes: `last_grad_norm` (0-d device tensor, the
    pre-clip global norm of the last step), `last_grad_norms` (one per
    step of the last `train_batches`, else None) and `stats`
    (``dispatches``, ``steps``, ``device_puts``)."""

    def __init__(self, model, optimizer, loss_fn=None, compute_dtype=None):
        if loss_fn is None:
            if not hasattr(model, "loss"):
                raise ValueError("pass loss_fn or give the model a .loss")
            loss_fn = lambda m, *batch: m.loss(*batch)  # noqa: E731
        self.model = model
        self.optimizer = optimizer
        self.compute_dtype = _dtype(compute_dtype)
        self._loss_of = _LossOf(model, loss_fn)
        self._params = {"model." + n: p
                        for n, p in model.named_parameters()}
        self.device = next(iter(self._params.values())).device
        self.last_grad_norm = None
        self.last_grad_norms = None
        self.stats = {"dispatches": 0, "steps": 0, "device_puts": 0}

    def _place(self, batch):
        placed = []
        for b in batch:
            if isinstance(b, np.ndarray) or not torch.is_tensor(b):
                b = torch.as_tensor(b)
            if b.device != self.device:
                b = b.to(self.device)
                self.stats["device_puts"] += 1
            if self.compute_dtype is not None and b.is_floating_point():
                b = b.to(self.compute_dtype)
            placed.append(b)
        return placed

    def _loss(self, batch):
        if self.compute_dtype is None:
            return self._loss_of(*batch)
        cd = self.compute_dtype
        params = {n: p.to(cd) if p.is_floating_point() else p
                  for n, p in self._params.items()}
        return functional_call(self._loss_of, params, tuple(batch))

    def train_batch(self, *batch):
        """One optimizer step; returns the (device, detached) loss."""
        if self.optimizer is None:
            raise RuntimeError(
                "this engine was built without an optimizer; use eval_batch")
        placed = self._place(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(placed)
        loss.backward()
        self.optimizer.step()
        # the pre-clip norm the optimizer's clip took; without a clip the
        # step left the gradients as they were, so take it here
        norm = getattr(self.optimizer, "last_grad_norm", None)
        if norm is None:
            norm = global_norm([p.grad for p in self._params.values()
                                if p.grad is not None])
        self.last_grad_norm = norm
        self.last_grad_norms = None
        self.stats["dispatches"] += 1
        self.stats["steps"] += 1
        return loss.detach()

    def train_batches(self, batches, n=None):
        """`train_batch` over each batch (a tuple of arguments or a single
        one), at most `n`; returns the stacked losses and keeps the grad
        norms in `last_grad_norms`."""
        batches = list(batches)[:n]
        losses, norms = [], []
        for b in batches:
            losses.append(self.train_batch(
                *(b if isinstance(b, (tuple, list)) else (b,))))
            norms.append(self.last_grad_norm)
        if not losses:
            return torch.zeros((0,), device=self.device)
        self.last_grad_norms = torch.stack(norms)
        return torch.stack(losses)

    @torch.no_grad()
    def eval_batch(self, *batch):
        """The loss alone: no gradients, no update."""
        self.stats["dispatches"] += 1
        return self._loss(self._place(batch))


def parallelize(model, optimizer=None, loss_fn=None, *, mesh=None,
                sharding_stage=0, compute_dtype=None):
    """Counterpart of `paddle_tpu.distributed.parallelize` for one device:
    returns a `ShardedTrainStep` that trains `model` where it lives."""
    if mesh is not None and _mesh_size(mesh) > 1:
        raise NotImplementedError(f"a mesh of {_mesh_size(mesh)} devices "
                                  + _LATER)
    if sharding_stage != 0:
        raise NotImplementedError(f"sharding_stage={sharding_stage} "
                                  + _LATER)
    if optimizer is not None:
        for group in optimizer.param_groups:
            if not isinstance(group["lr"], numbers.Real):
                raise NotImplementedError(
                    f"learning rate {group['lr']!r}: LR schedulers are not "
                    f"ported yet (ROADMAP 'Training still lacks')")
    return ShardedTrainStep(model, optimizer, loss_fn=loss_fn,
                            compute_dtype=compute_dtype)
