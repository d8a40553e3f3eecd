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

Frozen parameters keep Paddle's meaning: a parameter with
``requires_grad=False`` (``stop_gradient``; `nn.lora.apply_lora` freezes
all but the adapters) gets no gradient and no update, whether the
optimizer was given only the trainable parameters or all of them, and
`last_grad_norm` covers the trainable gradients only. (The JAX engine
updates every parameter, frozen or not: ROADMAP Queue 3.)

Context parallelism (``mesh=MeshConfig(cp=n)`` or a built cp `Mesh`,
``context_parallel="ring"`` by default as in JAX, or ``"ulysses"``) runs
the step in each of the n ranks of a `torch.distributed` job. JAX keeps
every global-sequence operation global under GSPMD; per rank the port
keeps them global by hand:

* every rank is given the same global batch and its model's cp-aware
  loss takes the rank's rows (`models.gpt.GPTForCausalLM.loss`), embeds
  them at their global positions, shifts targets globally and divides by
  the global token count;
* every attention runs under `context_parallel_guard`: the ring (or
  Ulysses) across the ranks;
* the gradients are summed over the mesh before the clip, so every rank
  clips by the same global norm and applies the same update;
* the reported loss is the sum of the ranks' shares, the global loss.

A custom `loss_fn` cannot keep those invariants and raises under cp > 1
(the model's own `loss` is the cp-aware one). Other meshes — more than
one device in a list, ``dp``/``fsdp``/``tp`` — and ``sharding_stage !=
0`` raise `NotImplementedError` (a later slice).

Training recipes: the optimizer's `grad_clip` (any of the three clips)
and its learning rate act inside its `step()`, which reads ``get_lr()``
every batch — an `optimizer.lr.LRScheduler` is stepped by the user after
`train_batch`, and by the engine once per micro-step it consumes in
`train_batches` (as the JAX engine does). `snapshot()` / `restore()`
rewind the carried state bit for bit, and `state_dict()` /
`load_state_dict()` carry it in the JAX engine's tree.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..nn.clip import global_norm
from ..optimizer.lr import LRScheduler
from ..optimizer.optimizer import LBFGS
from ..sharding import Mesh, MeshConfig
from .context_parallel import context_parallel_guard

__all__ = ["parallelize", "ShardedTrainStep"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_LATER = ("is not ported yet: the port trains on one device (multi-device "
          "meshes and sharding come with a later slice, ROADMAP Queue 1, "
          "item 6: more than one device)")


def _dtype(d):
    if d is None or isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unsupported compute_dtype {d!r}")
    return _DTYPES[d]


def _mesh_size(mesh):
    size = getattr(mesh, "size", None)
    return int(size() if callable(size) else len(mesh))


def _is_model_loss(loss_fn, model):
    return (getattr(loss_fn, "__self__", None) is model
            and getattr(loss_fn, "__func__", None)
            is getattr(type(model), "loss", None))


class _LossOf(nn.Module):
    """`loss_fn(model, *batch)` as a module, so `functional_call` can swap
    the model's parameters for their compute-dtype copies."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch):
        return self.loss_fn(self.model, *batch)


def _generators(model):
    """Every `torch.Generator` the model's modules hold (dropout's, the
    short-attention kernels' seeds), once each, in module order."""
    gens = {}
    for m in model.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator):
                gens.setdefault(id(v), v)
    return list(gens.values())


def _default_generator(device):
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


class ShardedTrainStep:
    """`loss_fn(model, *batch)` plus the optimizer update, one step per
    `train_batch`. Attributes: `last_grad_norm` (0-d device tensor, the
    pre-clip global norm of the last step), `last_grad_norms` (one per
    step of the last `train_batches`, else None) and `stats`
    (``dispatches``, ``steps``, ``device_puts``)."""

    def __init__(self, model, optimizer, loss_fn=None, compute_dtype=None,
                 mesh=None, context_parallel="ring"):
        self.mesh = mesh
        self.cp = mesh.size if isinstance(mesh, Mesh) else 1
        self.context_parallel = context_parallel
        if self.cp > 1:
            if context_parallel not in ("ring", "ulysses"):
                raise ValueError(
                    f"context_parallel={context_parallel!r} on a cp="
                    f"{self.cp} mesh: each rank holds a shard of the "
                    f"sequence, so attention must be 'ring' or 'ulysses'")
            if loss_fn is not None and not _is_model_loss(loss_fn, model):
                raise NotImplementedError(
                    "a custom loss_fn under context parallelism: only the "
                    "model's own cp-aware loss shifts targets and averages "
                    "over the global sequence")
            loss_fn = None
        if loss_fn is None:
            if not hasattr(model, "loss"):
                raise ValueError("pass loss_fn or give the model a .loss")
            loss_fn = lambda m, *batch: m.loss(*batch)  # noqa: E731
        self.model = model
        self.optimizer = optimizer
        self.compute_dtype = _dtype(compute_dtype)
        self._loss_of = _LossOf(model, loss_fn)
        self._named = dict(model.named_parameters())
        self._buffers = dict(model.named_buffers())
        self._params = {"model." + n: p for n, p in self._named.items()}
        self.device = next(iter(self._params.values())).device
        if self.cp > 1 and self.device != mesh.device:
            raise ValueError(f"the model is on {self.device}, this rank's "
                             f"mesh device is {mesh.device}")
        self.last_grad_norm = None
        self.last_grad_norms = None
        self._step_count = 0
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
        guard = (context_parallel_guard(self.mesh, self.context_parallel)
                 if self.cp > 1 else contextlib.nullcontext())
        with guard:
            if self.compute_dtype is None:
                return self._loss_of(*batch)
            cd = self.compute_dtype
            params = {n: p.to(cd) if p.is_floating_point() else p
                      for n, p in self._params.items()}
            return functional_call(self._loss_of, params, tuple(batch))

    def _global_loss(self, loss):
        """The sum of the ranks' shares (cp > 1), else the loss."""
        if self.cp == 1:
            return loss
        return self.mesh.transport.all_reduce_(loss.detach().float()
                                               .reshape(1))[0]

    def _grads(self):
        """The trainable parameters' gradients (a frozen parameter's
        stale `.grad`, if it has one, is not the step's)."""
        return [p.grad for p in self._params.values()
                if p.grad is not None and p.requires_grad]

    def _sum_grads(self):
        """Sum every gradient over the cp mesh, coalesced into one f32
        buffer (the same bits on every rank)."""
        grads = self._grads()
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        self.mesh.transport.all_reduce_(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def train_batch(self, *batch):
        """One optimizer step; returns the (device, detached) loss."""
        if self.optimizer is None:
            raise RuntimeError(
                "this engine was built without an optimizer; use eval_batch")
        placed = self._place(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(placed)
        loss.backward()
        if self.cp > 1:
            self._sum_grads()
        self.optimizer.step()
        # the pre-clip norm the optimizer's clip took; without a clip the
        # step left the gradients as they were, so take it here
        norm = getattr(self.optimizer, "last_grad_norm", None)
        if norm is None:
            norm = global_norm(self._grads())
        self.last_grad_norm = norm
        self.last_grad_norms = None
        self._step_count += 1
        self.stats["dispatches"] += 1
        self.stats["steps"] += 1
        return self._global_loss(loss.detach())

    def train_batches(self, batches, n=None):
        """`train_batch` over each batch (a tuple of arguments or a single
        one), at most `n`; returns the stacked losses and keeps the grad
        norms in `last_grad_norms`. An `LRScheduler` learning rate is
        stepped once after each of these steps (do not also step it for
        them)."""
        batches = list(batches)[:n]
        sched = getattr(self.optimizer, "_learning_rate", None)
        losses, norms = [], []
        for b in batches:
            losses.append(self.train_batch(
                *(b if isinstance(b, (tuple, list)) else (b,))))
            norms.append(self.last_grad_norm)
            if isinstance(sched, LRScheduler):
                sched.step()
        if not losses:
            return torch.zeros((0,), device=self.device)
        self.last_grad_norms = torch.stack(norms)
        return torch.stack(losses)

    @torch.no_grad()
    def eval_batch(self, *batch):
        """The loss alone: no gradients, no update."""
        self.stats["dispatches"] += 1
        return self._global_loss(self._loss(self._place(batch)))

    # ---- rewindable state ----------------------------------------------
    def _slots(self, p):
        return self.optimizer.state.get(p, {}) if self.optimizer else {}

    @torch.no_grad()
    def snapshot(self):
        """A deep copy of the carried train state: the parameters (the f32
        masters), the optimizer's slots and step counter, the buffers
        (batch-norm running statistics), the engine's step count, and the
        state of every `torch.Generator` the model holds and of the
        device's default generator, so a `restore` replays the same
        dropout. The LR scheduler is not part of it (as in the
        reference): save and restore it with its own `state_dict`."""
        gens = _generators(self.model) + [_default_generator(self.device)]
        return {
            "step_count": self._step_count,
            "params": {n: p.detach().clone() for n, p in self._named.items()},
            "opt_step": getattr(self.optimizer, "_step_count", None),
            "opt": {n: {s: v.clone() for s, v in self._slots(p).items()}
                    for n, p in self._named.items() if self._slots(p)},
            "buffers": {n: b.clone() for n, b in self._buffers.items()},
            "generators": [g.get_state() for g in gens],
        }

    @torch.no_grad()
    def restore(self, snap):
        """Rewind to `snap` (from `snapshot()`), copying into the engine's
        own tensors: the same snapshot can be restored again. Slots made
        since the snapshot are dropped; the default generator of the
        device is rewound too."""
        for n, p in self._named.items():
            p.copy_(snap["params"][n])
        for n, b in self._buffers.items():
            b.copy_(snap["buffers"][n])
        if self.optimizer is not None:
            self.optimizer._step_count = snap["opt_step"]
            for n, p in self._named.items():
                self._load_slots(p, snap["opt"].get(n), drop=True)
        gens = _generators(self.model) + [_default_generator(self.device)]
        for g, state in zip(gens, snap["generators"]):
            g.set_state(state)
        self._step_count = int(snap["step_count"])

    def _load_slots(self, p, slots, drop=False):
        """Set `p`'s optimizer slots from {name: value}; with `drop`, also
        remove the slots `slots` does not name."""
        st = self.optimizer.state[p]
        if drop:
            for s in set(st) - set(slots or ()):
                del st[s]
        for s, v in (slots or {}).items():
            self.optimizer._set_slot(p, s, v)

    def state_dict(self):
        """The JAX engine's checkpoint tree: ``model`` and ``buffers``
        ({name: tensor}), ``opt`` ({parameter name: {slot: tensor}}, when
        there is an optimizer) and ``step``. Leaves are the engine's own
        tensors (a checkpoint writer copies them)."""
        tree = {"model": {n: p.detach() for n, p in self._named.items()},
                "buffers": dict(self._buffers),
                "step": self._step_count}
        if self.optimizer is not None:
            tree["opt"] = {n: dict(self._slots(p))
                           for n, p in self._named.items()}
        return tree

    @torch.no_grad()
    def load_state_dict(self, tree):
        """Adopt a `state_dict()`-shaped tree (torch tensors or numpy
        arrays, the port's layouts: see `convert.engine_state_from_jax`),
        cast to each tensor's dtype and device. The optimizer's step
        counter becomes ``step``."""
        for n, p in self._named.items():
            p.copy_(torch.as_tensor(tree["model"][n]))
        for n, b in self._buffers.items():
            if n in tree.get("buffers", {}):
                b.copy_(torch.as_tensor(tree["buffers"][n]))
        for n, slots in (tree.get("opt") or {}).items():
            self._load_slots(self._named[n], slots)
        self._step_count = int(tree.get("step", 0))
        if self.optimizer is not None:
            self.optimizer._step_count = self._step_count

    def sync_optimizer_state(self):
        """Nothing to do: the JAX engine keeps the slots apart from its
        eager optimizer and copies them back here; the port's engine
        steps the optimizer itself, which holds its slots."""


def parallelize(model, optimizer=None, loss_fn=None, *, mesh=None,
                sharding_stage=0, compute_dtype=None,
                context_parallel="ring"):
    """Counterpart of `paddle_tpu.distributed.parallelize`: returns a
    `ShardedTrainStep` that trains `model` where it lives — on one device,
    or, with ``mesh=MeshConfig(cp=n)`` (or its built `Mesh`), as this
    rank's part of n-way context parallelism (`context_parallel` "ring"
    or "ulysses"; a custom `loss_fn` raises there)."""
    if isinstance(mesh, MeshConfig):
        mesh = mesh.build(device=next(model.parameters()).device)
    if isinstance(mesh, Mesh):
        if mesh.size == 1:
            mesh = None
    elif mesh is not None and _mesh_size(mesh) > 1:
        raise NotImplementedError(f"a mesh of {_mesh_size(mesh)} devices "
                                  + _LATER)
    if sharding_stage != 0:
        raise NotImplementedError(f"sharding_stage={sharding_stage} "
                                  + _LATER)
    if isinstance(optimizer, LBFGS):
        raise TypeError(
            "LBFGS has no per-parameter update for the engine to apply (it "
            "re-evaluates a closure); use it eagerly, opt.step(closure)")
    return ShardedTrainStep(model, optimizer, loss_fn=loss_fn,
                            compute_dtype=compute_dtype, mesh=mesh,
                            context_parallel=context_parallel)
