"""LoRA: low-rank adaptation of Linear layers (counterpart of
paddle_tpu/nn/lora.py).

`apply_lora` wraps the target Linears of a model in `LoRALinear`: the
frozen base weight plus trainable adapters, ``y = base(x) + scale *
(x @ A) @ B`` with A ``[in, r]`` and B ``[r, out]`` (the reference's
layout, and `inference.decode.AdapterPool`'s), so the state names are the
reference's (``...qkv_proj.base.weight``, ``...qkv_proj.lora_A``) and
`convert` carries them both ways. Everything but the adapters gets
``requires_grad=False``, Paddle's ``stop_gradient``: no gradient and no
update, eagerly and in `distributed.parallelize`'s engine.

Randomness: A is drawn U(-1/sqrt(in), 1/sqrt(in)) (the reference's
``KaimingUniform(fan_in=in, negative_slope=sqrt(5))``) and the adapter
dropout's masks are drawn from an explicit `torch.Generator` (the
caller's, else one seeded 0 on the weights' device, shared by the
wrappers of one `apply_lora` call) where the reference draws from its
global key stream.

Dtypes: the adapters are f32 whatever the base's dtype, as in the
reference, and a product of a bf16 input with them promotes as JAX
promotes (`torch.result_type`): a bf16 base gives an f32 output. Under
the engine's ``compute_dtype`` every float parameter, adapters included,
is cast for the step.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F

__all__ = ["LoRAConfig", "LoRALinear", "apply_lora", "merge_lora",
           "lora_parameters", "mark_only_lora_as_trainable",
           "export_lora_weights"]


class LoRAConfig:
    def __init__(self, r=8, lora_alpha=16, lora_dropout=0.0,
                 target_modules=("qkv", "q_proj", "k_proj", "v_proj",
                                 "out", "o_proj", "up", "down", "gate")):
        self.r = int(r)
        self.lora_alpha = float(lora_alpha)
        self.lora_dropout = float(lora_dropout)
        self.target_modules = tuple(target_modules)


class LoRALinear(nn.Module):
    """y = base(x) (frozen) + scaling * (x @ A) @ B; A: [in, r], B: [r,
    out], scaling = lora_alpha / r. `base` is an `nn.Linear` (weight
    [out, in]) or, after `nn.quant.quantize_for_inference`, a
    `WeightOnlyLinear` (which cannot merge)."""

    def __init__(self, base, r=8, lora_alpha=16, lora_dropout=0.0,
                 generator=None):
        super().__init__()
        self.base = base
        for p in base.parameters():
            p.requires_grad_(False)
        out_f, in_f = base.weight.shape
        dev = base.weight.device
        self.r = int(r)
        self.scaling = float(lora_alpha) / self.r
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.generator = generator
        bound = 1.0 / math.sqrt(in_f)
        a = torch.empty(in_f, self.r, dtype=torch.float32, device=dev)
        a.uniform_(-bound, bound, generator=generator)
        self.lora_A = nn.Parameter(a)
        self.lora_B = nn.Parameter(torch.zeros(self.r, out_f,
                                               dtype=torch.float32,
                                               device=dev))
        self._dropout_p = float(lora_dropout)
        self.merged = False

    def forward(self, x):
        y = self.base(x)
        if self.merged:
            return y
        h = x
        if self._dropout_p > 0.0 and self.training:
            h = F.dropout(h, p=self._dropout_p, training=True,
                          generator=self.generator)
        dt = torch.result_type(h, self.lora_A)
        delta = (h.to(dt) @ self.lora_A.to(dt)) @ self.lora_B.to(dt)
        return y + delta * self.scaling

    def _delta(self):
        """The adapter as a [out, in] weight delta, in the weight's dtype
        (formed in f32)."""
        w = self.base.weight
        d = (self.lora_A.float() @ self.lora_B.float()) * self.scaling
        return d.t().to(w.dtype)

    @torch.no_grad()
    def merge(self):
        """Fold the adapter into the base weight (inference deploy)."""
        if self.merged:
            return
        self.base.weight.add_(self._delta())
        self.merged = True

    @torch.no_grad()
    def unmerge(self):
        if not self.merged:
            return
        self.base.weight.sub_(self._delta())
        self.merged = False

    def extra_repr(self):
        return f"r={self.r}, scaling={self.scaling}, merged={self.merged}"


def apply_lora(model, config=None, generator=None, **kwargs):
    """Swap matching Linear sublayers for LoRALinear wrappers (in place)
    and freeze everything but the adapters. A Linear matches when a
    target fragment is a substring of its leaf name; `LoRALinear` and
    quantized layers are not Linears. `generator` draws every wrapper's
    A (in module order) and its dropout masks."""
    cfg = config or LoRAConfig(**kwargs)
    for name, sub in list(model.named_modules()):
        if not isinstance(sub, nn.Linear):
            continue
        leaf = name.split(".")[-1]
        if not any(t in leaf for t in cfg.target_modules):
            continue
        if generator is None:
            generator = torch.Generator(
                device=sub.weight.device).manual_seed(0)
        parent = model
        parts = name.split(".")
        for p in parts[:-1]:
            parent = getattr(parent, p)
        setattr(parent, parts[-1],
                LoRALinear(sub, cfg.r, cfg.lora_alpha, cfg.lora_dropout,
                           generator=generator))
    mark_only_lora_as_trainable(model)
    return model


def mark_only_lora_as_trainable(model):
    for name, p in model.named_parameters():
        p.requires_grad_("lora_A" in name or "lora_B" in name)
    return model


def lora_parameters(model):
    return [p for n, p in model.named_parameters()
            if "lora_A" in n or "lora_B" in n]


def merge_lora(model):
    for sub in model.modules():
        if isinstance(sub, LoRALinear):
            sub.merge()
    return model


@torch.no_grad()
def export_lora_weights(model):
    """A trained model's adapters as the raw (unscaled) f32 numpy
    ``{wrapped layer's name: (A [in, r], B [r, out])}``, the format
    `inference.decode.AdapterPool.load` consumes (pass the training
    `lora_alpha` to ``load(alpha=...)``; the pool folds alpha / r into B
    itself)."""
    out = {}
    for name, sub in model.named_modules():
        if isinstance(sub, LoRALinear):
            out[name] = (sub.lora_A.detach().float().cpu().numpy(),
                         sub.lora_B.detach().float().cpu().numpy())
    if not out:
        raise ValueError("model has no LoRALinear sublayers "
                         "(apply_lora first, or load a LoRA checkpoint)")
    return out
