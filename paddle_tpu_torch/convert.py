"""Weight bridge from the JAX package's parameter names and layouts.

The names are the same on both sides (``transformer.layers.<i>.attn.
qkv_proj.weight`` ...). One layout differs: a Paddle/JAX `Linear.weight`
is ``[in, out]`` while `torch.nn.Linear.weight` is ``[out, in]``, so
Linear weights — and only those — are transposed. Embeddings (``[V, h]``:
GPT's ``wte``/``wpe``, BERT's word, position and token-type tables) and
norm weights carry over as they are, and so do a quantized layer's
``quant_weight`` (already ``[out, in]`` int8 or packed int4) and
``quant_scale``. ResNet's convolution weights are OIHW on both sides
(4-D, unchanged), its ``fc.weight`` is a Linear (transposed), and its
BatchNorm weights and ``_mean`` / ``_variance`` buffers carry over.

Usage, with the JAX model's state as numpy arrays::

    named = {k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}
    load_jax_state(torch_model, named)
    back = state_to_jax(torch_model)     # the same names and layouts again

Training state carries over too: `optimizer_state_from_jax` turns a JAX
`Optimizer.state_dict()` (after the JAX engine's
`sync_optimizer_state()`) into the port optimizer's, and
`engine_state_from_jax` a JAX `ShardedTrainStep.state_dict()` tree into
the port engine's, the slots of a Linear weight transposed like the
weight::

    jeng.sync_optimizer_state()
    topt.set_state_dict(optimizer_state_from_jax(
        jopt.state_dict(), [n for n, _ in jax_model.named_parameters()],
        torch_model))
    teng.load_state_dict(engine_state_from_jax(jeng.state_dict()))

A LoRA model (`nn.lora.apply_lora` on both sides) carries over the same
way: a wrapper's frozen ``...qkv_proj.base.weight`` is a Linear weight and
is transposed, while its ``lora_A`` ``[in, r]`` and ``lora_B`` ``[r, out]``
have the same layout on both sides (x @ A @ B) and are not.

Serving adapters need no conversion either: a JAX adapter is ``{layer name: (A
[in, r], B [r, out])}`` keyed by the JAX model's sublayer names
(``transformer.layers.<i>.attn.qkv_proj`` ...), which are the port's module
names, and A/B have the same layout on both sides (x @ A @ B), so
`AdapterPool.load` takes it as it is (numpy or JAX arrays)::

    pool.load("tenant", jax_weights)
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_state", "state_to_jax",
           "optimizer_state_from_jax", "engine_state_from_jax"]

#: modules whose 2-D `.weight` is an embedding table, not a Linear: GPT's
#: and BERT's
_EMBEDDINGS = ("wte", "wpe", "word_embeddings", "position_embeddings",
               "token_type_embeddings")


def _is_linear_weight(name, arr):
    if not name.endswith(".weight") or np.ndim(arr) != 2:
        return False
    module = name[:-len(".weight")].rsplit(".", 1)[-1]
    return module not in _EMBEDDINGS


def params_from_jax(named_numpy):
    """{name: np.ndarray} in the JAX layouts -> {name: torch.Tensor} in
    the port's (Linear weights transposed to [out, in], contiguous)."""
    out = {}
    for name, arr in named_numpy.items():
        a = np.asarray(arr)
        if _is_linear_weight(name, a):
            a = a.T
        out[name] = torch.from_numpy(np.array(a, order="C", copy=True))
    return out


@torch.no_grad()
def load_jax_state(model, named_numpy):
    """Copy JAX weights into `model` in place (onto its device and
    dtypes). Every parameter and buffer of the model must be given, and
    nothing else; shape mismatches raise ValueError naming the tensor."""
    tensors = params_from_jax(named_numpy)
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = sorted(set(own) - set(tensors))
    extra = sorted(set(tensors) - set(own))
    if missing or extra:
        raise ValueError(f"state mismatch: missing {missing}, unexpected "
                         f"{extra}")
    for name, t in tensors.items():
        dst = own[name]
        if tuple(dst.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit "
                             f"the model's {tuple(dst.shape)}")
        dst.copy_(t.to(device=dst.device, dtype=dst.dtype))
    return model


@torch.no_grad()
def state_to_jax(model):
    """The reverse of `params_from_jax`: the model's parameters and
    buffers as {name: np.ndarray} in the JAX layouts (Linear weights
    transposed back to [in, out], embeddings as they are). Floating
    tensors come back as float32 (numpy has no bfloat16)."""
    out = {}
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    for name, t in named.items():
        t = t.detach().cpu()
        a = (t.float() if t.is_floating_point() else t).numpy()
        out[name] = np.ascontiguousarray(
            a.T if _is_linear_weight(name, a) else a)
    return out


def _numpy(v):
    """A leaf of a JAX state tree (a JAX package Tensor, a JAX or numpy
    array) as numpy; bfloat16, which torch cannot take from numpy, as
    float32 (the port casts to its own tensor's dtype on load)."""
    a = np.asarray(v.numpy() if hasattr(v, "numpy") else v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _port_layout(name, v):
    a = _numpy(v)
    if _is_linear_weight(name, a):
        a = a.T
    return torch.from_numpy(np.array(a, order="C", copy=True))


def optimizer_state_from_jax(state, names, model):
    """A JAX `Optimizer.state_dict()` (``_step_count``, ``{slot}_{i}``,
    ``LR_Scheduler``), whose i-th parameter is ``names[i]``, -> the state
    dict of the port optimizer built over ``model.parameters()``: slots
    re-indexed by the port model's parameter order, a Linear weight's
    slots transposed to [out, in]."""
    order = {n: j for j, (n, _) in enumerate(model.named_parameters())}
    out = {"_step_count": int(state.get("_step_count", 0))}
    for key, v in state.items():
        if key == "_step_count":
            continue
        if key == "LR_Scheduler":
            out[key] = dict(v)
            continue
        slot, i = key.rsplit("_", 1)
        name = names[int(i)]
        out[f"{slot}_{order[name]}"] = _port_layout(name, v)
    return out


def engine_state_from_jax(tree):
    """A JAX engine `state_dict()` tree (``model``, ``buffers``, ``opt``
    by parameter name, ``step``) -> the port engine's, for its
    `load_state_dict`."""
    out = {"model": {n: _port_layout(n, v) for n, v in tree["model"].items()},
           "buffers": {n: torch.from_numpy(np.array(_numpy(v), copy=True))
                       for n, v in tree.get("buffers", {}).items()},
           "step": int(tree.get("step", 0))}
    if "opt" in tree:
        out["opt"] = {n: {s: _port_layout(n, v) for s, v in slots.items()}
                      for n, slots in tree["opt"].items()}
    return out
