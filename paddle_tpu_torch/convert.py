"""Weight bridge from the JAX package's parameter names and layouts.

The names are the same on both sides (``transformer.layers.<i>.attn.
qkv_proj.weight`` ...). One layout differs: a Paddle/JAX `Linear.weight`
is ``[in, out]`` while `torch.nn.Linear.weight` is ``[out, in]``, so
Linear weights — and only those — are transposed. Embeddings (``[V, h]``)
and norm weights carry over as they are, and so do a quantized layer's
``quant_weight`` (already ``[out, in]`` int8 or packed int4) and
``quant_scale``.

Usage, with the JAX model's state as numpy arrays::

    named = {k: np.asarray(v.numpy()) for k, v in jax_model.state_dict().items()}
    load_jax_state(torch_model, named)
    back = state_to_jax(torch_model)     # the same names and layouts again
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_state", "state_to_jax"]

#: modules whose 2-D `.weight` is an embedding table, not a Linear
_EMBEDDINGS = ("wte", "wpe")


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
