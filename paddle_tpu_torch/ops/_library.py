"""The ``paddle_tpu_torch::`` operator namespace.

The kernels that an exported program reaches are `torch.library`
operators, so that `torch.export` records them as one node each instead
of tracing into their launch (which reads data pointers and cannot run on
fake tensors) and instead of baking in whichever branch the tracing
device took. Each operator has:

* a CUDA implementation: the wrapper's launch of its hand-written kernel
  (it counts the launch);
* a CPU implementation: the kernel's plain PyTorch version;
* a fake implementation: the output shapes and dtypes, all that tracing
  needs.

An exported program that names ``paddle_tpu_torch.<op>`` therefore
dispatches by the device of its tensors when it runs, exactly as the
eager wrapper does. The public wrapper of each kernel is the operator
itself (behind the wrapper's argument checks): there is one path.

`define` also takes an optional autograd formula and a vmap rule (the
rule folds the vmapped axis into the kernel's own batch or row axis).
`jit.aot` defines one operator here that is not a kernel,
``paddle_tpu_torch::per_example``: the bucket programs' way to run one
operator of a vmapped program once per example (never exported).
"""
from __future__ import annotations

import torch

__all__ = ["NAMESPACE", "define"]

NAMESPACE = "paddle_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name, schema, *, cpu, cuda, fake, vmap=None, backward=None,
           setup_context=None):
    """Define ``paddle_tpu_torch::<name>`` with `schema` (the part after
    the name) and its implementations; returns the operator overload."""
    _LIB.define(f"{name}{schema}")
    qual = f"{NAMESPACE}::{name}"
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(qual, fake, lib=_LIB)
    if vmap is not None:
        torch.library.register_vmap(qual, vmap, lib=_LIB)
    if backward is not None:
        torch.library.register_autograd(qual, backward,
                                        setup_context=setup_context,
                                        lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
