"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors the module paths of `paddle_tpu` (`models/gpt.py`,
`nn/quant.py`, `inference/decode/engine.py`, ...) so each piece has an
obvious counterpart, and keeps PyTorch idiom inside: `nn.Module`s, plain
tensor functions, explicit `device=` and explicit `torch.Generator`s.

Entry points run on the GPU. A constructor that is given no `device`
resolves to ``"cuda"`` and raises when no GPU is present; the CPU is used
only when the caller passes ``device="cpu"`` (the parity tests do). Kernel
wrappers dispatch on the device of the tensors they are given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises — there is no silent fallback.

The package never imports `jax` or `paddle_tpu`.
"""
from __future__ import annotations

import torch

from . import amp

__version__ = "0.1.0"

__all__ = ["amp", "jit", "resolve_device", "__version__"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a visible GPU raises
    `RuntimeError`; pass ``device="cpu"`` to run on the CPU on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA GPU by default and none is "
            "visible (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from . import jit  # noqa: E402  (jit.load resolves its device here)
