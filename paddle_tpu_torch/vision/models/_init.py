"""The vision models' shared construction argument: the device they are
built on and the generator their weights are drawn from."""
from __future__ import annotations

import torch

from ... import resolve_device


def init_kwargs(device=None, seed=0, generator=None):
    """{device, generator} for the layers of one model: `device` resolved
    (the GPU by default, raising without one; ``"cpu"`` on request), and
    `generator`, or else one on that device seeded with `seed`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    return dict(device=dev, generator=generator)
