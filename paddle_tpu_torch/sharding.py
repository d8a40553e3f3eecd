"""Meshes of the port (counterpart of paddle_tpu/sharding/mesh.py's
`MeshConfig`).

The JAX package builds one global device mesh and lets GSPMD place every
array on it. The port runs one process per rank, the way PyTorch writes
SPMD code: `MeshConfig(cp=n).build()` is called in every rank of a
`torch.distributed` job of n processes and returns that rank's `Mesh` —
its process group, its rank, its device and the transport its collectives
go through (`distributed._ring.Transport`). Only the context-parallel
axis is ported: ``dp``, ``fsdp`` or ``tp`` above 1, ``dcn_dp`` and extra
axes (``sep``) raise `NotImplementedError` (ROADMAP Queue 1, item 8: more
than one device).

The mesh is the port's own small object, not a `torch.distributed.
DeviceMesh`: a DeviceMesh names one device type for the whole job and
maps rank r to device r % count, while the ring needs only a group, a
rank and a device — and the smoke run puts two ranks on one card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import resolve_device

__all__ = ["MeshConfig", "Mesh"]

_LATER = ("is not ported yet: the port's meshes have one axis, cp "
          "(ROADMAP Queue 1, item 8: more than one device)")


class Mesh:
    """One rank's view of a context-parallel mesh: ``size`` n (the cp
    axis), ``rank``, ``device``, ``group`` (the process group, None
    when n == 1) and ``transport`` (None when n == 1)."""

    def __init__(self, cp, device, group=None):
        self.size = int(cp)
        self.device = device
        self.group = group
        self.transport = None
        self.rank = 0
        if self.size > 1:
            from .distributed._ring import Transport

            self.transport = Transport(group, device)
            self.rank = self.transport.rank

    def __repr__(self):
        return (f"Mesh(cp={self.size}, rank={self.rank}, "
                f"device={self.device})")


@dataclass
class MeshConfig:
    """Declarative axis sizes, the JAX package's fields; only ``cp`` may
    be other than 1."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    cp: int = 1
    dcn_dp: int = 1
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        for name in ("dp", "fsdp", "tp", "cp", "dcn_dp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name}={v!r}: axis sizes are positive "
                                 f"ints in the port (-1 absorbs nothing "
                                 f"here)")

    def build(self, device=None, group=None):
        """This rank's `Mesh`. cp > 1 needs an initialised
        `torch.distributed` job whose group (default: the world) has cp
        ranks; `device` defaults to the GPU."""
        for name in ("dp", "fsdp", "tp", "dcn_dp"):
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"MeshConfig({name}={getattr(self, name)}) " + _LATER)
        if self.extra:
            raise NotImplementedError(f"extra mesh axes {self.extra} "
                                      + _LATER)
        device = resolve_device(device)
        if self.cp == 1:
            return Mesh(1, device)
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                f"MeshConfig(cp={self.cp}).build() runs in each of "
                f"{self.cp} ranks of a torch.distributed job: call "
                f"torch.distributed.init_process_group first")
        group = group or dist.group.WORLD
        world = dist.get_world_size(group)
        if world != self.cp:
            raise ValueError(f"cp={self.cp} but the process group has "
                             f"{world} ranks")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return Mesh(self.cp, device, group)
