"""Mesh construction for the port (a copy of the JAX package's
``launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over real or forced
host devices: 16x16 = 256 chips for one pod, 2x16x16 = 512 for two. One
GPU has no such mesh, and ``torch.distributed``'s ``DeviceMesh`` needs a
process per device, so the port's mesh is a :class:`LogicalMesh`: axis
names and sizes, with ``devices`` the port's device list where it has one
and None for a logical mesh. The sharding helpers
(``repro_torch.models.sharding``) and the dry run
(``repro_torch.launch.dryrun``) read a mesh's shape only, so the
production meshes need no devices at all; this is the port's counterpart
of the reference's 512 forced host devices.

Functions, not module-level state: importing this module touches no
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class LogicalMesh:
    """A device mesh by shape: ``axis_sizes`` and ``axis_names`` in order
    (``LogicalMesh((16, 16), ("data", "model"))``), ``devices`` the
    devices it stands for (None for a logical mesh). ``shape`` is the
    ``{axis: size}`` mapping that ``jax.sharding.Mesh.shape`` gives."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[object, ...]] = None

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1: "
                             f"{self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"mesh {self.axis_sizes} needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry run's record key."""
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production mesh as a logical mesh: 16x16
    ``("data", "model")``, or 2x16x16 ``("pod", "data", "model")``."""
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
              ) -> LogicalMesh:
    return LogicalMesh(tuple(int(n) for n in shape), tuple(axes))


def make_host_mesh(model: Optional[int] = None) -> LogicalMesh:
    """A ``("data", "model")`` mesh over the devices this process uses:
    every card of the machine on cuda (the port's default device), one
    device on the CPU."""
    import torch

    from ..device import resolve_device
    dev = resolve_device()
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    model = model or 1
    if len(devices) % model:
        raise ValueError(f"model axis {model} does not divide "
                         f"{len(devices)} devices")
    return LogicalMesh((len(devices) // model, model), ("data", "model"),
                       devices)
