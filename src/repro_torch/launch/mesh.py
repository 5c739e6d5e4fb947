"""Mesh construction for the port (a copy of the JAX package's
``launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over real or forced
host devices: 16x16 = 256 chips for one pod, 2x16x16 = 512 for two. The
port's mesh by shape is a :class:`LogicalMesh`: axis names and sizes, with
``devices`` the port's device list where it has one and None for a
logical mesh. The sharding helpers (``repro_torch.models.sharding``) and
the dry run's specs read a mesh's shape only, so the production meshes
need no devices at all.

Where a step must run as a sharded program, :func:`device_mesh` turns a
:class:`LogicalMesh` into a ``torch.distributed`` ``DeviceMesh`` with the
same axis names, over the world that :func:`fake_world` starts: PyTorch's
``fake`` process-group backend, in which one process holds rank 0 of a
world of any size and every collective is a no-op. So one process, on
one card or none, runs rank 0's local program of a 16x16 or 2x16x16 mesh
(the partitioned dry run, ``repro_torch.launch.dryrun``); this is the
port's counterpart of the reference's 512 forced host devices.

Functions, not module-level state: importing this module touches no
device and starts no process group.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple


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


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A ``fake`` process group of ``world_size`` ranks with this process
    as rank 0, for the ``with`` block: started if no group is up and
    destroyed on leaving the block, so nothing stays up after it. Nested
    blocks of the same size share the outer group; a group of another
    size or backend already up raises ``RuntimeError``. Every collective
    on it returns at once and computes nothing, so no value computed
    over it means anything: only shapes, counts and bytes do."""
    import torch.distributed as dist
    if dist.is_initialized():
        backend, size = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or size != world_size:
            raise RuntimeError(f"a {backend!r} process group of {size} ranks "
                               f"is up; a fake world of {world_size} ranks "
                               f"cannot start beside it")
        yield
        return
    # the fake backend's store lives in torch's testing package; this is
    # the one place the port imports it
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(logical: LogicalMesh, device_type: str = "cpu") -> Any:
    """``logical`` as a ``DeviceMesh`` of ``device_type`` with the same
    axis names, over ranks ``0 .. logical.size - 1`` of the world that is
    up (:func:`fake_world`). The meta device's traces use ``"cpu"``: a
    mesh's device type names the collectives' backend, and a DTensor's
    local shard may live on meta."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(logical.size).reshape(logical.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=logical.axis_names)


def logical_mesh(mesh: Any) -> LogicalMesh:
    """A ``DeviceMesh``'s shape as a :class:`LogicalMesh` (what the spec
    helpers read)."""
    return LogicalMesh(tuple(int(n) for n in mesh.shape),
                       tuple(mesh.mesh_dim_names))
