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

The host world is the reference's host mesh made real: where the
reference trains and serves on ``make_host_mesh()`` (every device of the
host, one process), the port runs one rank a card over a real process
group, NCCL on cuda and gloo on the CPU. :func:`host_world` joins the
world that ``torch.distributed.run`` (torchrun) or :func:`launch` started
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and yields the ``DeviceMesh`` of the host mesh's shape
over it; :func:`launch` starts ``n`` ranks of this host through torch's
elastic launch API, the one torchrun drives. A command started plainly on
a host of several cards starts one rank a card so (:func:`host_ranks`,
``launch.train.main``, ``launch.serve.main``); on one card it runs on the
card without a process group.

Functions, not module-level state: importing this module touches no
device and starts no process group.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


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


def make_host_mesh(model: Optional[int] = None,
                   n_devices: Optional[int] = None) -> LogicalMesh:
    """A ``("data", "model")`` mesh over the devices of this host: every
    card of the machine on cuda (the port's default device), one device
    on the CPU; ``n_devices`` (the ranks of a host world) takes the first
    ``n_devices`` cards, or as many CPU ranks."""
    import torch

    from ..device import resolve_device
    dev = resolve_device()
    n = n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                      else 1)
    devices = tuple(torch.device("cuda", i) for i in range(n)) \
        if dev.type == "cuda" else (dev,) * n
    model = model or 1
    if len(devices) % model:
        raise ValueError(f"model axis {model} does not divide "
                         f"{len(devices)} devices")
    return LogicalMesh((len(devices) // model, model), ("data", "model"),
                       devices)


# ------------------------------------------------------------ host world
def world_env() -> Optional[Tuple[int, int, int]]:
    """``(rank, world size, local rank)`` of the world that
    ``torch.distributed.run`` or :func:`launch` started this process in,
    from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; None for a process
    started plainly."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(
        os.environ.get("LOCAL_RANK", rank))


def host_ranks() -> int:
    """The ranks the host runs: the world's size inside a world, else one
    a card on cuda (the port's default device) and one on the CPU."""
    import torch

    from ..device import resolve_device
    env = world_env()
    if env is not None:
        return env[1]
    return torch.cuda.device_count() if resolve_device().type == "cuda" \
        else 1


# Bound on each collective of a host world: a checkpoint's gather of a
# full-width leaf and the first step's compiles both fit well inside it.
HOST_WORLD_TIMEOUT_S = 1800.0


@contextlib.contextmanager
def host_world(n_ranks: Optional[int] = None) -> Iterator[Any]:
    """Join the world of this host's ranks for the ``with`` block and yield
    its ``DeviceMesh``: :func:`make_host_mesh`'s shape over the world's
    ranks, ``(world, 1)`` with axes ("data", "model"). The
    world is the one ``torch.distributed.run`` or :func:`launch` started
    (read from the environment); ``n_ranks``, where given, must be its
    size. On cuda (the port's default device) the backend is NCCL and
    the rank takes card ``LOCAL_RANK`` (``torch.cuda.set_device``); on
    the CPU it is gloo. Nothing falls back: a backend that does not come
    up raises, as does a process that is no rank of a world, or any
    process group already up (a ``fake`` one included: the host world
    cannot start beside it, as :func:`fake_world` cannot beside this).
    The group is destroyed on leaving the block; each collective is
    bounded by ``HOST_WORLD_TIMEOUT_S``."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()!r} process group of "
                           f"{dist.get_world_size()} ranks is up; a host "
                           f"world cannot start beside it")
    env = world_env()
    if env is None:
        raise RuntimeError("host_world: this process is no rank of a world "
                           "(RANK and WORLD_SIZE are unset); start the "
                           "ranks with torch.distributed.run or "
                           "repro_torch.launch.mesh.launch")
    rank, world, local = env
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"host_world: {n_ranks} ranks asked for, the "
                         f"world has {world}")
    dev = resolve_device()
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: local rank {local} has no "
                               f"card ({torch.cuda.device_count()} here)")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(
                                seconds=HOST_WORLD_TIMEOUT_S))
    try:
        logical = make_host_mesh(n_devices=world)
        yield device_mesh(logical, dev.type)
    finally:
        dist.destroy_process_group()


def data_shard(mesh: Any) -> Tuple[int, int]:
    """``(shard, n_shards)``: this rank's index along the mesh's data axes
    and their product, the split of each batch that DTensor's
    ``Shard(0)`` over those axes gives it; ``(0, 1)`` without a mesh."""
    if mesh is None:
        return 0, 1
    shard, n = 0, 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in ("pod", "data"):
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return shard, n


def mesh_device(mesh: Any) -> Any:
    """The device of this rank's shards on ``mesh``: its current card on a
    cuda mesh, else the CPU."""
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_rank0(mesh: Any = None) -> bool:
    """Whether this process speaks for the world: rank 0 of the world up
    under ``mesh``, or any process without one."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _rank_main(device: str, entry: Callable[..., Any], args: Tuple) -> Any:
    """A launched rank: the parent's device setting, then ``entry``."""
    from ..device import set_default_device
    set_default_device(device)
    return entry(*args)


def launch(entry: Callable[..., Any], args: Tuple = (),
           n_ranks: Optional[int] = None) -> Dict[int, Any]:
    """Start ``n_ranks`` ranks of this host (default :func:`host_ranks`)
    through torch's elastic launch API, the one ``torch.distributed.run``
    drives, with a rendezvous on ``127.0.0.1`` (the loopback address, not
    the name ``localhost``, so that c10d looks up no peer's host name);
    each rank is a spawned process, on the caller's default device, that
    runs ``entry(*args)`` (a module-level function: it is pickled) and
    joins the world with
    :func:`host_world`. Waits for every rank and returns ``{rank: entry's
    return value}``; a rank that fails raises ``ChildFailedError`` here
    once the others are stopped. No process group is started in the
    calling process."""
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    from ..device import get_default_device
    n = n_ranks or host_ranks()
    cfg = LaunchConfig(min_nodes=1, max_nodes=1, nproc_per_node=n,
                       run_id=f"repro-{uuid.uuid4().hex}",
                       rdzv_backend="c10d", rdzv_endpoint="127.0.0.1:0",
                       local_addr="127.0.0.1", max_restarts=0,
                       start_method="spawn")
    return elastic_launch(cfg, _rank_main)(get_default_device(), entry,
                                           tuple(args))


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
