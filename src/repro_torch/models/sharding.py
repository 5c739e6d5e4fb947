"""Sharding rules: logical axes -> mesh axes, and the attention head plan
(a copy of the JAX package's ``models/sharding.py``).

Mesh axes: ("pod", "data", "model") multi-pod, ("data", "model") single-pod.
Logical tensor axes used by the model code:

  batch   -> ("pod", "data")         data parallelism (+ pod axis)
  model   -> "model"                 tensor parallelism
  vocab   -> "model"
  expert  -> "model"                 expert parallelism
  fsdp    -> ("pod", "data")         weights sharded over the data axes
  None    -> replicated

A mesh is anything with ``axis_names`` and a ``{axis: size}`` ``shape``:
the port's ``repro_torch.launch.mesh.LogicalMesh`` (one card has no
``jax.sharding.Mesh``). A spec is a tuple whose entries are None, an axis
name, or a tuple of axis names, as ``jax.sharding.PartitionSpec`` holds
them (a one-axis tuple is written as the axis name, and an empty one as
None, as ``PartitionSpec`` normalises them). ``shard_shape`` gives the
per-device shape that ``NamedSharding(mesh, spec).shard_shape`` gives.
Nothing here places a tensor: the port runs on one device, and the specs
are read by the dry run (``repro_torch.launch.dryrun``) to count each
device's bytes.

Indivisible head counts are handled by the *attention plan*: q-heads are
padded (zero o_proj rows keep the function exact) and kv heads are expanded
to "virtual" heads (vLLM-style replication) so that every sharded axis is
divisible by the TP degree and all attention math stays shard-local. On one
card the plan is read at tp=1, where ``h_pad == n_heads`` and
``kv_virtual == n_kv`` for every supported architecture; the dry run reads
it at the mesh's TP degree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry(axes: Tuple[str, ...]) -> Entry:
    """A tuple of mesh axes as one spec entry, normalised as
    ``PartitionSpec`` normalises it."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def spec(mesh: Any, *axes, batch_size: Optional[int] = None) -> Spec:
    """Translate logical axes to a spec for this mesh.

    ``batch_size``: when given, the "batch" logical axis falls back to
    replicated if the size does not divide the data-parallel degree
    (e.g. the global_batch=1 long-context decode shape)."""
    out = []
    for a in axes:
        if a == "batch":
            ba: Entry = _entry(batch_axes(mesh))
            if batch_size is not None and batch_size % dp_size(mesh):
                ba = None
            out.append(ba)
        elif a in ("model", "vocab", "expert"):
            out.append("model")
        elif a == "fsdp":
            # weight sharding over the data axes (ZeRO-3 style); shares the
            # batch axes
            out.append(_entry(batch_axes(mesh)))
        elif a is None:
            out.append(None)
        else:
            raise ValueError(f"unknown logical axis {a!r}")
    return tuple(out)


def tp_size(mesh: Any) -> int:
    return mesh.shape["model"]


def dp_size(mesh: Any) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def shard_shape(shape: Tuple[int, ...], sp: Spec, mesh: Any
                ) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` laid out by ``sp``
    on ``mesh``: each dimension divided by the product of the sizes of
    the mesh axes its entry names. A dimension that those sizes do not
    divide raises ``ValueError``, as ``NamedSharding.shard_shape`` does."""
    if len(sp) > len(shape):
        raise ValueError(f"spec {sp} has more entries than shape {shape}")
    out = []
    for i, dim in enumerate(shape):
        entry = sp[i] if i < len(sp) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts = math.prod(mesh.shape[a] for a in names)
        if dim % parts:
            raise ValueError(f"spec {sp} splits axis {i} of {shape} into "
                             f"{parts} parts, which do not divide {dim}")
        out.append(dim // parts)
    return tuple(out)


@dataclass(frozen=True)
class AttnPlan:
    """Padded/virtualized head layout for a given TP degree.

    h_pad      padded q heads (multiple of tp; extra heads functionally dead)
    kv_virtual virtual kv heads materialized in weights & KV cache
               (multiple of tp or == true kv heads when replicated=1)
    group      q heads per virtual kv head (h_pad / kv_virtual)
    repl       how many times each true kv head is duplicated
    """
    n_heads: int
    n_kv: int
    h_pad: int
    kv_virtual: int
    group: int
    repl: int

    @property
    def pad_overhead(self) -> float:
        return self.h_pad / self.n_heads


def plan_attention(n_heads: int, n_kv: int, tp: int) -> AttnPlan:
    if n_heads % n_kv:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    gs = n_heads // n_kv
    # Search padded (groups g_p, group size gs_p). Original q head i lands in
    # padded slot (i//gs)*gs_p + (i%gs), so pairing with its kv head is
    # preserved; added slots/groups carry zero weights (function unchanged).
    best: Optional[Tuple[int, int, int]] = None  # (total, g_p, gs_p)
    for g_p in range(n_kv, 4 * n_kv + 1):
        for gs_p in range(gs, 4 * gs + 1):
            total = g_p * gs_p
            if total % tp:
                continue
            hps = total // tp  # q heads per shard
            # a shard must hold whole groups, or a group must span shards evenly
            if hps % gs_p and gs_p % hps:
                continue
            if best is None or total < best[0]:
                best = (total, g_p, gs_p)
    if best is None:
        raise ValueError(f"no attention plan for H={n_heads} kv={n_kv} tp={tp}")
    total, g_p, gs_p = best
    hps = total // tp
    if hps % gs_p == 0:
        # whole groups per shard: kv heads sharded directly, no replication
        kv_virtual, repl = g_p, 1
    else:
        # each group spans k shards -> replicate kv k times
        k = gs_p // hps
        kv_virtual, repl = g_p * k, k
    return AttnPlan(n_heads=n_heads, n_kv=n_kv, h_pad=total,
                    kv_virtual=kv_virtual, group=total // kv_virtual, repl=repl)


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
