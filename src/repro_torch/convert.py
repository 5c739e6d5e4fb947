"""Carry state between the JAX package and the port, by plain data only.

The mapper has no weights: what crosses over is the input DFG and the
walk's packed clause tensors. Both functions here are duck-typed — they
read plain attributes and arrays and never import ``repro`` — so the
parity tests can feed the two packages identical inputs, and a later slice
can carry a corpus of DFGs across.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .core.dfg import DFG
from .core.sat.walksat_torch import PackedCNF


def dfg_from_arrays(name: str, ops: Sequence[str], imms: Sequence[int],
                    edges: Sequence[Tuple[int, int, int, int]],
                    node_names: Optional[Sequence[str]] = None) -> DFG:
    """A port :class:`DFG` with nodes ``0..n-1`` (``ops[i]``, ``imms[i]``)
    and ``edges`` as ``(src, dst, slot, distance)``: input ``slot`` of node
    ``dst`` reads ``src`` from ``distance`` iterations earlier. Inputs are
    set once every node exists, so back-edges may point forward; the
    result passes ``DFG.validate``."""
    n = len(ops)
    if len(imms) != n or (node_names is not None and len(node_names) != n):
        raise ValueError("dfg_from_arrays: ops, imms and node_names differ "
                         "in length")
    ins = [dict() for _ in range(n)]
    for src, dst, slot, dist in edges:
        if not (0 <= src < n and 0 <= dst < n) or slot in ins[dst]:
            raise ValueError(f"dfg_from_arrays: bad edge {(src, dst, slot)}")
        ins[dst][slot] = (int(src), int(dist))
    g = DFG(name)
    for i in range(n):
        g.add(str(ops[i]), (), int(imms[i]),
              str(node_names[i]) if node_names is not None else "")
    for i in range(n):
        slots = sorted(ins[i])
        if slots != list(range(len(slots))):
            raise ValueError(f"dfg_from_arrays: node {i} has input slots "
                             f"{slots}, expected 0..{len(slots) - 1}")
        if any(d < 0 for _, d in ins[i].values()):
            raise ValueError(f"dfg_from_arrays: negative distance into {i}")
        g.nodes[i].ins = tuple(ins[i][s] for s in slots)
    g.touch()
    g.validate()
    return g


def dfg_from_graph(src) -> DFG:
    """Copy any DFG-shaped object (``.name`` and ``.nodes``, a dict of
    nodes with ``.id``, ``.op``, ``.ins``, ``.imm``, ``.name``) into a port
    :class:`DFG` through :func:`dfg_from_arrays`."""
    nodes = [src.nodes[i] for i in sorted(src.nodes)]
    if [nd.id for nd in nodes] != list(range(len(nodes))):
        raise ValueError("dfg_from_graph: node ids must be 0..n-1")
    edges = [(s, nd.id, slot, d) for nd in nodes
             for slot, (s, d) in enumerate(nd.ins)]
    return dfg_from_arrays(src.name, [nd.op for nd in nodes],
                           [nd.imm for nd in nodes], edges,
                           [nd.name for nd in nodes])


def window_from_numpy(pack, device) -> PackedCNF:
    """The port's :class:`PackedCNF` on ``device`` from a stacked numpy
    window pack (anything with ``cvars``/``csign`` [K,C,L], ``ovars``/
    ``osign`` [K,V+1,O], ``n_vars`` and ``n_clauses``)."""
    cvars = np.asarray(pack.cvars)
    ovars = np.asarray(pack.ovars)
    if cvars.ndim != 3 or ovars.ndim != 3 \
            or ovars.shape[1] != int(pack.n_vars) + 1 \
            or cvars.shape[1] != int(pack.n_clauses):
        raise ValueError(f"window_from_numpy: shapes cvars {cvars.shape}, "
                         f"ovars {ovars.shape} do not fit n_vars="
                         f"{pack.n_vars}, n_clauses={pack.n_clauses}")

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return PackedCNF(t(cvars, np.int32), t(pack.csign, bool),
                     t(ovars, np.int32), t(pack.osign, bool),
                     int(pack.n_vars), int(pack.n_clauses))


def assign_from_numpy(assign, packed: PackedCNF) -> torch.Tensor:
    """Chain assignments [K,B,V+1] bool on ``packed``'s device."""
    a = np.asarray(assign)
    if a.ndim != 3 or a.shape[0] != packed.cvars.shape[0] \
            or a.shape[2] != packed.n_vars + 1:
        raise ValueError(f"assign_from_numpy: shape {a.shape} does not fit "
                         f"a window of {packed.cvars.shape[0]} CNFs over "
                         f"{packed.n_vars} vars")
    return torch.from_numpy(np.array(a, bool)).to(
        packed.cvars.device)
