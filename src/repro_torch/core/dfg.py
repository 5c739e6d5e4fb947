"""Data Flow Graph: the mapper's input IR.

Nodes are single-output operations; edges carry a loop-carried *distance*
(0 = intra-iteration dependency, d>=1 = value produced d iterations earlier,
i.e. a back-edge). The DFG is executable (``execute``) — that execution is
the ground-truth oracle against which every CGRA mapping is validated by the
simulator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np

# Ops with value semantics used by the executable oracle. All 1-cycle on the
# CGRA ALU (paper model).
_BINOPS: Dict[str, Callable[[int, int], int]] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "shl": lambda a, b: a << (b & 63),
    "shr": lambda a, b: (a % (1 << 64)) >> (b & 63),
    "min": min,
    "max": max,
    "lt": lambda a, b: int(a < b),
    "le": lambda a, b: int(a <= b),
    "eq": lambda a, b: int(a == b),
    "ne": lambda a, b: int(a != b),
    "div": lambda a, b: a // b if b else 0,
    "rem": lambda a, b: a % b if b else 0,
}
_MASK64 = (1 << 64) - 1


def _wrap(v: int) -> int:
    """Two's-complement wrap to signed 64-bit (keeps python ints bounded)."""
    v &= _MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Node:
    id: int
    op: str
    # dataflow inputs: (src node id, loop-carried distance)
    ins: Tuple[Tuple[int, int], ...] = ()
    imm: int = 0          # payload for 'const'; base address for load/store
    name: str = ""

    @property
    def is_mem(self) -> bool:
        return self.op in ("load", "store")


class DFG:
    def __init__(self, name: str = "dfg"):
        self.name = name
        self.nodes: Dict[int, Node] = {}
        # memoized canonical signatures (used by the mapping service): computed
        # from scratch they walk every node and edge, which dominates the
        # cache-lookup path of a hot mapping service. Any structural
        # mutation must invalidate — add() does so itself; direct edits of
        # ``node.ins`` (back-edge patching, route splicing) must call
        # ``touch()``.
        self._sig_cache: Dict[Tuple, Tuple] = {}

    # ---------------------------------------------------------------- build
    def add(self, op: str, ins: Sequence[Tuple[int, int]] = (), imm: int = 0,
            name: str = "") -> int:
        nid = len(self.nodes)
        for src, dist in ins:
            if src not in self.nodes:
                raise ValueError(f"unknown source node {src}")
            if dist < 0:
                raise ValueError("negative edge distance")
        self.nodes[nid] = Node(nid, op, tuple(tuple(e) for e in ins), imm, name)
        self._sig_cache.clear()
        return nid

    def touch(self) -> None:
        """Invalidate memoized signatures after in-place node mutation."""
        self._sig_cache.clear()

    def __deepcopy__(self, memo):
        import copy as _copy
        g = DFG(self.name)
        memo[id(self)] = g
        g.nodes = _copy.deepcopy(self.nodes, memo)
        return g   # fresh empty _sig_cache: copies are usually mutated next

    # --------------------------------------------------------------- views
    @property
    def n(self) -> int:
        return len(self.nodes)

    def edges(self) -> List[Tuple[int, int, int]]:
        """(src, dst, distance) triples."""
        out = []
        for node in self.nodes.values():
            for src, dist in node.ins:
                out.append((src, node.id, dist))
        return out

    def forward_edges(self) -> List[Tuple[int, int]]:
        return [(s, d) for s, d, dist in self.edges() if dist == 0]

    def succs(self, nid: int, *, forward_only: bool = True) -> List[int]:
        return [d for s, d, dist in self.edges()
                if s == nid and (dist == 0 or not forward_only)]

    def preds(self, nid: int, *, forward_only: bool = True) -> List[int]:
        return [s for s, dist in self.nodes[nid].ins
                if dist == 0 or not forward_only]

    def topo_order(self) -> List[int]:
        """Topological order over forward (distance-0) edges."""
        indeg = {i: 0 for i in self.nodes}
        for s, d in self.forward_edges():
            indeg[d] += 1
        ready = sorted(i for i, k in indeg.items() if k == 0)
        order: List[int] = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for s, d in self.forward_edges():
                if s == nid:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        ready.append(d)
        if len(order) != self.n:
            raise ValueError(f"{self.name}: forward edges contain a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()  # raises on forward cycles
        for node in self.nodes.values():
            if node.op in _BINOPS and len(node.ins) != 2:
                raise ValueError(f"{node.op} node {node.id} needs 2 inputs")
            if node.op == "select" and len(node.ins) != 3:
                raise ValueError(f"select node {node.id} needs 3 inputs")
            if node.op in ("route", "not", "neg") and len(node.ins) != 1:
                raise ValueError(f"{node.op} node {node.id} needs 1 input")

    # ------------------------------------------------------------- execute
    def execute(self, n_iters: int, mem: Dict[int, int] | None = None,
                init: Dict[int, int] | None = None,
                ) -> Tuple[List[Dict[int, int]], Dict[int, int]]:
        """Reference loop execution: ``n_iters`` iterations of the body.

        Returns (per-iteration node values, final memory). ``init[nid]`` seeds
        loop-carried reads that reach before iteration 0 (defaults 0).
        """
        mem = dict(mem or {})
        init = init or {}
        order = self.topo_order()
        hist: List[Dict[int, int]] = []
        for it in range(n_iters):
            vals: Dict[int, int] = {}
            for nid in order:
                node = self.nodes[nid]
                args = []
                for src, dist in node.ins:
                    if dist == 0:
                        args.append(vals[src])
                    elif it - dist >= 0:
                        args.append(hist[it - dist][src])
                    else:
                        args.append(init.get(src, 0))
                vals[nid] = _wrap(self._eval(node, args, it, mem))
            hist.append(vals)
        return hist, mem

    def _eval(self, node: Node, args: List[int], it: int,
              mem: Dict[int, int]) -> int:
        op = node.op
        if op in _BINOPS:
            return _BINOPS[op](args[0], args[1])
        if op == "const":
            return node.imm
        if op == "iv":
            return it
        if op in ("route", "phi"):
            return args[0]
        if op == "not":
            return ~args[0]
        if op == "neg":
            return -args[0]
        if op == "select":
            return args[1] if args[0] else args[2]
        if op == "load":
            return mem.get(node.imm + (args[0] if args else 0), 0)
        if op == "store":
            mem[node.imm + args[0]] = args[1]
            return args[1]
        raise ValueError(f"unknown op {op!r}")

    def __repr__(self) -> str:  # pragma: no cover
        return f"DFG({self.name}, n={self.n}, edges={len(self.edges())})"


def running_example() -> DFG:
    """The paper's running example (Fig. 2a), reconstructed so that the
    ASAP/ALAP/MS tables of Fig. 4 are reproduced exactly (11 nodes, critical
    path 5, ResMII 3 on a 2x2 CGRA -> II=3 as in Fig. 2b/2c). A distance-1
    back-edge (11 -> 10) gives it a loop-carried dependency as in Fig. 2a.
    Node ids here are 0-based (paper's are 1-based)."""
    g = DFG("running_example")
    n1 = g.add("iv", name="n1")                      # paper node 1
    n2 = g.add("const", imm=3, name="n2")            # paper node 2
    n3 = g.add("const", imm=7, name="n3")            # paper node 3
    n4 = g.add("const", imm=11, name="n4")           # paper node 4
    n5 = g.add("add", [(n3, 0), (n3, 0)], name="n5")   # paper node 5
    n7 = g.add("mul", [(n4, 0), (n4, 0)], name="n7")   # paper node 7
    n10 = g.add("add", [(n1, 0), (n1, 0)], name="n10")  # paper node 10
    n6 = g.add("xor", [(n5, 0), (n5, 0)], name="n6")   # paper node 6
    n11_in = n10
    n11 = g.add("add", [(n2, 0), (n11_in, 0)], name="n11")  # paper node 11
    n8 = g.add("add", [(n6, 0), (n7, 0)], name="n8")   # paper node 8
    n9 = g.add("mul", [(n8, 0), (n8, 0)], name="n9")   # paper node 9
    # loop-carried: node 10 also accumulates node 11 from previous iteration
    g.nodes[n10].ins = ((n1, 0), (n11, 1))
    g.touch()
    g.validate()
    return g
