"""torch.fx -> DFG frontend (the port's counterpart of the JAX package's
jaxpr frontend).

The paper extracts loop DFGs from LLVM IR via a custom pass. Here a scalar
loop body written with torch operations is traced with ``torch.fx`` and
its graph becomes a DFG. Loop-carried state becomes distance-1 back-edges;
the induction variable is the first argument.

    def body(i, acc):
        x = i * 3 + acc
        return (x ^ (x >> 2),)

    dfg, carry_map = trace_loop_body(body, n_carry=1)

The resulting DFG is executable (DFG.execute), so a mapping produced by
SAT-MapIt for it is validated against the traced function itself. Memory
ops are modelled as extra per-iteration inputs/outputs (`loads=k` appends k
load nodes passed after the carries; returned extra values become stores).

The op set is the JAX frontend's (``_PRIM_MAP``), reached from the
``operator`` and ``torch`` calls that fx records. Nodes, constants
included, are created in the order the jaxpr of the same body creates
them (a constant at its first use, operands left to right), so a torch
body and its JAX twin give DFGs with equal ``dfg_signature`` and share
the service's cache keys.
"""
from __future__ import annotations

import operator
from typing import Callable, Dict, List, Tuple

import torch
import torch.fx

from .dfg import DFG

# fx call targets -> DFG op: functions (``a + b`` is recorded as
# operator.add), and Tensor method names (``a.add(b)``)
_FN_MAP = {
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub",
    operator.mul: "mul", torch.mul: "mul",
    torch.maximum: "max", torch.minimum: "min",
    operator.and_: "and", torch.bitwise_and: "and",
    operator.or_: "or", torch.bitwise_or: "or",
    operator.xor: "xor", torch.bitwise_xor: "xor",
    operator.lshift: "shl", torch.bitwise_left_shift: "shl",
    operator.rshift: "shr", torch.bitwise_right_shift: "shr",
    torch.fmod: "rem",
    operator.lt: "lt", torch.lt: "lt",
    operator.le: "le", torch.le: "le",
    operator.eq: "eq", torch.eq: "eq",
    operator.ne: "ne", torch.ne: "ne",
    operator.gt: "lt", torch.gt: "lt",   # operands swapped below
    operator.ge: "le", torch.ge: "le",
}
_METHOD_MAP = {
    "add": "add", "sub": "sub", "mul": "mul", "maximum": "max",
    "minimum": "min", "bitwise_and": "and", "bitwise_or": "or",
    "bitwise_xor": "xor", "bitwise_left_shift": "shl",
    "bitwise_right_shift": "shr", "fmod": "rem", "lt": "lt", "le": "le",
    "eq": "eq", "ne": "ne", "gt": "lt", "ge": "le",
}
_SWAPPED = {operator.gt, torch.gt, operator.ge, torch.ge, "gt", "ge"}
_NEG = {operator.neg, torch.neg, "neg"}
_NOT = {operator.invert, torch.bitwise_not, "bitwise_not"}
_POW = {operator.pow, torch.pow, "pow"}
_WHERE = {torch.where, "where"}
# value-preserving conversions and copies: the output is the input
_ALIAS = {torch.clone, torch.squeeze, torch.reshape, "clone", "int", "long",
          "to", "type_as", "contiguous", "squeeze", "reshape", "view",
          "detach"}


def trace_loop_body(fn: Callable, n_carry: int = 0, loads: int = 0,
                    name: str = "torch_loop") -> Tuple[DFG, Dict[int, int]]:
    """Trace ``fn(i, *carries, *loaded)`` into a DFG.

    Returns (dfg, carry_map) where carry_map maps carry index -> node id of
    the value that feeds the next iteration (useful for simulation init).
    """
    graph = torch.fx.symbolic_trace(fn).graph
    inputs = [n for n in graph.nodes if n.op == "placeholder"]
    if len(inputs) != 1 + n_carry + loads:
        raise ValueError(f"{name}: the body takes {len(inputs)} arguments, "
                         f"expected 1 + {n_carry} carries + {loads} loads")
    g = DFG(name)
    env: Dict[torch.fx.Node, int] = {}
    consts: Dict[int, int] = {}

    def const_node(val) -> int:
        v = int(val)
        if v not in consts:
            consts[v] = g.add("const", imm=v, name=f"c{v}")
        return consts[v]

    # inputs: induction variable, carried values, loads
    iv = g.add("iv", name="i")
    env[inputs[0]] = iv
    pending_carry_uses: List[Tuple[int, int, int]] = []  # (node, slot, sentinel)
    for ci, var in enumerate(inputs[1:1 + n_carry]):
        env[var] = -(ci + 1)  # sentinel, patched after outputs known
    for li, var in enumerate(inputs[1 + n_carry:]):
        env[var] = g.add("load", [(iv, 0)], imm=100 * (li + 1),
                         name=f"ld{li}")

    def read(arg) -> int:
        if isinstance(arg, torch.fx.Node):
            return env[arg]
        if isinstance(arg, (bool, int)):
            return const_node(arg)
        raise NotImplementedError(f"{name}: operand {arg!r} is not a traced "
                                  f"value or an integer constant")

    def add(op: str, srcs) -> int:
        return _add_patched(g, op, [(s, 0) for s in srcs],
                            pending_carry_uses)

    out_args = None
    for node in graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            out_args = node.args[0]
            continue
        if node.op not in ("call_function", "call_method"):
            raise NotImplementedError(
                f"{name}: fx node {node.op} {node.target!r} has no CGRA "
                f"mapping (scalar loop bodies only)")
        target = node.target
        args = node.args
        if target in _ALIAS:
            env[node] = read(args[0])
            continue
        if target in _WHERE:
            # where(pred, a, b): pred -> a, as the jaxpr's select_n(pred,
            # b, a) becomes select(pred, a, b)
            c, a1, a0 = (read(x) for x in args[:3])
            nid = add("select", (c, a1, a0))
        elif target in _SWAPPED:
            a, b = (read(x) for x in args[:2])
            op = _FN_MAP.get(target) or _METHOD_MAP[target]
            nid = add(op, (b, a))
        elif target in _NEG or target in _NOT:
            nid = add("neg" if target in _NEG else "not", (read(args[0]),))
        elif target in _POW:
            a = read(args[0])
            p = args[1]
            if isinstance(p, torch.fx.Node) or int(p) != p or p < 1:
                raise NotImplementedError(f"{name}: only x ** k for a "
                                          f"constant k >= 1 maps")
            nid = a
            for _ in range(int(p) - 1):
                nid = add("mul", (nid, a))
        elif target in _FN_MAP or (node.op == "call_method"
                                   and target in _METHOD_MAP):
            op = _FN_MAP[target] if node.op == "call_function" \
                else _METHOD_MAP[target]
            nid = add(op, [read(x) for x in args[:2]])
        else:
            raise NotImplementedError(
                f"{name}: {getattr(target, '__name__', target)!r} has no "
                f"CGRA mapping (scalar loop bodies only; matmul-shaped "
                f"compute is not a modulo-scheduling target)")
        env[node] = nid

    # outputs: first n_carry are next-iteration carries, rest are stores
    outs = out_args if isinstance(out_args, (tuple, list)) else (out_args,)
    out_nodes = [read(x) for x in outs]
    carry_map: Dict[int, int] = {}
    for ci in range(n_carry):
        src = out_nodes[ci]
        if src < 0:  # pass-through carry: route it
            src = g.add("route", [(iv, 0)], name=f"carry{ci}_rt")
        carry_map[ci] = src
    # patch carried uses with distance-1 back-edges
    for nid, slot, sentinel in pending_carry_uses:
        ci = -sentinel - 1
        ins = list(g.nodes[nid].ins)
        ins[slot] = (carry_map[ci], 1)
        g.nodes[nid].ins = tuple(ins)
        g.touch()
    # stores for non-carry outputs
    for si, nid in enumerate(out_nodes[n_carry:]):
        if nid < 0:
            nid = carry_map[-nid - 1]
        g.add("store", [(iv, 0), (nid, 0)], imm=1000 * (si + 1),
              name=f"st{si}")
    g.validate()
    return g, carry_map


def _add_patched(g: DFG, op: str, ins, pending) -> int:
    """g.add that tolerates carry sentinels (negative ids) in ins."""
    clean = []
    patches = []
    for slot, (src, dist) in enumerate(ins):
        if src < 0:
            patches.append((slot, src))
            clean.append((0, 0))  # temporary: node 0 always exists (iv)
        else:
            clean.append((src, dist))
    nid = g.add(op, clean)
    for slot, sentinel in patches:
        pending.append((nid, slot, sentinel))
    return nid
