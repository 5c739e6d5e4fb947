"""Cycle-level CGRA simulator — the ground-truth oracle for mappings.

Given a placement {node: (pe, cycle, iteration)} at a given II, this module
  1. statically checks the mapping invariants (C1/C2/C3 semantics:
     single placement, one node per (PE, kernel cycle), neighbour adjacency,
     and the non-rotating-register timing window — under the fabric's
     per-op-class *latency* model: an edge s->d with loop distance delta
     must satisfy lat(s) <= t_d - t_s + delta*II <= II + lat(s) - 1, the
     consumer issuing no earlier than the producer's result exists and no
     later than the producer's next kernel instance rewrites it), and
  2. *executes* the modulo schedule: instance (n, i) of node n for loop
     iteration i issues at absolute cycle i*II + t_n on PE p_n and
     completes lat(n) cycles later; memory ops commit in absolute
     *completion* order. The resulting per-iteration values and final
     memory are compared against ``DFG.execute`` — a mapping is correct
     iff pipelined execution is observationally equal to sequential
     execution. (All latencies 1 — the paper's fabric — reproduces the
     original checks and memory order exactly.)

Also emits prolog / kernel / epilog instruction tables (paper Fig. 2b/2c).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .arch import op_class
from .cgra import CGRA
from .dfg import DFG
from .schedule import node_latencies


@dataclass
class MappingCheck:
    ok: bool
    errors: List[str] = field(default_factory=list)


@dataclass
class KernelCode:
    ii: int
    n_stages: int
    # kernel[c][pe] = node id or None
    kernel: List[List[Optional[int]]]
    prolog: List[List[Optional[Tuple[int, int]]]]   # rows of (node, iter)
    epilog_stages: int

    def render(self, dfg: DFG) -> str:
        def cell(x):
            if x is None:
                return "    ."
            nid = x if isinstance(x, int) else x[0]
            return f"{(dfg.nodes[nid].name or 'n%d' % nid):>5}"
        lines = [f"II={self.ii} stages={self.n_stages}", "-- kernel --"]
        for c, row in enumerate(self.kernel):
            lines.append(f"c{c}: " + " ".join(cell(x) for x in row))
        return "\n".join(lines)


def static_check(dfg: DFG, cgra: CGRA, placement: Dict[int, Tuple[int, int, int]],
                 ii: int) -> MappingCheck:
    errs: List[str] = []
    if set(placement) != set(dfg.nodes):
        errs.append("placement does not cover all nodes")
        return MappingCheck(False, errs)
    lat = node_latencies(dfg, cgra)
    slots: Dict[Tuple[int, int], int] = {}
    wslots: Dict[Tuple[int, int], int] = {}
    for n in sorted(placement):
        p, c, it = placement[n]
        if not (0 <= p < cgra.n_pes):
            errs.append(f"node {n}: bad PE {p}")
        if not (0 <= c < ii):
            errs.append(f"node {n}: kernel cycle {c} outside [0,{ii})")
        if not cgra.can_execute(p, dfg.nodes[n].op):
            errs.append(f"{op_class(dfg.nodes[n].op)} node {n} "
                        f"({dfg.nodes[n].op}) on incapable PE {p}")
        key = (p, c)
        if key in slots:
            errs.append(f"PE/cycle clash: nodes {slots[key]} and {n} at {key}")
        slots[key] = n
        # output-register write port: two mixed-latency nodes on one PE
        # may issue in different cycles yet *complete* in the same one —
        # a simultaneous double write no real fabric supports (with equal
        # latencies this is subsumed by the issue-slot clash above)
        wkey = (p, (c + lat[n]) % ii)
        if wkey in wslots and placement[wslots[wkey]][1] != c:
            errs.append(f"output-register write clash: nodes "
                        f"{wslots[wkey]} and {n} on PE {p} both complete "
                        f"at kernel cycle {wkey[1]}")
        wslots[wkey] = n
    t = {n: it * ii + c for n, (p, c, it) in placement.items()}
    for s, d, delta in dfg.edges():
        ps, pd = placement[s][0], placement[d][0]
        if not cgra.reachable(ps, pd):
            errs.append(f"edge {s}->{d}: PEs {ps},{pd} not adjacent")
        # the consumer may not issue before the producer's result exists
        # (lat(s) cycles after its issue) nor after the producer's next
        # kernel instance rewrites it; lat == 1 is the paper's [1, II]
        span = t[d] - t[s] + delta * ii
        lo, hi = lat[s], ii + lat[s] - 1
        if not (lo <= span <= hi):
            errs.append(
                f"edge {s}->{d} (dist {delta}, lat {lat[s]}): span {span} "
                f"outside [{lo},{hi}] (t_s={t[s]}, t_d={t[d]})")
    return MappingCheck(not errs, errs)


def execute_mapping(dfg: DFG, cgra: CGRA,
                    placement: Dict[int, Tuple[int, int, int]], ii: int,
                    n_iters: int, mem: Dict[int, int] | None = None,
                    init: Dict[int, int] | None = None,
                    ) -> Tuple[List[Dict[int, int]], Dict[int, int]]:
    """Execute the pipelined schedule. Memory ops commit in absolute
    *completion*-cycle order, issue + lat(n) (ties: iteration, node id) —
    this is what the hardware would do, and what exposes illegal
    reordering w.r.t. sequential semantics. With unit latencies every
    completion is issue + 1, i.e. exactly the original issue order."""
    mem = dict(mem or {})
    init = init or {}
    t = {n: it * ii + c for n, (p, c, it) in placement.items()}
    lat = node_latencies(dfg, cgra)
    # absolute completion order of (cycle, iteration, node)
    sched = sorted((i * ii + t[n] + lat[n], i, n)
                   for i in range(n_iters) for n in dfg.nodes)
    vals: List[Dict[int, int]] = [dict() for _ in range(n_iters)]
    for _, i, n in sched:
        node = dfg.nodes[n]
        args = []
        for src, dist in node.ins:
            j = i - dist
            if j >= 0:
                args.append(vals[j][src])
            else:
                args.append(init.get(src, 0))
        from .dfg import _wrap
        vals[i][n] = _wrap(dfg._eval(node, args, i, mem))
    return vals, mem


def verify_mapping(dfg: DFG, cgra: CGRA,
                   placement: Dict[int, Tuple[int, int, int]], ii: int,
                   n_iters: int = 6, mem: Dict[int, int] | None = None,
                   init: Dict[int, int] | None = None,
                   node_subset: Optional[set] = None) -> MappingCheck:
    """Static checks + observational equivalence with sequential execution.

    ``node_subset``: compare only these nodes' values (used when routing
    nodes were inserted — they have no counterpart in the original DFG)."""
    chk = static_check(dfg, cgra, placement, ii)
    if not chk.ok:
        return chk
    seq_vals, seq_mem = dfg.execute(n_iters, mem=mem, init=init)
    pip_vals, pip_mem = execute_mapping(dfg, cgra, placement, ii, n_iters,
                                        mem=mem, init=init)
    errs: List[str] = []
    nodes = node_subset if node_subset is not None else set(dfg.nodes)
    for i in range(n_iters):
        for n in nodes:
            if seq_vals[i][n] != pip_vals[i][n]:
                errs.append(f"iter {i} node {n}: "
                            f"seq={seq_vals[i][n]} pipelined={pip_vals[i][n]}")
    if seq_mem != pip_mem:
        errs.append(f"final memory differs: {seq_mem} vs {pip_mem}")
    return MappingCheck(not errs, errs[:20])


def emit_code(dfg: DFG, cgra: CGRA,
              placement: Dict[int, Tuple[int, int, int]], ii: int) -> KernelCode:
    t = {n: it * ii + c for n, (p, c, it) in placement.items()}
    lat = node_latencies(dfg, cgra)
    # stages cover through the last *completion* (== last issue + 1 on the
    # paper's unit-latency fabric)
    length = max(t[n] + lat[n] for n in t)
    n_stages = -(-length // ii)
    kernel: List[List[Optional[int]]] = [
        [None] * cgra.n_pes for _ in range(ii)]
    for n, (p, c, it) in placement.items():
        kernel[c][p] = n
    # prolog: absolute cycles 0 .. (n_stages-1)*II - 1 over iterations 0..
    prolog: List[List[Optional[Tuple[int, int]]]] = []
    for abs_c in range((n_stages - 1) * ii):
        row: List[Optional[Tuple[int, int]]] = [None] * cgra.n_pes
        for n, (p, c, it) in placement.items():
            for i in range(n_stages):
                if i * ii + t[n] == abs_c:
                    row[p] = (n, i)
        prolog.append(row)
    return KernelCode(ii=ii, n_stages=n_stages, kernel=kernel, prolog=prolog,
                      epilog_stages=n_stages - 1)
