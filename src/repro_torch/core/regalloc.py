"""Register allocation (paper §IV-D).

Post-SAT phase: for every PE, build the interference graph of the values
produced there and colour it with that PE's local registers (per-PE counts
via ``arch.regs(p)`` — heterogeneous fabrics give different PEs different
register files).

Lifetimes honour the fabric's per-op-class *latency* model: a value exists
from its producer's completion, t_n + lat(n), to its last consumption
(multi-cycle producers therefore lengthen downstream lifetimes relative to
the issue slot). Lifetimes are *cyclic* intervals on the II-cycle kernel
circle; the C3 timing window bounds every completion-relative lifetime by
II - 1, so a value never interferes with its own next-iteration instance.
With all latencies 1 every interval, bypass decision, and pressure count
below is identical to the original issue-based formulation.

Output-register bypass (the paper's Eq. 5 delivery mode): if every consumer
of a value reads it strictly before the next result lands on the producer
PE's output register, the value lives only in that output register and
needs no local register. The allocator models both modes and prefers
bypass — resolving the Eq. 4 / Eq. 5 disjunction that the SAT phase
leaves open.

Failure (any PE needs more colours than its register count) sends the
Fig. 3 loop to II+1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cgra import CGRA
from .dfg import DFG
from .schedule import node_latencies


@dataclass
class RegAllocResult:
    ok: bool
    # node -> register index on its producer PE (absent -> output-reg bypass)
    regs: Dict[int, int] = field(default_factory=dict)
    bypass: List[int] = field(default_factory=list)
    max_pressure: int = 0
    failed_pe: Optional[int] = None


def _lifetime(dfg: DFG, t: Dict[int, int], n: int, ii: int) -> int:
    """Cycles from production to last consumption (0 = no consumer)."""
    last = 0
    for s, d, delta in dfg.edges():
        if s == n:
            last = max(last, t[d] - t[n] + delta * ii)
    return last


def allocate(dfg: DFG, cgra: CGRA,
             placement: Dict[int, Tuple[int, int, int]], ii: int,
             ) -> RegAllocResult:
    t = {n: it * ii + c for n, (p, c, it) in placement.items()}
    lat = node_latencies(dfg, cgra)
    pe_of = {n: placement[n][0] for n in placement}
    # kernel-cycle occupancy per PE output register: results land at the
    # producer's *completion* cycle, issue + lat (== issue + 1 on the
    # paper's unit-latency fabric)
    writes: Dict[int, List[int]] = {}
    for n, (p, c, it) in placement.items():
        writes.setdefault(p, []).append((c + lat[n]) % ii)

    res = RegAllocResult(ok=True)
    for p in range(cgra.n_pes):
        mine = [n for n in placement if pe_of[n] == p]
        if not mine:
            continue
        wcycles = sorted(writes[p])
        intervals: Dict[int, Tuple[int, int]] = {}  # n -> (start mod II, len)
        for n in mine:
            life = _lifetime(dfg, t, n, ii)
            if life == 0:
                res.bypass.append(n)
                continue
            # completion-relative lifetime: the value exists from the
            # write at t_n + lat(n) through the last read (C3 bounds it
            # by II - 1, so it never meets its own next instance)
            life_w = max(life - lat[n], 0)
            w0 = (t[n] + lat[n]) % ii
            # gap until the next write on this PE's output register
            gap = ii  # producer itself re-writes II cycles later
            for k in range(1, ii):
                if (w0 + k) % ii in wcycles:
                    gap = k
                    break
            if life_w < gap:
                res.bypass.append(n)       # Eq. 5 delivery: output reg only
            else:
                # live [t_n+lat, t_n+life] on the kernel circle
                intervals[n] = (w0, life_w + 1)
        # cyclic-interval interference graph
        ns = list(intervals)
        adj = {n: set() for n in ns}
        for i in range(len(ns)):
            for j in range(i + 1, len(ns)):
                if _cyclic_overlap(intervals[ns[i]], intervals[ns[j]], ii):
                    adj[ns[i]].add(ns[j])
                    adj[ns[j]].add(ns[i])
        colours = _greedy_colour(ns, adj)
        pressure = max(colours.values(), default=-1) + 1
        res.max_pressure = max(res.max_pressure, pressure)
        if pressure > cgra.regs(p):
            return RegAllocResult(ok=False, max_pressure=pressure,
                                  failed_pe=p)
        res.regs.update(colours)
    return res


def _cyclic_overlap(a: Tuple[int, int], b: Tuple[int, int], ii: int) -> bool:
    """Do intervals [s, s+len) on the circle of size II overlap?"""
    (sa, la), (sb, lb) = a, b
    if la >= ii or lb >= ii:
        return True
    for base in (0,):  # unroll circle into two copies
        a0, a1 = sa, sa + la
        b0, b1 = sb, sb + lb
        for shift_a in (0, ii):
            for shift_b in (0, ii):
                lo = max(a0 + shift_a, b0 + shift_b)
                hi = min(a1 + shift_a, b1 + shift_b)
                if lo < hi:
                    return True
    return False


def _greedy_colour(ns: List[int], adj: Dict[int, set]) -> Dict[int, int]:
    """Smallest-last (degeneracy) ordering + greedy colouring."""
    order: List[int] = []
    deg = {n: len(adj[n]) for n in ns}
    alive = set(ns)
    while alive:
        n = min(alive, key=lambda x: (deg[x], x))
        order.append(n)
        alive.remove(n)
        for m in adj[n]:
            if m in alive:
                deg[m] -= 1
    colours: Dict[int, int] = {}
    for n in reversed(order):
        used = {colours[m] for m in adj[n] if m in colours}
        c = 0
        while c in used:
            c += 1
        colours[n] = c
    return colours
