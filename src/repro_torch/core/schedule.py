"""ASAP / ALAP / Mobility Schedule / Kernel Mobility Schedule (paper §IV-B).

The KMS is the paper's custom structure: the Mobility Schedule folded by II.
A node whose mobility window is [asap, alap] has one KMS *candidate* per time
slot t in that window, encoded as (cycle = t mod II, iteration = t // II).
The KMS is "a superset of all possible kernels".

Timing model: every function here accepts per-node latencies (``lat``, a
{node id: cycles} mapping from :func:`node_latencies`; ``None`` = the
paper's all-unit model). A producer issued at t delivers its result at
t + lat, so ASAP/ALAP windows stretch, RecMII sums true latencies around
each dependency cycle, and the schedule length counts the last *completion*
rather than the last issue. With every latency 1 all formulas reduce
exactly to the paper's — the downstream CNF is bit-identical.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import networkx as nx

from .arch import op_class
from .cgra import CGRA
from .dfg import DFG

# simple_cycles enumeration bound: a dense DFG has exponentially many
# simple cycles; past this many, rec_mii switches to the exact
# positive-cycle feasibility search (see _rec_mii_feasible) instead of
# hanging the mapper before it ever reaches the solver.
REC_MII_CYCLE_CAP = 20_000


class Infeasible(ValueError):
    """Structural proof that *no* II can ever map this DFG on this fabric
    (e.g. an op class with zero capable PEs). Raised by :func:`res_mii` /
    :func:`min_ii`; the mapping engines convert it into a structured
    ``MappingResult.infeasible`` verdict instead of running a doomed
    II sweep, and ``repro_torch.core.api.compile`` surfaces it as a clean
    front-door error."""

    def __init__(self, msg: str, *, op_class: Optional[str] = None,
                 n_ops: int = 0):
        super().__init__(msg)
        self.op_class = op_class
        self.n_ops = n_ops


def node_latencies(dfg: DFG, cgra=None) -> Dict[int, int]:
    """Per-node issue->result latencies on ``cgra`` (``ArchSpec`` or the
    legacy ``CGRA`` adapter, both exposing ``lat(op_class)``). ``None`` —
    or a fabric without a latency table — is the paper's unit model."""
    lat_fn = getattr(cgra, "lat", None) if cgra is not None else None
    if lat_fn is None:
        return {nid: 1 for nid in dfg.nodes}
    return {nid: lat_fn(op_class(nd.op)) for nid, nd in dfg.nodes.items()}


def asap_alap(dfg: DFG, lat: Optional[Dict[int, int]] = None,
              ) -> Tuple[Dict[int, int], Dict[int, int], int]:
    """Forward-edge (distance-0) ASAP/ALAP (paper Fig. 4), latency-aware.

    Returns (asap, alap, schedule_length L). A node issued at t completes
    at t + lat[n]; L is the earliest completion of the whole body and ALAP
    is relative to it, so sinks finish exactly at L. With unit latencies
    this is the paper's table: L = critical path length, sinks at L-1.
    """
    order = dfg.topo_order()
    if lat is None:
        lat = {nid: 1 for nid in order}
    asap = {nid: 0 for nid in order}
    for nid in order:
        for src in dfg.preds(nid):
            asap[nid] = max(asap[nid], asap[src] + lat[src])
    length = max((asap[nid] + lat[nid] for nid in order), default=0)
    alap = {nid: length - lat[nid] for nid in order}
    for nid in reversed(order):
        for dst in dfg.succs(nid):
            alap[nid] = min(alap[nid], alap[dst] - lat[nid])
    return asap, alap, length


def res_mii(dfg: DFG, cgra: CGRA) -> int:
    """Per-resource-class ResMII: beyond the paper's node-count bound, each
    op class (alu / mem / mul — see ``repro_torch.core.arch.op_class``) is
    bottlenecked by the PEs that support it, so a heterogeneous fabric's
    lower bound is max over classes of ceil(#ops / #capable PEs). On the
    paper's homogeneous CGRA this reduces exactly to the old
    node-count + memory-line bound.

    Raises :class:`Infeasible` when some op class present in the DFG has
    *zero* capable PEs — there is no finite II bound for that, and the
    old ``max(supporters, 1)`` fallback silently sent callers into a
    sweep that could never succeed."""
    mii = math.ceil(dfg.n / cgra.n_pes)
    counts: Dict[str, int] = {}
    for nd in dfg.nodes.values():
        cls = op_class(nd.op)
        counts[cls] = counts.get(cls, 0) + 1
    for cls, cnt in sorted(counts.items()):
        supporters = len(cgra.pes_for_class(cls))
        if supporters == 0:
            raise Infeasible(
                f"{dfg.name}: {cnt} {cls!r} op(s) but no {cls}-capable PE "
                f"on {cgra} — no II can map this DFG on this fabric",
                op_class=cls, n_ops=cnt)
        mii = max(mii, math.ceil(cnt / supporters))
    return max(mii, 1)


def _rec_mii_feasible(nodes, edges, lat: Dict[int, int], ii: int) -> bool:
    """True iff ``ii`` satisfies every recurrence: no positive cycle in
    the dependency graph under edge weights lat[s] - dist*ii (Bellman-Ford
    longest-path relaxation, O(V*E) — the polynomial fallback when simple-
    cycle enumeration is capped)."""
    d = {n: 0 for n in nodes}
    for _ in range(len(nodes)):
        changed = False
        for s, t, dd in edges:
            w = d[s] + lat[s] - dd * ii
            if w > d[t]:
                d[t] = w
                changed = True
        if not changed:
            return True
    return all(d[s] + lat[s] - dd * ii <= d[t] for s, t, dd in edges)


def rec_mii(dfg: DFG, lat: Optional[Dict[int, int]] = None,
            max_cycles: int = REC_MII_CYCLE_CAP) -> int:
    """max over dependency cycles of ceil(latency / distance), where
    latency is the *sum of true per-node latencies* around the cycle and
    distance the sum of per-edge loop-carried distances.

    Parallel edges between one node pair each close their own cycle; the
    bound uses the smallest distance among them per hop, which is exactly
    the max of the per-edge bounds (ceil is antitone in the distance), so
    no parallel edge's constraint is lost. Enumeration of simple cycles is
    capped at ``max_cycles``: past that, the exact answer is recovered by
    binary-searching the smallest II with no positive cycle under
    (latency - distance*II) edge weights — dense DFGs can no longer hang
    MII computation.
    """
    if lat is None:
        lat = {nid: 1 for nid in dfg.nodes}
    g = nx.DiGraph()
    g.add_nodes_from(dfg.nodes)
    dist: Dict[Tuple[int, int], int] = {}
    for s, d, dd in dfg.edges():
        key = (s, d)
        # min over parallel edges: each such edge contributes its own
        # cycle bound, and the smallest distance dominates them all
        if key not in dist or dd < dist[key]:
            dist[key] = dd
        g.add_edge(s, d)
    best = 1
    capped = False
    for n_seen, cyc in enumerate(nx.simple_cycles(g)):
        if n_seen >= max_cycles:
            capped = True
            break
        latency = sum(lat[n] for n in cyc)
        distance = sum(dist[(cyc[i], cyc[(i + 1) % len(cyc)])]
                       for i in range(len(cyc)))
        if distance > 0:
            best = max(best, math.ceil(latency / distance))
    if capped:
        # exact polynomial fallback: feasibility is monotone in II, and
        # any cycle's bound is <= the total latency sum (distance >= 1)
        edges = [(s, d, dd) for (s, d), dd in dist.items()]
        lo, hi = best, max(best, sum(lat.values()))
        while lo < hi:
            mid = (lo + hi) // 2
            if _rec_mii_feasible(list(dfg.nodes), edges, lat, mid):
                hi = mid
            else:
                lo = mid + 1
        best = lo
    return best


def min_ii(dfg: DFG, cgra: CGRA) -> int:
    """MII = max(ResMII, RecMII) under the fabric's latency model.
    Raises :class:`Infeasible` when no II can ever work (see res_mii)."""
    return max(res_mii(dfg, cgra), rec_mii(dfg, node_latencies(dfg, cgra)))


@dataclass
class KMS:
    """Kernel Mobility Schedule for one candidate II."""
    ii: int
    length: int                                  # mobility-schedule length L
    n_folds: int                                 # ceil(L / II) iterations
    asap: Dict[int, int]
    alap: Dict[int, int]
    # node -> list of candidate (cycle, iteration) pairs, cycle in [0, II)
    candidates: Dict[int, List[Tuple[int, int]]]

    def flat_time(self, cycle: int, iteration: int) -> int:
        return iteration * self.ii + cycle

    def rows(self) -> List[List[Tuple[int, int]]]:
        """KMS rows (paper Fig. 5): row c -> [(node, iteration), ...]."""
        out: List[List[Tuple[int, int]]] = [[] for _ in range(self.ii)]
        for nid, cands in self.candidates.items():
            for c, it in cands:
                out[c].append((nid, it))
        for row in out:
            row.sort()
        return out


def mobility_schedule(dfg: DFG, lat: Optional[Dict[int, int]] = None,
                      ) -> List[List[int]]:
    """Paper Fig. 4 MS: row t lists nodes whose [asap, alap] window covers t."""
    asap, alap, length = asap_alap(dfg, lat)
    return [[nid for nid in sorted(dfg.nodes)
             if asap[nid] <= t <= alap[nid]] for t in range(length)]


def build_kms(dfg: DFG, ii: int,
              lat: Optional[Dict[int, int]] = None) -> KMS:
    asap, alap, length = asap_alap(dfg, lat)
    n_folds = max(1, math.ceil(length / ii))
    cands = {
        nid: [(t % ii, t // ii) for t in range(asap[nid], alap[nid] + 1)]
        for nid in dfg.nodes
    }
    return KMS(ii=ii, length=length, n_folds=n_folds, asap=asap, alap=alap,
               candidates=cands)
