"""Heuristic modulo-scheduling baseline (the paper's SoA comparators).

RAMP [13] and PathSeeker [15] are heuristic mappers: priority-ordered
iterative placement with local adjustment (ejection) and randomized restarts
(PathSeeker is explicitly randomized; the paper reruns it 10x). This module
implements that family faithfully enough to serve as the comparison line in
our Fig. 6 / Tables I-IV reproduction:

  * node priority: height (longest path to a sink), critical nodes first;
  * placement scans the node's mobility window x PEs for a slot compatible
    with already-placed neighbours (same C3 timing window as the SAT
    encoding, so both mappers search the same space);
  * on conflict: bounded ejection of blocking nodes (PathSeeker-style local
    adjustment), then randomized restart (CRIMSON-style), then II+1.

It is complete in the limit of infinite restarts but — like the SoA tools —
greedy per step, so it misses solutions in tightly constrained instances
(2x2 CGRAs) where SAT-MapIt succeeds. That asymmetry is the paper's headline
result and is reproduced in benchmarks/fig6_ii.py.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cgra import CGRA
from .dfg import DFG
from .mapper import IIAttempt, MappingResult
from .regalloc import allocate
from .schedule import Infeasible, asap_alap, min_ii, node_latencies
from .simulator import verify_mapping


@dataclass
class BaselineConfig:
    n_restarts: int = 50
    max_ejects: int = 200
    max_ii: Optional[int] = None
    timeout_s: float = 4000.0
    seed: int = 0
    verify_iters: int = 6


def _heights(dfg: DFG) -> Dict[int, int]:
    order = dfg.topo_order()
    h = {n: 0 for n in order}
    for n in reversed(order):
        for d in dfg.succs(n):
            h[n] = max(h[n], h[d] + 1)
    return h


def _attempt(dfg: DFG, cgra: CGRA, ii: int, rng: random.Random,
             max_ejects: int) -> Optional[Dict[int, Tuple[int, int, int]]]:
    lat = node_latencies(dfg, cgra)
    # uniform latencies make a completion clash imply an issue clash (the
    # slot dict already forbids those), so the write-port scan below is
    # needed only on mixed-latency fabrics
    mixed_lat = len(set(lat.values())) > 1
    asap, alap, _ = asap_alap(dfg, lat)
    heights = _heights(dfg)
    prio = sorted(dfg.nodes, key=lambda n: (-heights[n], rng.random()))
    place: Dict[int, Tuple[int, int]] = {}       # n -> (pe, flat t)
    slot: Dict[Tuple[int, int], int] = {}        # (pe, t mod II) -> n
    queue = list(prio)
    ejects = 0

    in_edges = {n: [(s, dd) for s, d, dd in dfg.edges() if d == n]
                for n in dfg.nodes}
    out_edges = {n: [(d, dd) for s, d, dd in dfg.edges() if s == n]
                 for n in dfg.nodes}

    def compatible(n: int, p: int, t: int) -> bool:
        # the same latency-shifted C3 window the SAT encoding uses:
        # lat(producer) <= span <= II + lat(producer) - 1
        node = dfg.nodes[n]
        if not cgra.can_execute(p, node.op):
            return False
        # output-register write-port conflict: a mixed-latency neighbour
        # on this PE completing in our completion cycle (same-issue-slot
        # clashes are handled by the slot dict / ejection path instead)
        if mixed_lat:
            for m, (pm, tm) in place.items():
                if pm == p and tm % ii != t % ii \
                        and (tm + lat[m]) % ii == (t + lat[n]) % ii:
                    return False
        for s, dd in in_edges[n]:
            if s in place:
                ps, ts = place[s]
                if not cgra.reachable(ps, p):
                    return False
                if not (lat[s] <= t - ts + dd * ii <= ii + lat[s] - 1):
                    return False
        for d, dd in out_edges[n]:
            if d in place:
                pd, td = place[d]
                if not cgra.reachable(p, pd):
                    return False
                if not (lat[n] <= td - t + dd * ii <= ii + lat[n] - 1):
                    return False
        return True

    while queue:
        n = queue.pop(0)
        window = list(range(asap[n], alap[n] + 1))
        rng.shuffle(window)
        pes = list(range(cgra.n_pes))
        rng.shuffle(pes)
        placed = False
        blocked: List[Tuple[int, int, int]] = []   # (occupant, p, t)
        for t in window:
            for p in pes:
                if not compatible(n, p, t):
                    continue
                occ = slot.get((p, t % ii))
                if occ is None:
                    place[n] = (p, t)
                    slot[(p, t % ii)] = n
                    placed = True
                    break
                blocked.append((occ, p, t))
            if placed:
                break
        if placed:
            continue
        # local adjustment: eject one blocking occupant and take its slot
        if blocked and ejects < max_ejects:
            ejects += 1
            occ, p, t = blocked[rng.randrange(len(blocked))]
            del place[occ]
            del slot[(p, t % ii)]
            if compatible(n, p, t):
                place[n] = (p, t)
                slot[(p, t % ii)] = n
                queue.append(occ)
                continue
            queue.insert(0, n)
            queue.append(occ)
            continue
        return None
    return {n: (p, t % ii, t // ii) for n, (p, t) in place.items()}


def map_heuristic(dfg: DFG, cgra: CGRA, cfg: BaselineConfig | None = None,
                  ) -> MappingResult:
    cfg = cfg or BaselineConfig()
    dfg.validate()
    rng = random.Random(cfg.seed)
    t_start = time.time()
    deadline = t_start + cfg.timeout_s
    try:
        mii = min_ii(dfg, cgra)
    except Infeasible as e:
        return MappingResult(success=False, cgra=cgra, infeasible=str(e),
                             total_time=time.time() - t_start)
    max_ii = cfg.max_ii if cfg.max_ii is not None else mii + 16
    res = MappingResult(success=False, mii=mii, cgra=cgra)

    for ii in range(mii, max_ii + 1):
        if time.time() > deadline:
            res.timed_out = True
            break
        t_ii = time.time()
        status = "FAIL"
        for r in range(cfg.n_restarts):
            if time.time() > deadline:
                res.timed_out = True
                break
            placement = _attempt(dfg, cgra, ii, rng, cfg.max_ejects)
            if placement is None:
                continue
            ra = allocate(dfg, cgra, placement, ii)
            if not ra.ok:
                continue
            chk = verify_mapping(dfg, cgra, placement, ii,
                                 n_iters=cfg.verify_iters)
            if not chk.ok:      # pragma: no cover - guards the heuristic
                continue
            res.success = True
            res.ii = ii
            res.placement = placement
            res.regalloc = ra
            res.dfg = dfg
            status = "SAT"
            break
        res.attempts.append(IIAttempt(
            ii=ii, n_vars=0, n_clauses=0, status=status,
            solve_time=time.time() - t_ii, encode_time=0.0))
        if res.success:
            break

    res.total_time = time.time() - t_start
    return res
