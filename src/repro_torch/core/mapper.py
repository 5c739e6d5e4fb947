"""The SAT-MapIt iterative mapping loop (paper Fig. 3).

    II = MII
    loop:
        KMS  <- fold mobility schedule by II
        CNF  <- C1 & C2 & C3 over the KMS
        SAT? -> register allocation -> success
        UNSAT / regalloc failure -> II += 1

Beyond-paper option (--routing): the paper's stated limitation is that no
routing nodes are inserted (§V, sha on 5x5: SoA reaches II=2 with a route
node, SAT-MapIt only II=3). With ``routing=True`` the mapper, before
conceding an II, retries with pass-through ``route`` nodes spliced into the
highest-fanout edges — recovering exactly that case family.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cgra import CGRA
from .dfg import DFG
from .encode import EncoderSession
from .regalloc import RegAllocResult, allocate
from .sat import SAT, UNSAT, solve
from .schedule import Infeasible, min_ii
from .simulator import verify_mapping


@dataclass
class MapperConfig:
    solver: str = "auto"          # auto | z3 | cdcl | walksat | portfolio
    amo: str = "pairwise"         # paper's encoding; "sequential" = Sinz
    max_ii: Optional[int] = None  # default: MII + 16
    routing: bool = False
    max_route_nodes: int = 3
    timeout_s: float = 4000.0     # paper's experiment timeout
    verify_iters: int = 6
    seed: int = 0
    # beyond-paper: seed CDCL phase saving from a (possibly partial)
    # heuristic placement at the same II — guides the search toward
    # structured assignments. CDCL backend only.
    warm_start: bool = False
    # assumption-based incremental core: one persistent layered formula +
    # live solver across the whole II sweep (learned-clause retention,
    # WalkSAT warm starts). False = the cold encode+solve-per-II reference
    # path (the paper-faithful Fig. 3 loop).
    incremental: bool = True
    # learnt-clause database cap for the persistent CDCL (None = keep all;
    # the mapping service sets a bound so long-lived sessions stay small)
    max_learnt: Optional[int] = None
    # sweep-only: race a second cold CDCL per candidate, started from the
    # *opposite* saved phases of the persistent session leg; whichever leg
    # delivers first decides the II (IIAttempt.via == "cdcl-flip" when the
    # flipped racer wins). CDCL sessions only; staged like the WalkSAT
    # racer so easy windows never pay for it.
    race_flip: bool = True
    # learned II guidance (repro_torch.core.guide): a registered guide name
    # or an .npz checkpoint path (either package's). Sweep-only and *sound*
    # — the prediction chooses window extents (how many candidate IIs
    # encode/race per round), never which IIs are tried: the guided final
    # II is identical to the unguided one on every input. A name that
    # resolves to nothing runs unguided (MappingResult.guidance records
    # "used": False). A string (not a guide object) so configs stay
    # hashable for the service cache and the store key.
    guide: Optional[str] = None


@dataclass
class IIAttempt:
    ii: int
    n_vars: int
    n_clauses: int
    status: str
    solve_time: float
    encode_time: float
    route_nodes: int = 0
    regalloc_ok: Optional[bool] = None
    # incremental-core reuse statistics (None on the cold path)
    via: str = ""                            # backend/leg that decided this II
    #   via == "cdcl-flip": the sweep's second racing solver (cold CDCL
    #   started from the opposite saved phases) beat the persistent
    #   session leg to this II's verdict
    #   via == "core": this II was *pruned* — a failed-assumption core
    #   recorded earlier on the same session already refutes it, so the
    #   UNSAT status is replayed without a solve (solve_time == 0)
    learned_retained: Optional[int] = None   # clauses carried into the solve
    conflicts: Optional[int] = None          # conflicts spent on this II
    warm_hamming: Optional[int] = None       # walksat init vs final model
    evicted: Optional[int] = None            # learnt clauses evicted so far
    # the complete solve that decided this II was seeded with a racer
    # near-miss as CDCL saved phases (None on paths without the session)
    phase_hinted: Optional[bool] = None


@dataclass
class MappingResult:
    success: bool
    ii: Optional[int] = None
    placement: Dict[int, Tuple[int, int, int]] = field(default_factory=dict)
    regalloc: Optional[RegAllocResult] = None
    dfg: Optional[DFG] = None          # final DFG (may contain route nodes)
    cgra: Optional[CGRA] = None
    attempts: List[IIAttempt] = field(default_factory=list)
    total_time: float = 0.0
    mii: int = 0
    timed_out: bool = False
    # structural-infeasibility verdict (e.g. an op class with zero capable
    # PEs): the human-readable reason, set instead of running a doomed II
    # sweep. None for every feasible request.
    infeasible: Optional[str] = None
    # per-request reuse statistics when the request was served by a
    # MappingService (repro_torch.core.service.RequestStats); None otherwise
    service: Optional[object] = None
    # structured, machine-readable warnings (each {"kind": ..., ...}):
    # e.g. routing retries silently forcing the sequential engine. Read
    # with getattr(res, "warnings", []) when results may come from old
    # pickled store records that predate the field.
    warnings: List[Dict] = field(default_factory=list)
    # what the learned guide (cfg.guide) predicted and how the sweep used
    # it ({"guide", "offset", "order", "hopeless", "used"}); None when the
    # request ran unguided
    guidance: Optional[Dict] = None

    @property
    def n_route_nodes(self) -> int:
        return 0 if self.dfg is None else sum(
            1 for nd in self.dfg.nodes.values() if nd.op == "route")


def _try_ii(dfg: DFG, cgra: CGRA, ii: int, cfg: MapperConfig,
            deadline: float, attempts: List[IIAttempt], route_nodes: int = 0,
            sess=None,
            ) -> Optional[Tuple[Dict[int, Tuple[int, int, int]], RegAllocResult]]:
    """One Fig. 3 iteration. With ``sess`` (a persistent
    ``repro_torch.core.sat.portfolio.SolverSession``) the II is decided by an
    assumption solve on the session's one live formula/solver; without it,
    a fresh CNF is encoded and solved cold (the reference path)."""
    if sess is not None:
        t0 = time.time()
        sess.ensure_ii(ii)
        t_enc = time.time() - t0
        st = sess.stats_for(ii)
        t0 = time.time()
        hint = None
        if cfg.warm_start and sess.complete_method == "cdcl":
            hint = _heuristic_phase_hint(
                dfg, cgra, _session_var_of(sess, ii), st["vars"], ii,
                cfg.seed)
        status, model, stats = sess.solve_ii(ii, phase_hint=hint)
        att = IIAttempt(ii=ii, n_vars=st["vars"], n_clauses=st["clauses"],
                        status=status, solve_time=time.time() - t0,
                        encode_time=t_enc, route_nodes=route_nodes,
                        via=stats.via,
                        learned_retained=stats.learned_retained,
                        conflicts=stats.conflicts,
                        warm_hamming=stats.warm_hamming,
                        evicted=stats.evicted,
                        phase_hinted=stats.phase_hinted)
        attempts.append(att)
        if status != SAT:
            return None
        placement = sess.enc.decode(ii, model)
    else:
        t0 = time.time()
        session = EncoderSession(dfg, cgra, cfg.amo)
        enc = session.encode(ii)
        t_enc = time.time() - t0
        t0 = time.time()
        hint = None
        if cfg.warm_start and cfg.solver == "cdcl":
            hint = _heuristic_phase_hint(dfg, cgra, enc.var_of.get,
                                         enc.cnf.n_vars, ii, cfg.seed)
        status, model = solve(enc.cnf, cfg.solver, seed=cfg.seed,
                              phase_hint=hint)
        att = IIAttempt(ii=ii, n_vars=enc.stats["vars"],
                        n_clauses=enc.stats["clauses"], status=status,
                        solve_time=time.time() - t0, encode_time=t_enc,
                        route_nodes=route_nodes)
        attempts.append(att)
        if status != SAT:
            return None
        placement = enc.decode(model)
    ra = allocate(dfg, cgra, placement, ii)
    att.regalloc_ok = ra.ok
    if not ra.ok:
        return None
    return placement, ra


def note_pruned_ii(sess, ii: int, attempts: List[IIAttempt],
                   route_nodes: int = 0) -> None:
    """Replay an UNSAT verdict for ``ii`` from the session's recorded
    failed-assumption cores — no encode, no solve. Shared by the
    sequential loop and the sweep engine (both count it as a pruned II)."""
    inc = sess.enc.inc
    if inc.has_layer(ii):
        st = sess.stats_for(ii)
        n_vars, n_clauses = st["vars"], st["clauses"]
    else:   # all_unsat latched before this layer was ever encoded
        n_vars, n_clauses = inc.n_vars, inc.n_clauses
    sess.pruned_total += 1
    attempts.append(IIAttempt(
        ii=ii, n_vars=n_vars, n_clauses=n_clauses, status=UNSAT,
        solve_time=0.0, encode_time=0.0, route_nodes=route_nodes,
        via="core"))


def _session_var_of(sess, ii: int):
    """(n, p, c, it) -> var lookup over a SolverSession's shared layout."""
    var_of_t = sess.enc.session._ensure_layout().var_of_t
    return lambda key: var_of_t.get((key[0], key[1], key[3] * ii + key[2]))


def _heuristic_phase_hint(dfg: DFG, cgra: CGRA, var_lookup, n_vars: int,
                          ii: int, seed: int) -> Optional[list]:
    """Phase-saving seed for CDCL from one heuristic placement attempt at
    the same II (partial placements still help: unplaced nodes keep the
    default phase). ``var_lookup((n, p, c, it)) -> var or None`` abstracts
    over cold encodings and the incremental session's shared layout."""
    import random

    from .baseline import _attempt
    placement = _attempt(dfg, cgra, ii, random.Random(seed), max_ejects=50)
    if placement is None:
        return None
    hint = [False] * n_vars
    for n, (p, c, it) in placement.items():
        var = var_lookup((n, p, c, it))
        if var is not None:
            hint[var - 1] = True
    return hint


def _insert_route(dfg: DFG, edge: Tuple[int, int, int]) -> DFG:
    """Splice a route (pass-through) node into edge (s, d, delta)."""
    s, d, delta = edge
    g = copy.deepcopy(dfg)
    r = g.add("route", [(s, 0)], name=f"rt{s}_{d}")
    node = g.nodes[d]
    new_ins = []
    replaced = False
    for src, dist in node.ins:
        if not replaced and src == s and dist == delta:
            new_ins.append((r, delta))
            replaced = True
        else:
            new_ins.append((src, dist))
    node.ins = tuple(new_ins)
    g.touch()
    return g


def _route_candidates(dfg: DFG) -> List[Tuple[int, int, int]]:
    """Edges ranked by how hard they make placement: high-fanout sources
    first (all consumers must crowd around one PE)."""
    fanout: Dict[int, int] = {}
    for s, d, delta in dfg.edges():
        fanout[s] = fanout.get(s, 0) + 1
    edges = [e for e in dfg.edges() if fanout[e[0]] >= 2]
    edges.sort(key=lambda e: -fanout[e[0]])
    return edges


def map_loop(dfg: DFG, cgra: CGRA, cfg: MapperConfig | None = None,
             sweep_width: int = 1, service=None,
             session=None) -> MappingResult:
    """Find the minimal feasible II.

    ``sweep_width=1`` is the paper-faithful sequential reference (this
    function's body). ``sweep_width>1`` delegates to the parallel II-sweep
    engine (``repro_torch.core.sweep``), which encodes a window of candidate IIs
    through one shared EncoderSession and solves them concurrently —
    returning the same II as the sequential path. Routing retries
    (``cfg.routing``) are sequential-only and force ``sweep_width=1``.

    ``service`` (a ``repro_torch.core.service.MappingService``) routes the
    request through the long-lived solver pool + mapping cache; ``None``
    — the default — preserves the standalone behaviour. ``session``
    injects an existing warm ``SolverSession`` whose formula matches this
    (dfg, cgra, amo) shape — the service uses it to share one persistent
    solver across requests; IIs the session has already refuted via a
    failed-assumption core are skipped without a solve (via="core"
    attempts).
    """
    cfg = cfg or MapperConfig()
    if service is not None:
        return service.map(dfg, cgra, cfg, sweep_width=sweep_width)
    if sweep_width > 1 and not cfg.routing:
        from .sweep import map_sweep   # local import: sweep imports us
        return map_sweep(dfg, cgra, cfg, sweep_width=sweep_width,
                         session=session)
    warnings: List[Dict] = []
    if sweep_width > 1 and cfg.routing:
        # routing retries splice route nodes into the DFG mid-II, which
        # serialises the search — the parallel sweep cannot honour them.
        # This used to silently downgrade to the sequential engine; keep
        # the (correct) downgrade but say so in the result.
        warnings.append({
            "kind": "routing_forces_sequential",
            "requested_sweep_width": sweep_width,
            "effective_sweep_width": 1,
            "detail": "cfg.routing=True is sequential-only; the request "
                      "ran the Fig. 3 loop instead of the parallel sweep",
        })
    dfg.validate()
    t_start = time.time()
    deadline = t_start + cfg.timeout_s
    try:
        mii = min_ii(dfg, cgra)
    except Infeasible as e:
        # structural infeasibility (op class with zero capable PEs): a
        # structured verdict instead of a 17-attempt doomed sweep
        return MappingResult(success=False, cgra=cgra, infeasible=str(e),
                             total_time=time.time() - t_start,
                             warnings=warnings)
    max_ii = cfg.max_ii if cfg.max_ii is not None else mii + 16
    res = MappingResult(success=False, mii=mii, cgra=cgra,
                        warnings=warnings)

    # the persistent incremental core: one layered formula + live solver
    # for the whole loop. Routing retries splice nodes into the DFG (a
    # different formula), so those attempts always take the cold path.
    sess = session
    if sess is None and cfg.incremental:
        from .sat.portfolio import SolverSession
        sess = SolverSession(EncoderSession(dfg, cgra, cfg.amo),
                             method=cfg.solver, seed=cfg.seed,
                             max_learnt=cfg.max_learnt)

    for ii in range(mii, max_ii + 1):
        if time.time() > deadline:
            res.timed_out = True
            break
        if sess is not None and sess.is_proven_unsat(ii):
            # a recorded failed-assumption core already refutes this II on
            # this session's formula: replay UNSAT without a solve. The
            # routing branch below still runs — route nodes change the
            # DFG, so a pruned plain II may yet map with routing.
            note_pruned_ii(sess, ii, res.attempts)
            got = None
            if sess.all_unsat and not cfg.routing:
                break   # empty core: every candidate II is refuted
        else:
            got = _try_ii(dfg, cgra, ii, cfg, deadline, res.attempts,
                          sess=sess)
        cur_dfg = dfg
        if got is None and cfg.routing:
            # beyond-paper: retry this II with routing nodes spliced in
            g = dfg
            for k, edge in enumerate(_route_candidates(dfg)):
                if k >= cfg.max_route_nodes or time.time() > deadline:
                    break
                g = _insert_route(g, edge)
                got = _try_ii(g, cgra, ii, cfg, deadline, res.attempts,
                              route_nodes=k + 1)
                if got is not None:
                    cur_dfg = g
                    break
        if got is not None:
            placement, ra = got
            chk = verify_mapping(
                cur_dfg, cgra, placement, ii, n_iters=cfg.verify_iters,
                node_subset=set(dfg.nodes) if cur_dfg is not dfg else None)
            if not chk.ok:
                raise AssertionError(
                    f"mapper produced an invalid mapping at II={ii}: "
                    f"{chk.errors[:3]}")
            res.success = True
            res.ii = ii
            res.placement = placement
            res.regalloc = ra
            res.dfg = cur_dfg
            break

    res.total_time = time.time() - t_start
    return res
