"""Parallel II-sweep mapping engine.

The paper's Fig. 3 loop tries II = MII, MII+1, ... strictly sequentially,
re-encoding the full CNF and solving from scratch at every step. But the II
attempts are *independent* SAT instances, so this engine:

  1. encodes a window of candidate IIs ``[base, base + sweep_width)`` up
     front through one shared :class:`repro_torch.core.encode.EncoderSession` —
     the II-independent clause structure (C1 exactly-one, the C2
     at-most-one slot skeleton, the per-node literal layout) is built once
     and only the II-dependent C2 fold and C3 timing windows are re-derived
     per candidate;
  2. solves the whole window concurrently via
     :func:`repro_torch.core.sat.portfolio.solve_window` — with the default
     incremental core, one persistent assumption-based complete solver
     walks the candidates lowest-II-first (every UNSAT proof's learned
     clauses carry into the next candidate) while racing a batched WalkSAT
     that vmaps restarts across the II candidates, warm-started from the
     best assignment earlier IIs produced; with ``incremental=False``,
     cold complete solvers run per candidate in a process/thread pool;
  3. early-cancels all higher-II attempts the moment a lower II returns
     SAT *and* passes register allocation, and slides the window upward
     only when every candidate in it fails.

Incremental-encoding contract (what this engine relies on from
``EncoderSession``): variable numbering is identical across the IIs of one
session; ``encode(ii)`` is side-effect-free and cheap after the first call
(C1 clauses are shared by reference); decoded placements use per-II kernel
cycles ``t % ii`` of the same underlying flat mobility times.

Equivalence guarantee: for any ``sweep_width`` the engine returns an II
less than or equal to the sequential reference (``map_loop`` with
``sweep_width=1``), and equal in every case where register allocation
judges the two modes' models alike. Candidates below a winner are never
cancelled, and a WalkSAT model that fails regalloc is treated as
*provisional* (the complete backend's model — the one the sequential
reference would have judged — still decides that II), so the sweep can
never report a *larger* II; it can only improve on the reference when the
racer finds a regalloc-friendly model the complete solver's own model
misses. Placements may differ between modes (different solver races find
different models); both are verified against sequential loop semantics
before being returned.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .cgra import CGRA
from .dfg import DFG
from .encode import EncoderSession, Encoding
from .mapper import (IIAttempt, MapperConfig, MappingResult, note_pruned_ii)
from .regalloc import RegAllocResult, allocate
from .sat import SAT, UNKNOWN, UNSAT
from .sat.portfolio import solve_window
from .schedule import Infeasible, min_ii
from .simulator import verify_mapping


def map_sweep(dfg: DFG, cgra: CGRA, cfg: Optional[MapperConfig] = None,
              sweep_width: int = 4, service=None,
              session=None) -> MappingResult:
    """Map ``dfg`` onto ``cgra`` by sweeping candidate IIs in parallel
    windows of ``sweep_width``. Drop-in replacement for
    ``mapper.map_loop`` (which delegates here for ``sweep_width > 1``).

    ``cfg.routing`` is not supported by the parallel engine (route-node
    splicing changes the DFG mid-II, which serialises the search); callers
    wanting routing retries use the sequential path. ``cfg.warm_start``
    (CDCL phase hints from a heuristic placement) is likewise
    sequential-only: pool workers solve bare CNFs, so the hint is not
    applied here.

    ``service`` routes the request through a long-lived
    ``repro_torch.core.service.MappingService`` (None = standalone, today's
    behaviour); ``session`` injects a warm ``SolverSession`` whose
    formula matches this (dfg, cgra, amo) shape. Candidate IIs the
    session has already refuted via a failed-assumption core are dropped
    from the window without a solve and recorded as via="core" UNSAT
    attempts — the window then spends its parallelism on undecided IIs
    only.
    """
    cfg = cfg or MapperConfig()
    if service is not None:
        return service.map(dfg, cgra, cfg, sweep_width=sweep_width)
    if cfg.routing:
        raise ValueError("map_sweep does not support routing=True; "
                         "use map_loop(sweep_width=1)")
    if sweep_width < 1:
        raise ValueError(f"sweep_width must be >= 1, got {sweep_width}")
    dfg.validate()
    t_start = time.time()
    deadline = t_start + cfg.timeout_s
    try:
        mii = min_ii(dfg, cgra)
    except Infeasible as e:
        return MappingResult(success=False, cgra=cgra, infeasible=str(e),
                             total_time=time.time() - t_start)
    max_ii = cfg.max_ii if cfg.max_ii is not None else mii + 16
    res = MappingResult(success=False, mii=mii, cgra=cgra)
    sess = session
    enc_session = sess.enc.session if sess is not None \
        else EncoderSession(dfg, cgra, cfg.amo)
    # the incremental core: one persistent layered formula + live complete
    # solver across every window of the sweep (see portfolio.SolverSession);
    # cfg.incremental=False keeps the cold per-II encode+solve reference.
    if sess is None and cfg.incremental:
        from .sat.portfolio import SolverSession
        sess = SolverSession(enc_session, method=cfg.solver, seed=cfg.seed,
                             max_learnt=cfg.max_learnt)

    # learned window-extent guidance (cfg.guide -> repro_torch.core.guide).
    # The suggestion only ever picks how many candidate IIs the next window
    # spans; every II from MII upward still enters some window in
    # ascending order and the winner scan below still demands a proven
    # refutation of every lower candidate — so guidance cannot change the
    # final II, only the wall-clock spent finding it. Any guide failure
    # (unresolvable name, feature extraction, a garbage suggestion) falls
    # back to the unguided fixed width, recorded as {"used": False}.
    sug = None
    if cfg.guide and sweep_width > 1:
        try:
            from .campaign import cell_features
            from .guide import resolve_guide
            g = resolve_guide(cfg.guide)
            if g is not None:
                sug = g.suggest(cell_features(dfg, cgra))
        except Exception:
            sug = None
        if sug is not None:
            res.guidance = {"guide": cfg.guide, "used": True,
                            "offset": int(sug.offset),
                            "order": [int(o) for o in sug.order],
                            "hopeless": float(sug.hopeless),
                            "spans": []}
        else:
            res.guidance = {"guide": cfg.guide, "used": False}

    base = mii
    while base <= max_ii:
        if time.time() > deadline:
            res.timed_out = True
            break
        if sess is not None and sess.all_unsat:
            # an empty failed-assumption core latched the session: the base
            # formula is UNSAT, no candidate II can ever map
            note_pruned_ii(sess, base, res.attempts)
            break
        width = sweep_width
        if sug is not None:
            try:
                width = int(sug.span_from(base - mii))
            except Exception:
                width = sweep_width
            width = max(1, min(width, max(sweep_width, 16)))
            res.guidance["spans"].append(width)
        window = list(range(base, min(base + width - 1, max_ii) + 1))
        # replay recorded UNSAT cores up front: those IIs never enter the
        # window, so its parallelism is spent on undecided candidates only
        iis: List[int] = []
        for ii in window:
            if sess is not None and sess.is_proven_unsat(ii):
                note_pruned_ii(sess, ii, res.attempts)
            else:
                iis.append(ii)
        if not iis:
            base = window[-1] + 1
            continue
        encs: List[Encoding] = []
        enc_times: List[float] = []
        cnfs = []
        stats_list: List[Dict[str, int]] = []
        for ii in iis:
            t0 = time.time()
            if sess is not None:
                sess.ensure_ii(ii)
                stats_list.append(sess.stats_for(ii))
            else:
                encs.append(enc_session.encode(ii))
                stats_list.append(encs[-1].stats)
            enc_times.append(time.time() - t0)
        if sess is not None:
            # projections materialised only after the whole window is
            # encoded, so their variable space is window-consistent
            cnfs = [sess.project(ii) for ii in iis]
        else:
            cnfs = [e.cnf for e in encs]

        def decode(i: int, model: List[bool]):
            if sess is not None:
                return sess.enc.decode(iis[i], model)
            return encs[i].decode(model)

        # regalloc results captured by the accept callback, keyed by window
        # index; accept returns True (=> cancel all higher IIs) only when
        # register allocation also succeeds, mirroring Fig. 3's criterion.
        placements: Dict[int, Tuple[Dict[int, Tuple[int, int, int]],
                                    RegAllocResult]] = {}

        def accept(i: int, model: List[bool]) -> bool:
            placement = decode(i, model)
            ra = allocate(dfg, cgra, placement, iis[i])
            placements[i] = (placement, ra)
            return ra.ok

        wres = solve_window(
            cnfs, method=cfg.solver, seed=cfg.seed,
            deadline=deadline, accept=accept, session=sess, iis=iis,
            race_flip=cfg.race_flip)

        winner: Optional[int] = None
        blocked = False   # an unresolved candidate below the best SAT
        for i, ii in enumerate(iis):
            r = wres[i]
            att = IIAttempt(
                ii=ii, n_vars=stats_list[i]["vars"],
                n_clauses=stats_list[i]["clauses"], status=r.status,
                solve_time=r.solve_time, encode_time=enc_times[i],
                via=r.via if r.status in (SAT, UNSAT) else "")
            if r.stats is not None:
                att.learned_retained = r.stats.learned_retained
                att.conflicts = r.stats.conflicts
                att.warm_hamming = r.stats.warm_hamming
                att.evicted = r.stats.evicted
                att.phase_hinted = r.stats.phase_hinted
            if i in placements:
                att.regalloc_ok = placements[i][1].ok
            res.attempts.append(att)
            if winner is None and not blocked:
                if r.status == SAT and placements[i][1].ok:
                    winner = i
                elif r.status == UNKNOWN and r.via != "walksat":
                    # undecided below any winner (deadline, killed solver):
                    # equivalence with the sequential loop is lost, so stop
                    # here rather than report a possibly non-minimal II.
                    # (UNKNOWN from the incomplete walksat-only mode is not
                    # blocking — the sequential reference also just moves
                    # to the next II.)
                    blocked = True

        if winner is not None:
            placement, ra = placements[winner]
            chk = verify_mapping(dfg, cgra, placement, iis[winner],
                                 n_iters=cfg.verify_iters)
            if not chk.ok:
                raise AssertionError(
                    f"sweep produced an invalid mapping at II={iis[winner]}: "
                    f"{chk.errors[:3]}")
            res.success = True
            res.ii = iis[winner]
            res.placement = placement
            res.regalloc = ra
            res.dfg = dfg
            break
        if blocked:
            res.timed_out = time.time() > deadline
            break
        base = window[-1] + 1

    res.total_time = time.time() - t_start
    return res
