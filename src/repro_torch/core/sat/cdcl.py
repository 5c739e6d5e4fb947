"""Conflict-driven clause learning SAT solver.

A dependency-free CDCL so the framework never requires Z3: two-watched
literals, EVSIDS branching, phase saving, 1UIP learning, Luby restarts.
Literals are signed ints (DIMACS). Designed for the KMS instances this
framework produces (1e4–1e5 vars, 1e5–1e6 clauses) — pure Python, so Z3 is
preferred when present; this backend is the always-available fallback and
the reference for the portfolio's UNSAT certification.

Clause storage is flat (mirroring ``repro_torch.core.cnf.ClauseArena``): one
literal list ``db`` plus per-clause ``cl_off``/``cl_len`` indexed by clause
id, and watch lists held in a dense list indexed by literal code
(``2v`` for ``+v``, ``2v+1`` for ``¬v``) instead of a dict keyed by signed
literal. The propagation loop then touches only small-int list indexing —
no dict hashing, no tuple allocation — while keeping the *identical*
decision/learning behaviour (watch order, clause order, restart schedule),
so ``last_core``, learnt-DB eviction, and all stats are unchanged.

Incremental interface (the assumption-based sweep core):

  * ``solve(assumptions=[...])`` — MiniSat-style: assumptions are enqueued
    as pseudo-decisions below all real decisions; a conflict that reaches
    decision level 0 is global UNSAT (the solver stays UNSAT forever), a
    falsified assumption is UNSAT *under these assumptions only*.
  * ``add_clauses(...)`` — grow the formula between solve calls.
  * learned clauses, variable activities, and saved phases all persist
    across calls — solving II=k+1 after II=k starts from everything the
    previous call derived, which is the whole point of the layered
    selector-literal encoding in ``repro_torch.core.cnf.IncrementalCNF``.

Service extensions (for a long-lived mapping service process):

  * **failed-assumption cores** — after an UNSAT-under-assumptions
    verdict, ``last_core`` holds the subset of the assumption literals
    that the final conflict actually depends on (MiniSat's
    ``analyzeFinal``). An empty core means the formula itself is UNSAT
    regardless of assumptions. ``last_core`` is ``None`` after SAT and —
    critically — after every UNKNOWN: a ``max_conflicts`` budget
    exhaustion or a cooperative ``stop()`` is *not* a refutation, and
    callers that treat cores as proofs (the mapping service's II
    pruning) must never see one for an undecided call. ``last_limit``
    says which limit ended an UNKNOWN call ("conflicts" | "stop").
  * **bounded learnt-clause database** — with ``max_learnt=N`` the
    solver scores retained learnt clauses by (LBD, activity) and evicts
    the worst down to ``N // 2`` whenever the database grows past ``N``.
    Only clauses currently locked as propagation reasons are exempt
    (soundness of the trail); glue/binary clauses merely *rank first*
    under the LBD sort, so retention genuinely stays bounded. Eviction
    only drops redundant lemmas, never input clauses, so correctness is
    unaffected; ``evicted_total`` counts evictions for the service's
    reuse stats.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..cnf import CNF, ClauseArena


def solve_clauses_worker(n_vars: int, clauses: List[Tuple[int, ...]],
                         ) -> Tuple[str, Optional[List[bool]]]:
    """Process-pool entry point for the sweep portfolio: rebuilds the CNF
    from picklable primitives and solves it. Lives here (not portfolio.py)
    so spawn-started workers import only this light, torch-free module."""
    cnf = CNF()
    cnf.n_vars = n_vars
    cnf.clauses = [tuple(c) for c in clauses]
    return CDCLSolver(cnf).solve()


def solve_arena_worker(n_vars: int, lits, offs,
                       ) -> Tuple[str, Optional[List[bool]]]:
    """Like :func:`solve_clauses_worker` but takes the clause arena's raw
    (lits, offs) CSR arrays — two contiguous numpy buffers pickle across
    the pool far cheaper than a list of int tuples."""
    cnf = CNF()
    cnf.n_vars = n_vars
    cnf.arena = ClauseArena.from_arrays(lits, offs)
    return CDCLSolver(cnf).solve()


def _luby(x: int) -> int:
    """Luby sequence, 0-based index (MiniSat's iterative formulation)."""
    size, seq = 1, 0
    while size < x + 1:
        seq += 1
        size = 2 * size + 1
    while size - 1 != x:
        size = (size - 1) // 2
        seq -= 1
        x %= size
    return 1 << seq


def _lit_code(lit: int) -> int:
    """Dense watch-list index: +v -> 2v, ¬v -> 2v+1."""
    return (lit << 1) if lit > 0 else ((-lit << 1) | 1)


class CDCLSolver:
    def __init__(self, cnf: Optional[CNF] = None,
                 max_learnt: Optional[int] = None):
        self.nv = 0
        # flat clause database: clause ci is db[cl_off[ci] : cl_off[ci]+cl_len[ci]]
        self.db: List[int] = []
        self.cl_off: List[int] = []
        self.cl_len: List[int] = []
        # watch lists indexed by literal code (2v / 2v+1)
        self.watches: List[List[int]] = [[], []]
        # assignment: 0 unassigned, 1 true, -1 false (index = var)
        self.assign = [0]
        self.level = [0]
        self.reason: List[Optional[int]] = [None]
        self.trail: List[int] = []          # assigned literals in order
        self.trail_lim: List[int] = []      # decision-level boundaries
        self.qhead = 0
        self.activity = [0.0]
        self.var_inc = 1.0
        self.saved_phase = [False]
        self.ok = True
        self._units: List[int] = []
        self.n_input = 0          # input (non-learnt) clauses incl. units
        self.n_learnt = 0         # learnt clauses currently retained
        self.conflicts_total = 0  # across all solve() calls
        self.last_conflicts = 0   # conflicts of the latest solve() call
        # learnt-clause database bound: None keeps every learnt clause
        # forever (the original behaviour); an int N evicts down to N // 2 by
        # (LBD asc, activity desc) whenever retention exceeds N.
        self.max_learnt = max_learnt
        self._learnt_meta: Dict[int, List[float]] = {}  # ci -> [act, lbd]
        self.cla_inc = 1.0
        self.evicted_total = 0
        # failed-assumption core of the latest solve: a subset of the
        # assumption literals whose conjunction is refuted ([] = the
        # formula itself is UNSAT); None after SAT and after UNKNOWN
        self.last_core: Optional[List[int]] = None
        # which limit ended the latest UNKNOWN call: "conflicts" | "stop"
        self.last_limit: Optional[str] = None
        if cnf is not None:
            self.add_clauses(cnf.clauses, n_vars=cnf.n_vars)

    # ------------------------------------------------------- incremental API
    def grow_vars(self, n_vars: int) -> None:
        if n_vars <= self.nv:
            return
        extra = n_vars - self.nv
        self.assign.extend([0] * extra)
        self.level.extend([0] * extra)
        self.reason.extend([None] * extra)
        self.activity.extend([0.0] * extra)
        self.saved_phase.extend([False] * extra)
        self.watches.extend([] for _ in range(2 * extra))
        self.nv = n_vars

    def add_clauses(self, clauses, n_vars: Optional[int] = None) -> bool:
        """Add input clauses between solve calls (backtracks to level 0;
        learned clauses and heuristic state are kept). Returns False — and
        latches the solver UNSAT — on an empty clause."""
        self._backtrack(0)
        rows = clauses.iter_lists() if hasattr(clauses, "iter_lists") \
            else clauses
        if n_vars is not None:
            self.grow_vars(n_vars)
        elif hasattr(clauses, "max_var"):
            self.grow_vars(clauses.max_var())
        else:
            rows = [list(cl) for cl in rows]
            self.grow_vars(max((abs(l) for cl in rows for l in cl),
                               default=0))
        for cl in rows:
            self.n_input += 1
            if not self._add_clause(list(cl)):
                self.ok = False
        return self.ok

    @property
    def n_clauses(self) -> int:
        return len(self.cl_len)

    @property
    def clauses(self) -> List[List[int]]:
        """Materialised clause list (debugging/introspection only — the
        solver itself reads the flat ``db``)."""
        return [self.db[o:o + n] for o, n in zip(self.cl_off, self.cl_len)]

    @property
    def learnt_db_size(self) -> int:
        """Learnt clauses currently stored in the clause database (learnt
        *units* are level-0 trail facts, not database entries, so
        ``n_learnt`` may exceed this)."""
        return len(self._learnt_meta)

    # ------------------------------------------------------------ plumbing
    def _value(self, lit: int) -> int:
        v = self.assign[abs(lit)]
        return v if lit > 0 else -v

    def _watch(self, lit: int, ci: int) -> None:
        self.watches[(lit << 1) if lit > 0 else ((-lit << 1) | 1)].append(ci)

    def _append_db(self, lits: List[int]) -> int:
        """Append a clause to the flat database; returns its clause id."""
        ci = len(self.cl_len)
        self.cl_off.append(len(self.db))
        self.cl_len.append(len(lits))
        self.db.extend(lits)
        return ci

    def _clause(self, ci: int) -> List[int]:
        off = self.cl_off[ci]
        return self.db[off:off + self.cl_len[ci]]

    def _add_clause(self, lits: List[int]) -> bool:
        lits = sorted(set(lits), key=abs)
        # tautology / dedup
        for i in range(len(lits) - 1):
            if lits[i] == -lits[i + 1]:
                return True
        if not lits:
            return False
        if len(lits) == 1:
            self._units.append(lits[0])
            return True
        ci = self._append_db(lits)
        self._watch(lits[0], ci)
        self._watch(lits[1], ci)
        return True

    def _enqueue(self, lit: int, reason: Optional[int]) -> bool:
        val = self._value(lit)
        if val == 1:
            return True
        if val == -1:
            return False
        v = abs(lit)
        self.assign[v] = 1 if lit > 0 else -1
        self.level[v] = len(self.trail_lim)
        self.reason[v] = reason
        self.saved_phase[v] = lit > 0
        self.trail.append(lit)
        return True

    def _propagate(self) -> Optional[int]:
        """Returns conflicting clause index or None."""
        db = self.db
        cl_off = self.cl_off
        cl_len = self.cl_len
        watches = self.watches
        assign = self.assign
        trail = self.trail
        while self.qhead < len(trail):
            lit = trail[self.qhead]
            self.qhead += 1
            falsified = -lit
            fcode = (falsified << 1) if falsified > 0 \
                else ((-falsified << 1) | 1)
            wl = watches[fcode]
            if not wl:
                continue
            keep: List[int] = []
            i = 0
            while i < len(wl):
                ci = wl[i]
                i += 1
                off = cl_off[ci]
                # ensure falsified is clause position 1
                if db[off] == falsified:
                    db[off] = db[off + 1]
                    db[off + 1] = falsified
                first = db[off]
                fval = assign[first] if first > 0 else -assign[-first]
                if fval == 1:
                    keep.append(ci)
                    continue
                # search replacement watch
                moved = False
                for k in range(off + 2, off + cl_len[ci]):
                    q = db[k]
                    if (assign[q] if q > 0 else -assign[-q]) != -1:
                        db[off + 1] = q
                        db[k] = falsified
                        watches[(q << 1) if q > 0
                                else ((-q << 1) | 1)].append(ci)
                        moved = True
                        break
                if moved:
                    continue
                keep.append(ci)
                if fval == -1:
                    keep.extend(wl[i:])
                    watches[fcode] = keep
                    return ci
                self._enqueue(first, ci)
            watches[fcode] = keep
        return None

    # -------------------------------------------------------------- branch
    def _bump(self, v: int) -> None:
        self.activity[v] += self.var_inc
        if self.activity[v] > 1e100:
            for u in range(1, self.nv + 1):
                self.activity[u] *= 1e-100
            self.var_inc *= 1e-100

    def _decide(self) -> int:
        best, bestv = -1.0, 0
        for v in range(1, self.nv + 1):
            if self.assign[v] == 0 and self.activity[v] > best:
                best, bestv = self.activity[v], v
        return bestv

    def _analyze(self, confl: int) -> Tuple[List[int], int]:
        learnt = [0]  # slot for the asserting literal
        seen = [False] * (self.nv + 1)
        counter = 0
        lit = 0
        idx = len(self.trail) - 1
        cur_level = len(self.trail_lim)
        ci: Optional[int] = confl
        first = True
        while True:
            cl = self._clause(ci)
            meta = self._learnt_meta.get(ci)
            if meta is not None:    # learnt clause used in analysis: bump
                meta[0] += self.cla_inc
            # for reason clauses, cl[0] is the propagated literal
            for q in (cl if first else cl[1:] if cl[0] == lit else
                      [x for x in cl if x != lit]):
                v = abs(q)
                if not seen[v] and self.level[v] > 0:
                    seen[v] = True
                    self._bump(v)
                    if self.level[v] >= cur_level:
                        counter += 1
                    else:
                        learnt.append(q)
            first = False
            # walk back the trail to the next marked literal
            while not seen[abs(self.trail[idx])]:
                idx -= 1
            lit = self.trail[idx]
            v = abs(lit)
            seen[v] = False
            counter -= 1
            idx -= 1
            if counter == 0:
                break
            ci = self.reason[v]
        learnt[0] = -lit
        if len(learnt) == 1:
            bt = 0
        else:
            bt = max(self.level[abs(q)] for q in learnt[1:])
        return learnt, bt

    def _backtrack(self, lvl: int) -> None:
        if len(self.trail_lim) <= lvl:
            return
        lim = self.trail_lim[lvl]
        for lit in reversed(self.trail[lim:]):
            self.assign[abs(lit)] = 0
        del self.trail[lim:]
        del self.trail_lim[lvl:]
        self.qhead = min(self.qhead, len(self.trail))

    def _analyze_final(self, lit: int) -> List[int]:
        """Failed-assumption core (MiniSat ``analyzeFinal``): the subset of
        the current assumption literals whose conjunction is already
        refuted, given that assumption ``lit`` was found falsified by
        propagation from the clauses and the earlier assumptions. Walks the
        implication graph backwards from ``¬lit``; every pseudo-decision it
        reaches is an assumption that the refutation depends on."""
        core = [lit]
        if not self.trail_lim:
            return core     # falsified at level 0: lit alone is refuted
        seen = {abs(lit)}
        for i in range(len(self.trail) - 1, self.trail_lim[0] - 1, -1):
            q = self.trail[i]
            v = abs(q)
            if v not in seen:
                continue
            r = self.reason[v]
            if r is None:
                core.append(q)  # assumption pseudo-decision (as enqueued)
            else:
                for x in self._clause(r):
                    if abs(x) != v and self.level[abs(x)] > 0:
                        seen.add(abs(x))
            seen.discard(v)
        return core

    # ------------------------------------------------- learnt-DB reduction
    def _reduce_db(self) -> None:
        """Evict the worst-scored learnt clauses down to ``max_learnt // 2``.

        Scoring is MiniSat/Glucose-flavoured: LBD first (lower = closer to
        a proof skeleton, so glue and binary clauses rank at the top),
        activity second (recently useful in conflict analysis). Clauses
        locked as the propagation reason of a currently-assigned variable
        are always kept (required for soundness of the trail); everything
        else competes for the ``max_learnt // 2`` slots, so retention
        stays bounded. The flat database is compacted and watches / reason
        indices remapped, so this is safe at any decision level."""
        locked = {self.reason[abs(lit)] for lit in self.trail
                  if self.reason[abs(lit)] is not None}
        target = max(0, (self.max_learnt or 0) // 2)
        ranked = sorted(self._learnt_meta.items(),
                        key=lambda kv: (kv[1][1], -kv[1][0],
                                        self.cl_len[kv[0]]))
        keep = set()
        for ci, (act, lbd) in ranked:
            if ci in locked or len(keep) < target:
                keep.add(ci)
        dropped = len(self._learnt_meta) - len(keep)
        if dropped == 0:
            return
        remap: Dict[int, int] = {}
        new_db: List[int] = []
        new_off: List[int] = []
        new_len: List[int] = []
        for ci in range(len(self.cl_len)):
            if ci in self._learnt_meta and ci not in keep:
                continue
            remap[ci] = len(new_len)
            off, n = self.cl_off[ci], self.cl_len[ci]
            new_off.append(len(new_db))
            new_len.append(n)
            new_db.extend(self.db[off:off + n])
        self.db, self.cl_off, self.cl_len = new_db, new_off, new_len
        self._learnt_meta = {remap[ci]: meta
                             for ci, meta in self._learnt_meta.items()
                             if ci in keep}
        for v in range(1, self.nv + 1):
            r = self.reason[v]
            if self.assign[v] != 0 and r is not None:
                self.reason[v] = remap[r]   # locked => kept => remappable
            else:
                self.reason[v] = None       # stale entry of an unassigned var
        # positions 0/1 are exactly the watched literals (the propagate
        # loop maintains that invariant), so rebuilding from them is exact
        self.watches = [[] for _ in range(2 * (self.nv + 1))]
        for ci in range(len(self.cl_len)):
            off = self.cl_off[ci]
            self._watch(self.db[off], ci)
            self._watch(self.db[off + 1], ci)
        self.n_learnt -= dropped
        self.evicted_total += dropped

    # ---------------------------------------------------------------- main
    def solve(self, max_conflicts: Optional[int] = None,
              phase_hint: Optional[List[bool]] = None,
              stop: Optional[Callable[[], bool]] = None,
              assumptions: Optional[List[int]] = None,
              ) -> Tuple[str, Optional[List[bool]]]:
        """``stop`` is a cooperative cancellation hook (polled every few
        hundred loop iterations); when it returns True the search aborts
        with UNKNOWN. Used by the sweep portfolio to kill higher-II
        attempts once a lower II wins.

        ``assumptions`` are literals temporarily forced for this call only
        (MiniSat semantics): they occupy the lowest decision levels, so
        UNSAT here means "UNSAT under these assumptions" unless the
        conflict reaches level 0, in which case the formula itself is
        UNSAT and the solver latches ``ok=False``. The solver object is
        reusable after any outcome; learned clauses, activities, and
        phases carry over to the next call.

        Verdict bookkeeping for incremental callers: UNSAT sets
        ``last_core`` (failed-assumption subset; ``[]`` when the formula
        is UNSAT regardless of assumptions), while an exhausted
        ``max_conflicts`` budget or a fired ``stop`` returns UNKNOWN with
        ``last_core=None`` and ``last_limit`` saying which limit hit —
        a budget exhaustion under assumptions is *undecided*, never a
        proven-UNSAT II.
        """
        from . import SAT, UNSAT, UNKNOWN
        self.last_core = None
        self.last_limit = None
        if not self.ok:
            self.last_core = []
            return UNSAT, None
        assumptions = assumptions or []
        self._backtrack(0)
        self.qhead = 0
        if self.max_learnt is not None \
                and len(self._learnt_meta) > self.max_learnt:
            self._reduce_db()
        if phase_hint:
            for v in range(1, min(self.nv, len(phase_hint)) + 1):
                self.saved_phase[v] = bool(phase_hint[v - 1])
        for u in self._units:
            if not self._enqueue(u, None):
                self.ok = False
                self.last_core = []
                return UNSAT, None
        if self._propagate() is not None:
            self.ok = False
            self.last_core = []
            return UNSAT, None
        conflicts = 0
        self.last_conflicts = 0
        restart_idx = 1
        budget = 100 * _luby(restart_idx)
        ticks = 0
        try:
            while True:
                ticks += 1
                if stop is not None and ticks % 256 == 0 and stop():
                    self.last_limit = "stop"
                    return UNKNOWN, None
                confl = self._propagate()
                if confl is not None:
                    conflicts += 1
                    self.conflicts_total += 1
                    self.last_conflicts = conflicts
                    if len(self.trail_lim) == 0:
                        self.ok = False
                        self.last_core = []
                        return UNSAT, None
                    learnt, bt = self._analyze(confl)
                    self._backtrack(bt)
                    self.n_learnt += 1
                    if len(learnt) == 1:
                        if not self._enqueue(learnt[0], None):
                            self.ok = False
                            self.last_core = []
                            return UNSAT, None
                    else:
                        ci = self._append_db(learnt)
                        self._watch(learnt[0], ci)
                        self._watch(learnt[1], ci)
                        self._enqueue(learnt[0], ci)
                        lbd = len({self.level[abs(q)] for q in learnt})
                        self._learnt_meta[ci] = [self.cla_inc, lbd]
                    self.var_inc *= 1.0 / 0.95
                    self.cla_inc *= 1.0 / 0.999
                    if self.cla_inc > 1e20:
                        for meta in self._learnt_meta.values():
                            meta[0] *= 1e-20
                        self.cla_inc *= 1e-20
                    if self.max_learnt is not None \
                            and len(self._learnt_meta) > self.max_learnt:
                        self._reduce_db()
                    if max_conflicts is not None and conflicts >= max_conflicts:
                        self.last_limit = "conflicts"
                        return UNKNOWN, None
                    if conflicts >= budget:
                        restart_idx += 1
                        budget = conflicts + 100 * _luby(restart_idx)
                        self._backtrack(0)
                elif len(self.trail_lim) < len(assumptions):
                    # assumption pseudo-decisions occupy the lowest levels;
                    # a restart undoes them and this branch re-enqueues
                    lit = assumptions[len(self.trail_lim)]
                    val = self._value(lit)
                    if val == -1:
                        # falsified by propagation from clauses + earlier
                        # assumptions: UNSAT under these assumptions only
                        self.last_core = self._analyze_final(lit)
                        return UNSAT, None
                    self.trail_lim.append(len(self.trail))
                    if val == 0:
                        self._enqueue(lit, None)
                else:
                    v = self._decide()
                    if v == 0:
                        model = [self.assign[u] == 1
                                 for u in range(1, self.nv + 1)]
                        return SAT, model
                    self.trail_lim.append(len(self.trail))
                    lit = v if self.saved_phase[v] else -v
                    self._enqueue(lit, None)
        finally:
            self.last_conflicts = conflicts
