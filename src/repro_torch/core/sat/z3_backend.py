"""Z3 backend — the solver used in the paper's own experiments.

``solve_z3`` is the one-shot (cold) path. ``Z3IncrementalSolver`` keeps a
single ``z3.Solver`` alive across the II sweep: clauses are only ever
added (delta layers arrive guarded by selector literals, see
``repro_torch.core.cnf.IncrementalCNF``) and each candidate II is decided by
``check(assumptions)`` — no push/pop, so z3 retains its learned lemmas
across consecutive IIs instead of re-deriving them per call.

Deliberate difference from the JAX package's backend: every solver (each
``Z3IncrementalSolver``, each ``solve_z3`` call) owns a ``z3.Context`` of
its own, where the reference's share z3's main context. z3 allows one
thread at a time in a context, and the sweep breaks that: the cold
window's solves run on a thread pool, and a session's solver is freed on
whichever thread drops the session last (a walk racer's, while the
sweep's thread already adds clauses to the next session's solver), which
crashed the process (``Z3_solver_dec_ref`` on racer threads beside
``Or`` on the main thread).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..cnf import CNF


class Z3IncrementalSolver:
    """One persistent ``z3.Solver`` with assumption-based solving."""

    def __init__(self):
        import z3
        self._z3 = z3
        self.ctx = z3.Context()
        self.solver = z3.Solver(ctx=self.ctx)
        self.xs: List = [None]      # xs[v] = Bool for var v (1-based)
        self.n_clauses = 0
        self.unsat_latched = False  # an unguarded empty clause arrived
        # failed-assumption core of the latest solve (subset of the
        # assumption literals, as ints); None after SAT / UNKNOWN —
        # mirrors CDCLSolver.last_core so SolverSession treats both
        # complete backends identically
        self.last_core: Optional[List[int]] = None

    def grow_vars(self, n_vars: int) -> None:
        z3 = self._z3
        while len(self.xs) <= n_vars:
            self.xs.append(z3.Bool(f"x{len(self.xs)}", self.ctx))

    def add_clauses(self, clauses: Sequence[Tuple[int, ...]],
                    n_vars: Optional[int] = None) -> None:
        z3, xs = self._z3, self.xs
        if n_vars is not None:
            self.grow_vars(n_vars)
        else:
            self.grow_vars(max((abs(l) for cl in clauses for l in cl),
                               default=0))
            xs = self.xs
        for cl in clauses:
            if not cl:
                self.unsat_latched = True
                continue
            self.solver.add(
                z3.Or(*[xs[l] if l > 0 else z3.Not(xs[-l]) for l in cl]))
            self.n_clauses += 1

    def solve(self, assumptions: Optional[List[int]] = None,
              stop: Optional[Callable[[], bool]] = None,
              ) -> Tuple[str, Optional[List[bool]]]:
        z3 = self._z3
        from . import SAT, UNSAT, UNKNOWN
        self.last_core = None
        if self.unsat_latched:
            self.last_core = []
            return UNSAT, None
        if stop is not None and stop():
            return UNKNOWN, None
        xs = self.xs
        assumptions = assumptions or []
        assumed = [xs[l] if l > 0 else z3.Not(xs[-l]) for l in assumptions]
        # cooperative cancellation: bounded solve slices, polling ``stop``
        # between slices (z3 releases the GIL inside check())
        self.solver.set("timeout", 500 if stop is not None else 0)
        while True:
            res = self.solver.check(*assumed)
            if res == z3.sat:
                m = self.solver.model()
                return SAT, [z3.is_true(m[xs[v]])
                             for v in range(1, len(xs))]
            if res == z3.unsat:
                # failed-assumption core: z3 returns the subset of the
                # check() assumptions in the final conflict; map the
                # exprs back to our ints positionally
                try:
                    core_exprs = self.solver.unsat_core()
                    self.last_core = [lit for lit, e in
                                      zip(assumptions, assumed)
                                      if any(e.eq(c) for c in core_exprs)]
                except Exception:
                    self.last_core = list(assumptions)  # sound over-approx
                return UNSAT, None
            if stop is None or stop():
                return UNKNOWN, None

    def stats(self) -> Dict[str, float]:
        """Best-effort solver statistics (key set depends on z3 build)."""
        try:
            return {k: v for k, v in self.solver.statistics()}
        except Exception:
            return {}


def solve_z3(cnf: CNF, timeout_ms: Optional[int] = None,
             stop: Optional[Callable[[], bool]] = None,
             ) -> Tuple[str, Optional[List[bool]]]:
    import z3
    from . import SAT, UNSAT, UNKNOWN

    if getattr(cnf, "trivially_unsat", False):
        return UNSAT, None
    if stop is not None and stop():
        return UNKNOWN, None
    ctx = z3.Context()
    s = z3.Solver(ctx=ctx)
    if timeout_ms:
        s.set("timeout", timeout_ms)
    elif stop is not None:
        # cooperative cancellation: bounded solve slices, polling ``stop``
        # between slices (z3 releases the GIL inside check(), so the sweep's
        # watchdog thread can flip the event while we are solving)
        s.set("timeout", 500)
    xs = [z3.Bool(f"x{v}", ctx) for v in range(cnf.n_vars + 1)]  # xs[0] unused
    for cl in cnf.clauses:
        if not cl:
            return UNSAT, None
        s.add(z3.Or(*[xs[l] if l > 0 else z3.Not(xs[-l]) for l in cl]))

    def model_of() -> List[bool]:
        m = s.model()
        return [z3.is_true(m[xs[v]]) for v in range(1, cnf.n_vars + 1)]

    while True:
        res = s.check()
        if res == z3.sat:
            return SAT, model_of()
        if res == z3.unsat:
            return UNSAT, None
        if stop is None or timeout_ms or stop():
            return UNKNOWN, None
        # else: slice expired without a verdict — keep solving
