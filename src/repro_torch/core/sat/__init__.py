"""SAT solver backends.

``solve(cnf, method=...)`` dispatches to:
  * "cdcl"    — our own CDCL (watched literals, VSIDS, Luby restarts,
                phase saving). Always available; host CPU.
  * "walksat" — batched probSAT in PyTorch on the package's device (see
                ``repro_torch.device``); incomplete: returns UNKNOWN
                instead of UNSAT.
  * "portfolio" — walksat first, the complete backend as the fallback.
  * "auto"    — the complete backend: cdcl. The z3 backend of the JAX
                package is not ported yet; asking for "z3" raises.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..cnf import CNF

SAT, UNSAT, UNKNOWN = "SAT", "UNSAT", "UNKNOWN"


def resolve_method(method: str) -> str:
    """Resolve "auto" to the concrete complete backend used on this host."""
    if method == "auto":
        return "cdcl"
    if method == "z3":
        raise NotImplementedError("the z3 backend is not ported to "
                                  "repro_torch; use 'cdcl' or 'auto'")
    return method


def solve(cnf: CNF, method: str = "auto", *, max_conflicts: Optional[int] = None,
          phase_hint: Optional[List[bool]] = None, seed: int = 0,
          walksat_steps: int = 20000, walksat_batch: int = 64,
          stop: Optional[Callable[[], bool]] = None,
          ) -> Tuple[str, Optional[List[bool]]]:
    if getattr(cnf, "trivially_unsat", False):
        # an empty clause was recorded (CNF.add_clause marker): fail fast
        # and identically across every backend
        return UNSAT, None
    method = resolve_method(method)
    if method == "cdcl":
        from .cdcl import CDCLSolver
        return CDCLSolver(cnf).solve(max_conflicts=max_conflicts,
                                     phase_hint=phase_hint, stop=stop)
    if method == "walksat":
        from .walksat_torch import solve_walksat
        return solve_walksat(cnf, seed=seed, steps=walksat_steps,
                             batch=walksat_batch, stop=stop)
    if method == "portfolio":
        from .portfolio import solve_portfolio
        return solve_portfolio(cnf, seed=seed, stop=stop)
    raise ValueError(f"unknown SAT method {method!r}")
