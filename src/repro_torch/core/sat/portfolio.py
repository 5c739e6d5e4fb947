"""Mapper-search portfolio: single-instance racing, window solving, and the
persistent incremental ``SolverSession``.

``solve_portfolio`` is the per-instance portfolio (incomplete sharded
probSAT first, complete solver for the UNSAT certificate) — deterministic
for a fixed seed because the two legs run sequentially.

``SolverSession`` is the assumption-based incremental core: it owns one
layered formula (``repro_torch.core.encode.IncrementalEncoding``) and one
persistent complete solver for the whole II sweep, so "try II=k" is an
assumption solve that retains every clause learned at earlier IIs, and the
WalkSAT leg warm-starts from the previous II's best near-miss assignment
(the shared variable numbering makes assignments comparable across IIs).

``solve_window`` is the engine room of the parallel II-sweep
(``repro_torch.core.sweep``): it takes the CNFs of a window of candidate IIs and
solves them concurrently —

  * the complete backend runs on every candidate, lowest II first — our
    CDCL in a persistent fork-started process pool (real parallelism for
    the UNSAT proofs; CPython threads would serialise on the GIL), or on a
    thread pool where the process pool is unavailable;
  * one staged racer thread runs the *batched* WalkSAT
    (``solve_walksat_window``), which walks restarts of all candidates
    together on the clause tensors, so the GPU leg certifies hard SAT
    instances while the complete leg grinds on the proofs;
  * per-candidate stop events implement early cancellation: the caller's
    ``accept`` callback may kill all higher-II work the moment a lower II
    returns SAT + regalloc-OK.

The probSAT batch runs on one device (``repro_torch.device``); sharding
the chains over several GPUs is later work. A walk racer that fails with a
kernel or device error does not vanish with its thread: the error is
recorded and re-raised when the window closes (or by the next
``solve_window`` call, since the racer thread is not joined).
"""
from __future__ import annotations

import multiprocessing
import os
import threading
import time
import warnings
from collections import OrderedDict
from concurrent.futures import (FIRST_COMPLETED, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait as futures_wait)
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# torch is imported lazily, inside the walksat module only: the CDCL pool
# below forks worker processes off this module, and a child forked after
# the parent initialised CUDA must never touch CUDA again. Keeping this
# module (and cdcl.solve_arena_worker's import closure) torch-free keeps
# the forked workers clean; only the walksat/portfolio legs — which the
# cdcl worker paths never enter — pay the deferred import.

from ..cnf import CNF

CANCELLED = "CANCELLED"

# ------------------------------------------------------------- process pool
# CPython's GIL serialises the pure-Python CDCL, so concurrent UNSAT proofs
# inside one process gain nothing from threads. The window solver therefore
# runs the CDCL leg in a small persistent process pool. Fork context: spawn
# would re-execute unguarded parent scripts' module level in every worker,
# and the workers only ever run the dependency-free CDCL (never torch or
# CUDA), which is fork-safe. The
# pool is created lazily and reused across windows. Non-Linux hosts without
# fork fall back to threads transparently.
_PROC_POOL: Optional[ProcessPoolExecutor] = None
_PROC_POOL_BROKEN = False
_PROC_POOL_COOLDOWN_UNTIL = 0.0


def _proc_pool() -> Optional[ProcessPoolExecutor]:
    global _PROC_POOL, _PROC_POOL_BROKEN
    if _PROC_POOL_BROKEN:
        return None
    if _PROC_POOL is None and time.time() < _PROC_POOL_COOLDOWN_UNTIL:
        # a pool was just torn down (deadline kill); an unjoined racer
        # thread may still be draining its last GPU chunk, and forking
        # while it runs is the hazard the pre-fork below exists to avoid.
        # Callers fall back to threads for this brief window.
        return None
    if _PROC_POOL is None:
        # Python warns that fork + live threads can deadlock the child;
        # our workers run only the dependency-free pure-Python CDCL and
        # never call back into torch, so that hazard doesn't apply — silence
        # the specific warning rather than scare every sweep user
        warnings.filterwarnings(
            "ignore", message=r"os\.fork\(\) was called",
            category=RuntimeWarning)
        try:
            n = max(2, os.cpu_count() or 2)
            pool = ProcessPoolExecutor(
                max_workers=n,
                mp_context=multiprocessing.get_context("fork"))
            # Pre-fork every worker NOW, while no racer thread is mid-walk:
            # lazy forking in a later window could otherwise snapshot a
            # walksat thread holding runtime locks. sleep() keeps all n
            # tasks occupied long enough that n distinct workers spawn.
            futures_wait([pool.submit(time.sleep, 0.05) for _ in range(n)])
            _PROC_POOL = pool
        except Exception:
            _PROC_POOL_BROKEN = True
            return None
    return _PROC_POOL


def _reset_pool() -> None:
    """Tear down the pool, killing any still-running proofs, so a window
    that blew its deadline cannot starve the next map's windows. The next
    sweep lazily builds a fresh pool (after a short cooldown that lets any
    leaked racer thread drain before we fork again)."""
    global _PROC_POOL, _PROC_POOL_COOLDOWN_UNTIL
    pool, _PROC_POOL = _PROC_POOL, None
    _PROC_POOL_COOLDOWN_UNTIL = time.time() + 2.0
    if pool is None:
        return
    try:
        for p in list(getattr(pool, "_processes", {}).values()):
            p.terminate()
        pool.shutdown(wait=False, cancel_futures=True)
    except Exception:
        pass


# Failures of the unjoined walk racer thread (a kernel that did not build
# or launch, a device that is missing, a walk model that is not a model).
# The reference racer swallows every exception; here each one is recorded
# and re-raised by the window that started the racer or, for a racer that
# outlived its window, by the next ``solve_window`` call.
_RACER_LOCK = threading.Lock()
_RACER_PENDING: List[BaseException] = []
_RACER_FAILURES = 0


def racer_failures() -> int:
    """How many walk racers of this process have failed so far."""
    return _RACER_FAILURES


def _note_racer_failure(err: BaseException) -> None:
    global _RACER_FAILURES
    with _RACER_LOCK:
        _RACER_FAILURES += 1
        _RACER_PENDING.append(err)


def _raise_racer_failure() -> None:
    with _RACER_LOCK:
        if not _RACER_PENDING:
            return
        err = _RACER_PENDING[0]
        _RACER_PENDING.clear()
    raise err


def solve_portfolio(cnf: CNF, *, seed: int = 0, steps: int = 8192,
                    chains_per_device: int = 32,
                    stop: Optional[Callable[[], bool]] = None,
                    ) -> Tuple[str, Optional[List[bool]]]:
    """Incomplete batched search first, complete solver as fallback.

    Deterministic for a fixed seed: the WalkSAT leg either certifies SAT
    (same model every run — the walk's torch.Generator is seeded) or the
    complete leg decides; there is no wall-clock race in this
    single-instance path. The walk runs on one device.
    """
    from . import SAT
    from .walksat_torch import solve_walksat
    from . import solve as solve_any

    status, model = solve_walksat(
        cnf, seed=seed, steps=steps, batch=chains_per_device, stop=stop)
    if status == SAT:
        return status, model
    # complete fallback (our CDCL)
    return solve_any(cnf, method="auto", stop=stop)


@dataclass
class SolveStats:
    """Reuse statistics of one incremental solve (see IIAttempt)."""
    learned_retained: Optional[int] = None   # clauses carried into this call
    conflicts: Optional[int] = None          # conflicts of this call
    warm_hamming: Optional[int] = None       # warm-start init vs final model
    via: str = ""
    # failed-assumption core of an UNSAT verdict (subset of the selector
    # assumptions; [] = formula UNSAT regardless of II); None when the
    # call was SAT/UNKNOWN or the backend produced no core
    core: Optional[List[int]] = None
    evicted: Optional[int] = None            # learnt clauses evicted so far
    # the complete solve was seeded with the session's best (near-miss)
    # assignment as CDCL saved phases — the walksat racer's asynchronous
    # feedback channel into the complete leg
    phase_hinted: bool = False
    # the walksat leg reused a cached dense pack of this II's projection
    # instead of re-packing (None = no walksat leg ran)
    pack_reused: Optional[bool] = None


class SolverSession:
    """Persistent incremental solver owned by the Fig. 3 loop.

    One layered formula + one live complete backend cover every candidate
    II of a sweep: ``solve_complete(ii)`` is ``solve(assumptions=[sel_ii])``
    on the persistent solver (our CDCL's learned clauses,
    activities, and phases all survive the II bump because delta layers are
    guarded, never retracted), and ``solve_ii(ii)`` additionally honours
    the incomplete/portfolio method semantics with WalkSAT warm-started
    from the best assignment any earlier II produced.

    The cold path (fresh encode+solve per II) remains available via
    ``MapperConfig(incremental=False)`` as the equivalence reference.

    Service extensions: ``max_learnt`` bounds the persistent CDCL's
    learnt-clause database (a long-lived session survives thousands of
    sweeps with bounded memory); every UNSAT verdict's failed-assumption
    core is recorded in ``proven_unsat`` so later sweeps through the same
    session skip provably-UNSAT IIs without re-solving them
    (``is_proven_unsat`` / ``proven_lower_bound``), and an *empty* core
    latches ``all_unsat`` — the formula is UNSAT at every II.
    """

    def __init__(self, enc_session, method: str = "auto", seed: int = 0,
                 walksat_steps: Optional[int] = None,
                 walksat_batch: Optional[int] = None,
                 max_learnt: Optional[int] = None):
        from . import resolve_method
        from ..encode import IncrementalEncoding
        self.enc = IncrementalEncoding(enc_session)
        self.raw_method = method
        self.complete_method = resolve_method(
            "auto" if method in ("walksat", "portfolio") else method)
        self.seed = seed
        # defaults track the cold legs' shapes (solve() for walksat,
        # solve_portfolio() for portfolio, one device)
        if method == "portfolio":
            self.walksat_steps = walksat_steps or 8192
            self.walksat_batch = walksat_batch or 32
        else:
            self.walksat_steps = walksat_steps or 20000
            self.walksat_batch = walksat_batch or 64
        self.max_learnt = max_learnt
        self._cdcl = None
        self._synced = 0                      # clauses pushed to the backend
        self.best_assign: Optional[List[bool]] = None   # layout-var space
        self.best_quality: Optional[int] = None         # unsat count (0=model)
        self._best_lock = threading.Lock()    # racer threads update warm state
        # the layered formula and the pack caches: a walk racer packs its
        # window (project + pack) on its own thread, possibly after its
        # window closed, while the sweep already encodes the next window's
        # layers — projecting a half-built layer fails, so both hold this
        self._enc_lock = threading.RLock()
        self.n_solves = 0
        # II -> failed-assumption core that refuted it (proof, not budget)
        self.proven_unsat: Dict[int, Tuple[int, ...]] = {}
        self.all_unsat = False                # an empty core arrived
        self.pruned_total = 0                 # IIs skipped via a recorded core
        # asynchronous racer->complete feedback accounting: near-miss
        # assignments accepted into the warm state, and phase hints handed
        # out to complete solves (see phase_hint())
        self.near_miss_updates = 0
        self.phase_hints_served = 0
        # dense-pack caches for the walksat legs: per-II host packs and the
        # last stacked window pack, both keyed on the projection's identity
        # (arena literal count, n_vars) — the formula is append-only, so an
        # unchanged (length, vars) pair means an unchanged clause stream.
        # The per-II cache is LRU-bounded (``max_cached_packs``): a serving
        # process sweeps many IIs through one session, and each pack holds
        # dense O(clauses x max_len) tensors
        self._pack_np: "OrderedDict[int, Tuple[Tuple[int, int], object]]" \
            = OrderedDict()
        self._pack_window: Optional[Tuple[tuple, object]] = None
        self.max_cached_packs = 16
        self.pack_reuses = 0                  # cache hits across all legs
        self.pack_evictions = 0               # LRU drops from the pack cache

    # ------------------------------------------------------------- formula
    def ensure_ii(self, ii: int) -> None:
        with self._enc_lock:
            self.enc.ensure_ii(ii)

    def project(self, ii: int) -> CNF:
        with self._enc_lock:
            return self.enc.project(ii)

    def stats_for(self, ii: int):
        with self._enc_lock:
            return self.enc.stats_for(ii)

    # ------------------------------------------------------------ pack cache
    def host_pack(self, ii: int) -> Tuple[object, bool]:
        """Dense host pack of ``project(ii)``, cached. Returns (pack,
        reused). The session formula only ever grows (layers are guarded,
        never retracted), so (arena literal count, n_vars) identifies the
        projection's exact clause stream — a matching key means the cached
        pack is bit-identical to what ``pack_cnf_np`` would rebuild."""
        from .walksat_torch import pack_cnf_np
        with self._enc_lock:
            cnf = self.project(ii)
            key = (cnf.arena.n_lits, cnf.n_vars)
            hit = self._pack_np.get(ii)
            if hit is not None and hit[0] == key:
                self._pack_np.move_to_end(ii)
                self.pack_reuses += 1
                return hit[1], True
            pack = pack_cnf_np(cnf)
            self._pack_np[ii] = (key, pack)
            self._pack_np.move_to_end(ii)
            while len(self._pack_np) > self.max_cached_packs:
                self._pack_np.popitem(last=False)
                self.pack_evictions += 1
            return pack, False

    def packed_window(self, iis: List[int], cnfs: List[CNF],
                      ) -> Tuple[object, List[object], bool]:
        """Stacked device pack for a window of per-II projections, cached.
        Returns (packed, per-CNF host packs, reused). A warm sweep leg
        re-solving an unchanged window reuses the device tensors outright
        (zero packing); a grown window restacks from the per-II host-pack
        cache, repacking only the IIs whose projections changed."""
        from .walksat_torch import pack_cnf_window
        key = tuple((ii, c.arena.n_lits, c.n_vars)
                    for ii, c in zip(iis, cnfs))
        with self._enc_lock:
            cached = self._pack_window
            host = [self.host_pack(ii)[0] for ii in iis]
            if cached is not None and cached[0] == key:
                self.pack_reuses += 1
                return cached[1], host, True
            packed = pack_cnf_window(cnfs, host)
            self._pack_window = (key, packed)
            return packed, host, False

    def _backend(self):
        if self._cdcl is None:
            from .cdcl import CDCLSolver
            self._cdcl = CDCLSolver(max_learnt=self.max_learnt)
        return self._cdcl

    # --------------------------------------------------- UNSAT-core pruning
    def is_proven_unsat(self, ii: int) -> bool:
        """True when a failed-assumption core already refutes ``ii`` on
        this session's formula — solving it again is pure waste."""
        return self.all_unsat or ii in self.proven_unsat

    def note_core(self, ii: int, core: Optional[List[int]]) -> None:
        """Record an UNSAT verdict's failed-assumption core for ``ii``.
        Callers must only pass cores from *proven* UNSAT answers (the
        backends leave ``last_core=None`` on budget/stop UNKNOWNs, so a
        budget exhaustion can never be mislabeled as a refuted II)."""
        if core is None:
            return
        self.proven_unsat[ii] = tuple(core)
        if not core:
            # empty core: the refutation used no assumption at all — the
            # base formula is UNSAT, so every candidate II is
            self.all_unsat = True

    def proven_lower_bound(self, start_ii: int) -> int:
        """Smallest II >= ``start_ii`` not already refuted by a recorded
        core — the II lower bound this session can prove without solving."""
        ii = start_ii
        while self.is_proven_unsat(ii) and not self.all_unsat:
            ii += 1
        return ii

    @property
    def clauses_evicted(self) -> int:
        return self._cdcl.evicted_total if self._cdcl is not None else 0

    @property
    def learnt_db_size(self) -> int:
        return self._cdcl.learnt_db_size if self._cdcl is not None else 0

    def _sync(self):
        """Push clauses encoded since the last solve into the live solver
        (append-only: layers are guarded, nothing is ever retracted)."""
        backend = self._backend()
        inc = self.enc.inc
        if self._synced < len(inc.clauses):
            backend.add_clauses(inc.clauses[self._synced:], n_vars=inc.n_vars)
            self._synced = len(inc.clauses)
        return backend

    # -------------------------------------------------------------- solving
    def solve_complete(self, ii: int, stop: Optional[Callable[[], bool]] = None,
                       phase_hint: Optional[List[bool]] = None,
                       ) -> Tuple[str, Optional[List[bool]], SolveStats]:
        """Assumption-based solve of base + II's delta on the persistent
        complete backend."""
        self.ensure_ii(ii)
        assumptions = self.enc.assumptions(ii)
        backend = self._sync()
        stats = SolveStats(via=self.complete_method)
        stats.learned_retained = backend.n_learnt
        status, model = backend.solve(assumptions=assumptions, stop=stop,
                                      phase_hint=phase_hint)
        stats.conflicts = backend.last_conflicts
        stats.evicted = backend.evicted_total or None
        self.n_solves += 1
        from . import SAT, UNSAT
        if status == UNSAT:
            # the failed-assumption core proves this II infeasible on this
            # formula forever; backends leave it None on budget/stop
            # UNKNOWNs, so only real refutations are recorded
            stats.core = getattr(backend, "last_core", None)
            self.note_core(ii, stats.core)
        if status == SAT and model:
            self.update_best(model, 0)
        return status, model, stats

    def solve_ii(self, ii: int, stop: Optional[Callable[[], bool]] = None,
                 phase_hint: Optional[List[bool]] = None,
                 ) -> Tuple[str, Optional[List[bool]], SolveStats]:
        """Per-II solve honouring the session's method semantics:
        ``walksat`` = warm-started incomplete only; ``portfolio`` =
        warm-started WalkSAT first, persistent complete solver as the
        fallback/certificate; anything else = ``solve_complete``."""
        from . import SAT
        if self.raw_method not in ("walksat", "portfolio"):
            return self.solve_complete(ii, stop=stop, phase_hint=phase_hint)
        from .walksat_torch import solve_walksat
        init = self.warm_init()
        near: dict = {}
        cnf = self.project(ii)
        pack, reused = self.host_pack(ii)
        status, model = solve_walksat(
            cnf, seed=self.seed, steps=self.walksat_steps,
            batch=self.walksat_batch, stop=stop, init=init, near_miss=near,
            pack=pack)
        if status == SAT:
            stats = SolveStats(via="walksat", pack_reused=reused)
            if init is not None:
                stats.warm_hamming = _hamming(init, model)
            self.update_best(model, 0)
            self.n_solves += 1
            return status, model, stats
        if 0 in near:
            self.update_best(near[0][1], near[0][0])
        if self.raw_method == "walksat":
            self.n_solves += 1
            return status, None, SolveStats(via="walksat",
                                            pack_reused=reused)
        return self.solve_complete(ii, stop=stop, phase_hint=phase_hint)

    # ------------------------------------------------------------ warm state
    def warm_init(self) -> Optional[List[bool]]:
        return self.best_assign

    def update_best(self, assign: List[bool], n_unsat: int) -> None:
        """Keep the highest-quality recent assignment as the next warm
        start: a full model (n_unsat=0) always wins; a near-miss replaces
        only a worse (or absent) near-miss. Locked: the window racer
        thread and the complete leg both report here."""
        nv = self.enc.inc.n_base_vars or self.enc.inc.n_vars
        with self._best_lock:
            if n_unsat == 0 or self.best_quality is None \
                    or self.best_quality > n_unsat:
                self.best_assign = list(assign[:nv])
                self.best_quality = n_unsat
                if n_unsat > 0:
                    self.near_miss_updates += 1

    def warm_snapshot(self) -> Optional[List[bool]]:
        """Locked copy of the current best assignment (service-side read
        for near-shape admission)."""
        with self._best_lock:
            return None if self.best_assign is None \
                else list(self.best_assign)

    def adopt_warm(self, assign: List[bool]) -> None:
        """Seed the warm-start state from a *different* session's best
        assignment (near-shape admission): purely heuristic — WalkSAT
        restarts and CDCL phases start there, but no clauses, cores, or
        learnt facts transfer, so soundness is untouched. The donor's
        assignment is truncated/padded to this session's base variables
        and stored as a worst-quality near-miss, so any genuine model or
        near-miss this session produces immediately replaces it."""
        nv = self.enc.inc.n_base_vars or self.enc.inc.n_vars
        a = [bool(x) for x in assign[:nv]]
        a += [False] * (nv - len(a))
        with self._best_lock:
            if self.best_assign is None:
                self.best_assign = a
                self.best_quality = 1 << 30

    def phase_hint(self) -> Optional[List[bool]]:
        """The session's best assignment (model or near-miss) as a CDCL
        saved-phase seed — the channel through which the walksat racer's
        near-misses flow back into the complete leg asynchronously. A
        near-miss that almost satisfies the formula is a strong prior on
        the structured part of the assignment, so starting CDCL's phases
        there tends to reach either a model or the conflicting core
        faster. Locked copy (the racer updates concurrently)."""
        with self._best_lock:
            if self.best_assign is None:
                return None
            self.phase_hints_served += 1
            return list(self.best_assign)


def _hamming(a: List[bool], b: List[bool]) -> int:
    return sum(1 for x, y in zip(a, b) if bool(x) != bool(y))


@dataclass
class WindowResult:
    """Outcome of one candidate in a window solve."""
    status: str                      # SAT | UNSAT | UNKNOWN | CANCELLED
    model: Optional[List[bool]]
    via: str                         # "cdcl" | "walksat" | "cancel" ...
    # elapsed time from window start to this candidate's delivery — i.e.
    # queueing + solving, NOT the solver's own runtime (candidates share
    # a worker pool; a 0.1s solve that waited 5s reports 5.1s)
    solve_time: float
    stats: Optional[SolveStats] = None


def solve_window(cnfs: List[CNF], *, method: str = "auto", seed: int = 0,
                 use_walksat: Optional[bool] = None, walksat_steps: int = 8192,
                 walksat_batch: int = 24, walksat_delay: float = 0.75,
                 max_workers: Optional[int] = None,
                 deadline: Optional[float] = None,
                 accept: Optional[Callable[[int, List[bool]], bool]] = None,
                 session: Optional[SolverSession] = None,
                 iis: Optional[List[int]] = None,
                 race_flip: bool = True, flip_delay: float = 0.25,
                 ) -> List[WindowResult]:
    """Solve a window of K CNFs (candidate IIs, ascending) concurrently.

    ``accept(i, model)`` is invoked under the window lock whenever candidate
    ``i`` is certified SAT; returning True declares it a winner and cancels
    every candidate above it (their results become CANCELLED). Candidates
    *below* a winner always run to completion, so the caller can still
    identify the minimal feasible II. ``deadline`` (absolute time.time())
    aborts outstanding work with UNKNOWN.

    The batched-WalkSAT racer is *staged*: it sleeps for ``walksat_delay``
    seconds and starts walking only if the complete leg hasn't already
    resolved the window — easy windows (the common case on small kernels)
    never pay for it, hard SAT instances still get cracked while CDCL
    grinds on the proofs.

    With ``session`` (the incremental core), the complete leg is the
    session's one persistent assumption-based solver, lowest II first —
    learned clauses from candidate i carry straight into candidate i+1, so
    consecutive UNSAT proofs start warm instead of re-deriving the same
    conflicts in parallel cold solvers. ``cnfs`` must then be the session's
    per-II projections (``session.project(ii)``, ascending II order): the
    racer walks those, warm-started from the session's best assignment.

    ``race_flip`` (CDCL sessions only) additionally races a *second*
    complete solver per candidate: a cold CDCL on the projection, started
    from the opposite saved phases (all-True vs the persistent solver's
    all-False default), staged behind ``flip_delay`` like the WalkSAT
    racer. Whichever leg delivers first decides the candidate — the
    winner is reported in the result's ``via`` ("cdcl" = session leg,
    "cdcl-flip" = the flipped racer). A flip-leg UNSAT is a proof on
    base + that II's layer, so it is recorded in the session's
    proven-UNSAT registry exactly like a failed-assumption core.
    """
    from . import SAT, UNKNOWN, resolve_method, solve as solve_any

    _raise_racer_failure()   # a racer of an earlier window that failed late
    K = len(cnfs)
    t0 = time.time()
    results: List[Optional[WindowResult]] = [None] * K
    stops = [threading.Event() for _ in range(K)]
    closed = threading.Event()
    lock = threading.Lock()
    if method == "portfolio":   # portfolio semantics == complete + racer
        method, use_walksat = "auto", True
    method = resolve_method(method)
    complete = method == "cdcl"
    if use_walksat is None:
        use_walksat = True

    def past_deadline() -> bool:
        return deadline is not None and time.time() > deadline

    def deliver(i: int, status: str, model, via: str,
                stats: Optional[SolveStats] = None) -> None:
        with lock:
            if closed.is_set() or results[i] is not None:
                return
            accepted = False
            if status == SAT and accept is not None:
                accepted = accept(i, model)
                if not accepted and complete and (
                        via in ("walksat", "cdcl-flip")
                        or (stats is not None and stats.phase_hinted)):
                    # provisional: a racer-leg model — or a session-leg
                    # model whose search was steered by a racer phase
                    # hint — that fails the caller's acceptance (e.g.
                    # regalloc) must not decide this candidate: an
                    # unhinted solve may yet produce a model that passes,
                    # which is exactly what the sequential reference
                    # would have judged. Leave the candidate open (the
                    # session leg retries hinted SAT rejections unhinted).
                    return
            results[i] = WindowResult(status, model, via, time.time() - t0,
                                      stats)
            if session is not None and status == SAT and model:
                # recorded while the window is provably open (we hold the
                # lock and ``closed`` is unset), so a late racer thread
                # can never clobber a *later* window's warm-start state
                session.update_best(model, 0)
            stops[i].set()
            if accepted:
                for j in range(i + 1, K):
                    stops[j].set()

    def run_complete(i: int) -> None:
        if stops[i].is_set() or past_deadline():
            return
        status, model = solve_any(
            cnfs[i], method=method, seed=seed,
            stop=lambda: stops[i].is_set() or past_deadline())
        if status == UNKNOWN and (stops[i].is_set() or past_deadline()):
            return   # cancelled / timed out; filled in at the end
        deliver(i, status, model, method)

    def run_walksat() -> None:
        # the racer thread's whole body, packing included: whatever fails
        # in it is recorded and re-raised when the window closes
        try:
            walk()
        except Exception as err:
            _note_racer_failure(err)

    def walk() -> None:
        # staged start: no work at all if the complete leg wins the window
        # (or the deadline passes) inside the grace period
        if closed.wait(min(walksat_delay,
                           max(0.0, (deadline or 1e18) - time.time()))):
            return
        if past_deadline():
            return
        from .walksat_torch import solve_walksat_window
        inits = None
        near: dict = {}
        packed = hpacks = None
        if session is not None:
            warm = session.warm_init()
            if warm is not None:
                inits = [warm] * K
            if iis is not None:
                # session windows are per-II projections: reuse the cached
                # device/host packs, skipping packing when nothing changed
                packed, hpacks, _ = session.packed_window(iis, cnfs)

        def on_sat_cb(i: int, model) -> None:
            st = None
            if inits is not None:
                st = SolveStats(via="walksat",
                                warm_hamming=_hamming(inits[i], model))
            deliver(i, SAT, model, "walksat", st)   # also records warm state

        def on_near_miss_cb(i: int, n_unsat: int, assign) -> None:
            # stream near-misses into the session *while the walk runs* —
            # the session leg picks them up as CDCL phase hints for the
            # candidates it hasn't started yet. Guarded by the window
            # lock/closed pair like the final push below, so a late racer
            # can never pollute a later window's warm-start state.
            with lock:
                if not closed.is_set():
                    session.update_best(assign, n_unsat)

        solve_walksat_window(
            cnfs, seed=seed, steps=walksat_steps, batch=walksat_batch,
            stop=lambda: past_deadline() or all(s.is_set() for s in stops),
            should_skip=lambda i: stops[i].is_set(),
            on_sat=on_sat_cb, inits=inits,
            near_miss=near if session is not None else None,
            on_near_miss=on_near_miss_cb if session is not None else None,
            packed=packed, packs=hpacks)
        if session is not None:
            # this racer thread is deliberately unjoined and may drain
            # after solve_window has returned — near-misses from a closed
            # window must not clobber a later window's warm-start state
            with lock:
                if not closed.is_set():
                    for nu, a in near.values():
                        session.update_best(a, nu)

    def _start_racer() -> None:
        # Racer thread, deliberately not joined later: torch releases the
        # GIL inside its operators, so the racer (when its staged delay
        # elapses) overlaps the complete leg; when the window resolves
        # first, ``closed`` turns any late walksat delivery into a no-op and
        # the thread drains at its next stop poll instead of stalling our
        # return by up to one walk segment. Non-daemon so interpreter
        # shutdown waits for the drain rather than tearing down CUDA under
        # a live walk. Started only after the process-pool submissions so
        # worker forks never overlap fresh GPU work.
        if use_walksat and complete:
            threading.Thread(target=run_walksat, daemon=False).start()

    def run_complete_procs(futs: dict) -> None:
        """CDCL leg on the process pool: real parallelism for the UNSAT
        proofs. ``futs`` were submitted before the racer thread started so
        the workers fork before any new GPU work begins in this process."""
        global _PROC_POOL, _PROC_POOL_BROKEN
        abandoned = set()
        while True:
            with lock:
                pending = [i for i in range(K)
                           if results[i] is None and i not in abandoned]
            if not pending or past_deadline():
                break
            done, _ = futures_wait([futs[i] for i in pending], timeout=0.1,
                                   return_when=FIRST_COMPLETED)
            idx_of = {id(futs[i]): i for i in pending}
            for f in done:
                i = idx_of.get(id(f))
                if i is None:
                    continue
                try:
                    status, model = f.result()
                except Exception:
                    # worker died (e.g. spawn unsupported under this
                    # parent): never report UNKNOWN for a decidable
                    # instance — solve it in-process instead, and stop
                    # using the pool
                    _PROC_POOL_BROKEN, _PROC_POOL = True, None
                    run_complete(i)
                    continue
                deliver(i, status, model, method)
            # reap candidates cancelled by an accept() (or solved by the
            # racer): dequeue what we can, abandon what is already running
            # (its eventual result is discarded by the closed/result check)
            for i in range(K):
                if i in abandoned or i not in futs:
                    continue
                with lock:
                    dead = stops[i].is_set() and results[i] is None
                    solved_elsewhere = results[i] is not None
                if dead or solved_elsewhere:
                    if not futs[i].done():
                        futs[i].cancel()
                    if dead:
                        abandoned.add(i)
        # deadline break: dequeue whatever hasn't started yet; if proofs
        # are still *running* past the deadline, kill the whole pool —
        # workers have no cooperative stop, and a doomed unbounded UNSAT
        # proof would otherwise starve every later map's windows
        leftovers = False
        for f in futs.values():
            if not f.done() and not f.cancel():
                leftovers = True
        if leftovers and past_deadline():
            _reset_pool()

    def submit_procs() -> Optional[dict]:
        """Submit the window to the process pool (forking workers now,
        before the racer thread may touch the GPU). None => pool unusable."""
        global _PROC_POOL, _PROC_POOL_BROKEN
        pool = _proc_pool()
        if pool is None:
            return None
        from .cdcl import solve_arena_worker, solve_clauses_worker
        try:
            futs = {}
            for i in range(K):
                arena = getattr(cnfs[i], "arena", None)
                if arena is not None:
                    # ship the CSR arrays — two contiguous numpy buffers
                    # pickle far cheaper than a list of int tuples
                    futs[i] = pool.submit(solve_arena_worker,
                                          cnfs[i].n_vars,
                                          arena.lits_view(),
                                          arena.offs_view())
                else:
                    futs[i] = pool.submit(solve_clauses_worker,
                                          cnfs[i].n_vars, cnfs[i].clauses)
            return futs
        except Exception:
            _PROC_POOL_BROKEN, _PROC_POOL = True, None
            return None

    def run_session_leg() -> None:
        """The incremental complete leg: one persistent assumption-based
        solver, lowest II first. Sequential by design — candidate i's
        learned clauses are exactly what makes candidate i+1 cheap, which
        replaces the cold path's process-parallel independent proofs.

        Each candidate's solve is seeded with the session's best
        assignment as CDCL saved phases — near-misses the walksat racer
        banked while earlier candidates were being proven flow straight
        into later candidates' complete searches. A hinted SAT model the
        caller rejects (regalloc) is provisional (see ``deliver``); the
        leg then re-solves that candidate unhinted so its final verdict
        is the one the sequential reference would have produced."""
        for i in range(K):
            if past_deadline():
                break
            if stops[i].is_set():
                continue
            hint = session.phase_hint() if method == "cdcl" else None
            status, model, st = session.solve_complete(
                iis[i],
                stop=lambda i=i: stops[i].is_set() or past_deadline(),
                phase_hint=hint)
            if status == UNKNOWN and (stops[i].is_set() or past_deadline()):
                continue   # cancelled / timed out; filled in at the end
            st.phase_hinted = hint is not None
            deliver(i, status, model, method, st)
            if st.phase_hinted and status == SAT:
                with lock:
                    still_open = results[i] is None and not closed.is_set()
                if still_open and not stops[i].is_set():
                    status, model, st = session.solve_complete(
                        iis[i],
                        stop=lambda i=i: (stops[i].is_set()
                                          or past_deadline()))
                    if status == UNKNOWN and (stops[i].is_set()
                                              or past_deadline()):
                        continue
                    deliver(i, status, model, method, st)

    def run_flip_leg() -> None:
        """The second racing complete leg: a cold
        CDCL per candidate on the session's projection, started from the
        *opposite* saved phases — all-True where the persistent solver
        defaults to all-False — so the two legs walk complementary search
        trajectories over the same instances. Staged behind ``flip_delay``
        (easy windows the session leg resolves first never pay), lowest II
        first, skipping candidates already decided. An UNSAT here refutes
        base + that II's layer outright, so it feeds the session's
        proven-UNSAT registry like a failed-assumption core (core =
        [layer selector], never the empty all-UNSAT latch)."""
        if closed.wait(min(flip_delay,
                           max(0.0, (deadline or 1e18) - time.time()))):
            return
        from . import SAT as _SAT, UNSAT as _UNSAT
        from .cdcl import CDCLSolver
        for i in range(K):
            if stops[i].is_set() or past_deadline():
                continue
            solver = CDCLSolver(cnfs[i])
            status, model = solver.solve(
                phase_hint=[True] * cnfs[i].n_vars,
                stop=lambda i=i: stops[i].is_set() or past_deadline())
            if status not in (_SAT, _UNSAT):
                continue
            st = SolveStats(via="cdcl-flip",
                            conflicts=solver.last_conflicts)
            if status == _UNSAT:
                inc = session.enc.inc
                if inc.has_layer(iis[i]):
                    st.core = [inc.selector(iis[i])]
                    session.note_core(iis[i], st.core)
            deliver(i, status, model, "cdcl-flip", st)

    flip_thread: Optional[threading.Thread] = None
    if complete and session is not None:
        if iis is None or len(iis) != K:
            raise ValueError("session window solving needs one candidate "
                             f"II per CNF: got {iis!r} for {K} window(s)")
        _start_racer()
        if race_flip and method == "cdcl" and K:
            flip_thread = threading.Thread(target=run_flip_leg,
                                           daemon=False)
            flip_thread.start()
        run_session_leg()
    elif complete:
        futs = submit_procs() if method == "cdcl" else None
        _start_racer()
        if futs is not None:
            run_complete_procs(futs)
        else:
            # the fallback when the process pool is unavailable: a small
            # thread pool, lowest II first
            workers = max_workers or max(1, min(K, (os.cpu_count() or 2)))
            with ThreadPoolExecutor(max_workers=workers) as tpool:
                list(tpool.map(run_complete, range(K)))
    else:
        # incomplete-only window (method == "walksat")
        from .walksat_torch import solve_walksat_window
        warm = session.warm_init() if session is not None else None
        near: dict = {}
        packed = hpacks = None
        if session is not None and iis is not None:
            packed, hpacks, _ = session.packed_window(iis, cnfs)
        ws = solve_walksat_window(
            cnfs, seed=seed, steps=walksat_steps, batch=walksat_batch,
            stop=past_deadline, should_skip=lambda i: stops[i].is_set(),
            on_sat=lambda i, model: deliver(i, SAT, model, "walksat"),
            inits=[warm] * K if warm is not None else None,
            near_miss=near if session is not None else None,
            packed=packed, packs=hpacks)
        if session is not None:
            for nu, a in near.values():
                session.update_best(a, nu)
        for i, (status, model) in enumerate(ws):
            if status != SAT:      # SAT already delivered via on_sat
                deliver(i, status, model, "walksat")

    with lock:
        closed.set()
        for i in range(K):
            stops[i].set()   # ensure the racer's stop poll fires promptly
            if results[i] is None:
                via = "cancel" if stops[i].is_set() and not past_deadline() \
                    else "deadline"
                results[i] = WindowResult(
                    CANCELLED if via == "cancel" else UNKNOWN,
                    None, via, time.time() - t0)
    if flip_thread is not None:
        # the flip racer polls its stop event every few hundred CDCL
        # ticks, so this join is short; joining keeps flip threads from
        # piling up across consecutive windows of one sweep
        flip_thread.join(timeout=10.0)
    _raise_racer_failure()
    return results   # type: ignore[return-value]

