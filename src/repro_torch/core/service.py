"""Persistent mapping service: solver pool + canonical-DFG mapping cache.

The Fig. 3 loop made incremental *within* one kernel's II sweep
still rebuilds everything — layout, layered formula, live solver — on
every ``map_loop``/``run_suite``/``map_cgra`` call. A long-lived serving
process does better: repeated and structurally-similar requests should
skip encode+solve entirely or start warm. :class:`MappingService` is that
process-lifetime owner:

  * **mapping cache** — requests are keyed by the canonical DFG signature
    (full structural identity: ops, immediates, edges) plus the CGRA
    topology signature and the mapper config; an identical request
    returns the cached :class:`~repro_torch.core.mapper.MappingResult` without
    touching a solver (``via="cache"``).
  * **solver pool** — cache misses are routed to a pooled
    :class:`~repro_torch.core.sat.portfolio.SolverSession` keyed by
    (topology signature, DFG *shape class*): the shape class is exactly
    what the SAT encoding depends on (per-node mem-capability and the
    edge/distance structure — ops and immediates are irrelevant to the
    clauses), so any two requests in one class share a single persistent
    layered formula and live solver. A reused session starts with every
    learnt clause, variable activity, saved phase, and warm-start
    assignment its earlier requests derived — and with their
    failed-assumption cores, so the II sweep *skips* IIs the session has
    already refuted (``via="core"`` attempts, no solve).
  * **bounded memory** — pool sessions cap the persistent CDCL's learnt
    database (``max_learnt``, see ``CDCLSolver._reduce_db``) and the pool
    and cache are LRU-bounded, so a service process survives thousands of
    sweeps without unbounded growth.

``map_loop(..., service=svc)``, ``map_sweep(..., service=svc)`` and
``run_suite(..., service=svc)`` all route here; ``service=None`` (the
default everywhere) preserves the standalone one-shot behaviour.
``get_service()`` returns a process-wide default instance (used by
``launch/map_cgra.py --service`` and ``launch/serve.py``).

This is the port's copy of the JAX package's ``core/service.py``: the
same keys, counters and cache → disk → warm → cold path. A walk that a
request races (``solver="walksat"`` or a racing sweep) runs on the port's
default device (``repro_torch.device``).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from copy import copy
from dataclasses import astuple, dataclass, field
from typing import Dict, Hashable, Optional, Tuple

from .cgra import CGRA
from .dfg import DFG
from .encode import EncoderSession
from .mapper import MapperConfig, MappingResult, map_loop
from .sat.portfolio import SolverSession
from .store import MappingStore

# ----------------------------------------------------------------- keys


def topology_signature(cgra) -> Tuple:
    """Everything the encoding, register allocator, and simulator read off
    the fabric: geometry, inter-PE reachability, per-PE capability sets,
    and per-PE register counts. Both the legacy :class:`CGRA` adapter and
    the declarative :class:`repro_torch.core.arch.ArchSpec` expose it as
    ``signature()`` — equivalent homogeneous fabrics share one signature
    (and therefore one pooled session) regardless of front-end class."""
    return cgra.signature()


def _memo_sig(dfg: DFG, key: Tuple, compute):
    """Memoize a signature on the DFG instance (``DFG._sig_cache``, cleared
    by ``add``/``touch``) — both signatures walk every node and edge, and
    under serving load they dominate the cache-hit path otherwise."""
    cache = getattr(dfg, "_sig_cache", None)
    if cache is None:
        return compute()
    sig = cache.get(key)
    if sig is None:
        sig = cache[key] = compute()
    return sig


def shape_signature(dfg: DFG, arch=None) -> Tuple:
    """The DFG *shape class*: exactly what the SAT encoding depends on.

    The clause families (C1/C2/C3) read node count, per-node allowed-PE
    sets, and the edge/distance structure (ASAP/ALAP windows and MII
    derive from these) — never the opcodes or immediates themselves. Two
    DFGs with equal shape signatures therefore produce *identical* CNFs
    under one variable numbering, so they can share a pooled
    ``SolverSession`` (learnt clauses, phases, warm starts, and
    proven-UNSAT cores all transfer soundly).

    With ``arch`` the per-node component is the node's actual allowed-PE
    tuple on that fabric plus its op *latency* there (op-class capability
    and timing aware — on a heterogeneous fabric an ``add``-shaped and a
    ``mul``-shaped DFG must *not* share a session, and on a fabric with
    2-cycle multipliers two DFGs that differ only in which nodes are muls
    produce different C3 windows even when every PE runs every class);
    without it, the homogeneous-fabric abstraction (memory ops are the
    only capability split, all latencies 1) is used."""
    def compute() -> Tuple:
        if arch is None:
            nodes = tuple(
                (nid, dfg.nodes[nid].is_mem, len(dfg.nodes[nid].ins))
                for nid in sorted(dfg.nodes))
        else:
            lat_of = getattr(arch, "lat_of", lambda op: 1)
            nodes = tuple(
                (nid, arch.pes_for(dfg.nodes[nid].op),
                 lat_of(dfg.nodes[nid].op), len(dfg.nodes[nid].ins))
                for nid in sorted(dfg.nodes))
        edges = tuple(sorted(dfg.edges()))
        return (len(dfg.nodes), nodes, edges)

    key = ("shape", None if arch is None else arch.signature())
    return _memo_sig(dfg, key, compute)


def dfg_signature(dfg: DFG) -> Tuple:
    """Full canonical identity of the mapping *request*: shape plus ops
    and immediates (the simulator oracle and therefore the verified
    result depend on them). Node names are display-only and excluded, so
    re-traced copies of the same loop body hit the cache."""
    def compute() -> Tuple:
        nodes = tuple((nid, dfg.nodes[nid].op, dfg.nodes[nid].imm,
                       dfg.nodes[nid].ins) for nid in sorted(dfg.nodes))
        return (nodes,)
    return _memo_sig(dfg, ("dfg",), compute)


def near_shape_key(shape_sig: Tuple, delta: int = 1) -> Tuple:
    """Relax a shape signature to its (shape, delta) lattice bucket.

    The exact shape class demands identical per-node windows and edges —
    sound for *session sharing* (same CNF), but needlessly strict for
    *warm-start transfer*: a kernel variant with one rewired edge explores
    an almost-identical placement space. The near key keeps what the
    search landscape is made of — node/edge counts (quantised by
    ``delta+1``), the multiset of node kinds (capability/latency/indegree,
    node ids dropped), and the set of loop-carried distances — and drops
    the exact wiring. Two shapes in one bucket get *heuristic* state only
    (a donor session's best assignment as WalkSAT/phase seed via
    ``SolverSession.adopt_warm``); clauses, learnt facts, and UNSAT cores
    never cross buckets, so admission is always sound."""
    n, nodes, edges = shape_sig
    q = max(1, int(delta) + 1)
    kinds = tuple(sorted(set(node[1:] for node in nodes)))
    dists = tuple(sorted(set(e[2] for e in edges)))
    return (n // q, len(edges) // q, kinds, dists)


# ---------------------------------------------------------------- stats


@dataclass
class RequestStats:
    """Per-request reuse report, attached to ``MappingResult.service``."""
    via: str                       # "cache" | "disk" | "warm" | "cold"
    cache_hit: bool = False
    session_reused: bool = False
    near_seeded: bool = False      # fresh session warm-seeded from a
    #                                near-shape neighbour's best assignment
    iis_pruned: int = 0            # IIs skipped via failed-assumption cores
    clauses_evicted: int = 0       # learnt clauses evicted during this request
    learned_retained: int = 0      # learnt DB size after the request
    near_misses: int = 0           # racer near-misses banked as warm state
    phase_hints: int = 0           # CDCL solves seeded from that warm state
    request_time: float = 0.0


@dataclass
class ServiceStats:
    """Cumulative service counters (monotone over the process lifetime)."""
    requests: int = 0
    cache_hits: int = 0
    disk_hits: int = 0             # served from the shared disk store
    disk_writes: int = 0           # results persisted to the disk store
    near_hits: int = 0             # fresh sessions seeded from a near-shape
    #                                neighbour (the lattice admission rate)
    cores_preloaded: int = 0       # proven-UNSAT IIs adopted from the store
    cores_persisted: int = 0       # newly proven IIs written to the store
    sessions_created: int = 0
    sessions_reused: int = 0
    iis_pruned: int = 0
    clauses_evicted: int = 0
    near_misses: int = 0
    phase_hints: int = 0
    pack_reuses: int = 0           # walksat dense-pack cache hits
    pack_evictions: int = 0        # LRU drops from per-session pack caches
    cache_evictions: int = 0
    session_evictions: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class _PoolEntry:
    session: SolverSession
    lock: threading.Lock = field(default_factory=threading.Lock)
    requests: int = 0
    near_seeded: bool = False      # created warm off a lattice neighbour


# -------------------------------------------------------------- service


class MappingService:
    """Long-lived mapping front end: cache first, warm pooled session
    second, cold session only for a topology/shape never seen before.

    Thread-safe: the pool/cache dictionaries are guarded by one service
    lock, and each pooled session carries its own lock so concurrent
    requests for *different* shapes solve in parallel while two requests
    for the same shape serialise on their shared solver (its trail and
    learnt database are single-threaded state).
    """

    def __init__(self, max_sessions: int = 64, cache_size: int = 512,
                 max_learnt: Optional[int] = 100_000,
                 store: Optional[MappingStore] = None,
                 near_delta: int = 0):
        self.max_sessions = max_sessions
        self.cache_size = cache_size
        self.max_learnt = max_learnt
        # shared persistence (tentpole L1): results and proven-UNSAT cores
        # survive the process and are visible to sibling worker processes
        self.store = store
        # near-shape admission (tentpole L2): 0 disables; k>0 buckets shape
        # classes on the (shape, delta=k) lattice for warm-start transfer
        self.near_delta = near_delta
        self._pool: "OrderedDict[Hashable, _PoolEntry]" = OrderedDict()
        self._cache: "OrderedDict[Hashable, MappingResult]" = OrderedDict()
        # near-shape bucket -> exact session key of the latest session in
        # that bucket (the warm-state donor for the next new neighbour)
        self._near_index: Dict[Hashable, Hashable] = {}
        # RLock, not Lock: the async front door fans many threads into one
        # service, and the cache-insert path re-enters via properties
        self._lock = threading.RLock()
        self.stats = ServiceStats()

    # ------------------------------------------------------------ internals
    def _session_for(self, dfg: DFG, cgra: CGRA, cfg: MapperConfig,
                     ) -> Tuple[_PoolEntry, bool, Hashable]:
        """Get-or-create the pooled session for this request's
        (topology, shape class, solver-relevant config) key. The resolved
        learnt-DB cap is part of the key: a request that asks for a
        different memory bound must not silently inherit (or impose) a
        pooled session's cap."""
        cap = cfg.max_learnt if cfg.max_learnt is not None \
            else self.max_learnt
        shape = shape_signature(dfg, cgra)
        key = (topology_signature(cgra), shape,
               cfg.amo, cfg.solver, cfg.seed, cap)
        with self._lock:
            entry = self._pool.get(key)
            if entry is not None:
                self._pool.move_to_end(key)
                self.stats.sessions_reused += 1
                return entry, True, key
            entry = _PoolEntry(SolverSession(
                EncoderSession(dfg, cgra, cfg.amo), method=cfg.solver,
                seed=cfg.seed, max_learnt=cap))
            if self.store is not None:
                # adopt IIs any process ever proved UNSAT for this exact
                # session key — yesterday's lower bounds prune today's
                # sweep before the first solve
                for ii, core in self.store.cores_for(key).items():
                    entry.session.note_core(ii, list(core))
                    self.stats.cores_preloaded += 1
            if self.near_delta > 0:
                # heuristic-only warm transfer inside the lattice bucket
                nkey = key[:1] + (near_shape_key(shape, self.near_delta),) \
                    + key[2:]
                donor_key = self._near_index.get(nkey)
                donor = self._pool.get(donor_key) \
                    if donor_key is not None else None
                if donor is not None:
                    warm = donor.session.warm_snapshot()
                    if warm is not None:
                        entry.session.adopt_warm(warm)
                        entry.near_seeded = True
                        self.stats.near_hits += 1
                self._near_index[nkey] = key
            self._pool[key] = entry
            self.stats.sessions_created += 1
            while len(self._pool) > self.max_sessions:
                self._pool.popitem(last=False)
                self.stats.session_evictions += 1
            return entry, False, key

    def _cache_key(self, dfg: DFG, cgra: CGRA, cfg: MapperConfig,
                   sweep_width: int) -> Hashable:
        return (dfg_signature(dfg), topology_signature(cgra),
                astuple(cfg), sweep_width)

    # --------------------------------------------------------------- API
    def map(self, dfg: DFG, cgra: CGRA, cfg: Optional[MapperConfig] = None,
            sweep_width: int = 1, use_cache: bool = True) -> MappingResult:
        """Serve one mapping request.

        Identical requests (same canonical DFG, topology, config) return
        the cached result; same-*shape* requests reuse the pooled warm
        session (core-pruned IIs, retained learnt clauses); everything
        else runs a cold session that immediately joins the pool.
        ``use_cache=False`` forces a solve while still using the pool —
        the warm-vs-cold comparison knob for benchmarks. The returned
        result carries a :class:`RequestStats` in ``.service``; cached
        results are shallow copies sharing placement/attempt objects, so
        treat them as read-only.
        """
        cfg = cfg or MapperConfig()
        t0 = time.time()
        key = self._cache_key(dfg, cgra, cfg, sweep_width)
        with self._lock:
            self.stats.requests += 1
            if use_cache and key in self._cache:
                self._cache.move_to_end(key)
                self.stats.cache_hits += 1
                hit = copy(self._cache[key])
                hit.service = RequestStats(
                    via="cache", cache_hit=True,
                    request_time=time.time() - t0)
                return hit

        if use_cache and self.store is not None:
            disk = self.store.get_mapping(key)
            if isinstance(disk, MappingResult):
                # cold process, warm store: promote into the memory cache
                # so the next identical request never touches the disk
                disk.service = RequestStats(
                    via="disk", cache_hit=True,
                    request_time=time.time() - t0)
                with self._lock:
                    self.stats.disk_hits += 1
                    self._cache[key] = disk
                    self._cache.move_to_end(key)
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
                        self.stats.cache_evictions += 1
                return copy(disk)

        if not cfg.incremental:
            # cold escape hatch: the paper-faithful per-II reference path,
            # no session pooling (still cached — determinism is cheap)
            res = map_loop(dfg, cgra, cfg, sweep_width=sweep_width)
            res.service = RequestStats(via="cold",
                                       request_time=time.time() - t0)
        else:
            entry, reused, skey = self._session_for(dfg, cgra, cfg)
            with entry.lock:
                sess = entry.session
                entry.requests += 1
                pruned0 = sess.pruned_total
                evicted0 = sess.clauses_evicted
                nm0 = sess.near_miss_updates
                ph0 = sess.phase_hints_served
                pr0 = sess.pack_reuses
                pe0 = sess.pack_evictions
                cores0 = set(sess.proven_unsat)
                res = map_loop(dfg, cgra, cfg, sweep_width=sweep_width,
                               session=sess)
                res.service = RequestStats(
                    via="warm" if reused else "cold",
                    session_reused=reused,
                    near_seeded=entry.near_seeded and not reused,
                    iis_pruned=sess.pruned_total - pruned0,
                    clauses_evicted=sess.clauses_evicted - evicted0,
                    learned_retained=sess.learnt_db_size,
                    near_misses=sess.near_miss_updates - nm0,
                    phase_hints=sess.phase_hints_served - ph0,
                    request_time=time.time() - t0)
                new_cores = {ii: sess.proven_unsat[ii]
                             for ii in set(sess.proven_unsat) - cores0}
                pack_reuses = sess.pack_reuses - pr0
                pack_evictions = sess.pack_evictions - pe0
                witnesses = {}
                if self.store is not None:
                    for ii in new_cores:
                        try:
                            witnesses[ii] = sess.project(ii)
                        except Exception:
                            witnesses[ii] = None
            if self.store is not None:
                # persist this sweep's freshly proven-UNSAT IIs with their
                # refuted projection as a re-solvable witness — tomorrow's
                # cold sessions (any process) preload them as lower bounds
                for ii, core in sorted(new_cores.items()):
                    if self.store.put_core(skey, ii, core,
                                           witness=witnesses.get(ii)):
                        with self._lock:
                            self.stats.cores_persisted += 1
            with self._lock:
                self.stats.iis_pruned += res.service.iis_pruned
                self.stats.clauses_evicted += res.service.clauses_evicted
                self.stats.near_misses += res.service.near_misses
                self.stats.phase_hints += res.service.phase_hints
                self.stats.pack_reuses += pack_reuses
                self.stats.pack_evictions += pack_evictions

        if not res.timed_out:
            # a timed-out verdict reflects this request's budget, not the
            # problem — let an identical later request retry with its own
            with self._lock:
                self._cache[key] = res
                self._cache.move_to_end(key)
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
                    self.stats.cache_evictions += 1
            if self.store is not None and self.store.put_mapping(key, res):
                with self._lock:
                    self.stats.disk_writes += 1
        return res

    # ---------------------------------------------------------- inspection
    @property
    def n_sessions(self) -> int:
        with self._lock:
            return len(self._pool)

    @property
    def n_cached(self) -> int:
        with self._lock:
            return len(self._cache)

    def describe(self) -> Dict[str, int]:
        d = self.stats.snapshot()
        d["sessions"] = self.n_sessions
        d["cached_results"] = self.n_cached
        if self.store is not None:
            d["store"] = self.store.describe()
        return d


# ------------------------------------------------- process-wide default

_DEFAULT: Optional[MappingService] = None
_DEFAULT_LOCK = threading.Lock()


def get_service() -> MappingService:
    """The process-wide default service (launch entry points share it, so
    every report/request in one process benefits from the same warm
    pool)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MappingService()
        return _DEFAULT


def reset_service() -> None:
    """Drop the process-wide default (tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
