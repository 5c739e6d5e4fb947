"""SAT encoding of the modulo-scheduling mapping problem (paper §IV-C).

Literals are x_{n,p,c,it}: node ``n`` placed on PE ``p`` at kernel cycle ``c``
with KMS iteration label ``it``. Flat mobility-schedule time is
``t = it*II + c``; C3's Eq. 3 window generalises the paper's to per-op
latencies (lat(s) = producer's issue->result cycles):

    lat(s) - delta*II  <=  t_d - t_s  <=  (1 - delta)*II + lat(s) - 1

for an edge of loop-carried distance ``delta``: the consumer cannot issue
before the producer's result exists (lower bound), and the value — written
at t_s + lat(s), rewritten by the producer's next kernel instance II
cycles later — is gone from the non-rotating register file after
t_s + II + lat(s) - 1 (upper bound). With lat(s) = 1 everywhere this is
bit-for-bit the paper's window ``1 - delta*II <= t_d - t_s <=
(1 - delta)*II`` — the unit-latency CNF is unchanged down to clause order.

Clause families:
  C1  exactly-one position per node                  (paper Eq. 1)
  C2  at-most-one node per (PE, kernel cycle)        (paper Eq. 2)
      — plus, on multi-cycle fabrics, write-port conflicts: two nodes of
      *different* latencies on one PE whose completions fold to the same
      kernel cycle would write the single output register simultaneously.
      With equal latencies a completion clash implies an issue clash that
      Eq. 2 already forbids, so unit-latency fabrics emit zero extra
      clauses (the bit-parity guarantee holds).
  C3  per-edge adjacency + timing. The paper ORs Eq. 4/5 conjunction terms;
      given C1, that disjunction is equivalent to the implication form used
      here: for every destination literal w,  (¬w ∨ compatible-src-lits...).
      Delivery mode (internal vs. output register, Eq. 4 vs. 5) is resolved
      post-SAT by register allocation, which models both.

Emitter modes: the per-II families above exist twice. The default
``emitters="vector"`` path computes each family as one flat numpy block —
exploiting that a node's variables are laid out contiguously as
``var(n, t, p_idx) = base(n) + (t - asap(n)) * P(n) + p_idx + 1`` — and
extends the clause arena with a handful of array ops per family.
``emitters="legacy"`` keeps the original per-clause Python generators
(`c2_fold_groups` / `c2w_clauses` / `c3_clauses` + ``add_clause`` loops);
it is the pinned baseline for the encode microbenchmark and the oracle the
property tests compare against — the two modes are asserted bit-identical
(same clause order, same literal order) on the whole suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .cgra import CGRA
from .cnf import CNF, ClauseArena, IncrementalCNF
from .dfg import DFG
from .schedule import KMS, asap_alap, build_kms, node_latencies


@dataclass(frozen=True)
class Lit:
    node: int
    pe: int
    cycle: int
    iteration: int


# (iu, ju) index pairs of np.triu_indices(k, 1), memoised per k: the pair
# enumeration (0,1),(0,2),...,(1,2),... is exactly the nested i<j loop order
_TRIU_CACHE: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _triu(k: int) -> Tuple[np.ndarray, np.ndarray]:
    got = _TRIU_CACHE.get(k)
    if got is None:
        got = np.triu_indices(k, 1)
        _TRIU_CACHE[k] = got
    return got


def _neg_pairs(u: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Interleave (¬u, ¬w) rows into one flat binary-clause block."""
    flat = np.empty(u.size * 2, dtype=np.int64)
    flat[0::2] = -u
    flat[1::2] = -w
    return flat


def _concat(flats: List[np.ndarray], lens: List[np.ndarray],
            ) -> Tuple[np.ndarray, np.ndarray]:
    if not flats:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    return np.concatenate(flats), np.concatenate(lens)


class _C3Rows(NamedTuple):
    """Row-major (edge, td, pd) constants for the batched C3 emitter —
    see EncoderSession._c3_rows."""
    td: np.ndarray        # consumer flat time of the row's head literal
    a_s: np.ndarray       # producer ASAP / ALAP window
    b_s: np.ndarray
    lo0: np.ndarray       # window bounds: lo = lo0 - hi1*II,
    hi0: np.ndarray       #                hi = hi0 + (1-hi1)*II
    hi1: np.ndarray       # (hi1 == edge distance delta)
    head: np.ndarray      # head var (positive; emitted negated)
    npsel: np.ndarray     # |reachable src PEs| for the row's dst PE
    selstart: np.ndarray  # row's slice start into sel
    const: np.ndarray     # src var = const + ts*p_s + sel[...]
    p_s: np.ndarray
    sel: np.ndarray       # ragged concat of per-(edge, dst-PE) src-PE indices


class Encoding:
    """Result of one (cold) per-II encode.

    ``var_of`` / ``info`` — the per-II (n,p,c,it) <-> var dictionaries —
    are derived lazily from the session layout: the solver path never
    touches them (decode does, once, after SAT), so the hot encode path
    skips building two O(vars) dicts.
    """

    def __init__(self, cnf: CNF, kms: Optional[KMS], cgra: CGRA, dfg: DFG,
                 var_of: Optional[Dict[Tuple[int, int, int, int], int]] = None,
                 info: Optional[Dict[int, Lit]] = None,
                 stats: Optional[Dict[str, int]] = None,
                 layout: Optional["_Layout"] = None,
                 ii: Optional[int] = None,
                 lat: Optional[Dict[int, int]] = None):
        self.cnf = cnf
        self.cgra = cgra
        self.dfg = dfg
        self.stats: Dict[str, int] = stats or {}
        # audit metadata: family -> [start, end) clause-index range in the
        # arena, filled by EncoderSession.encode(). ``stats`` keeps the
        # historical counters ("c2" = fold + write-port combined); the
        # ranges split C2W out so repro.analysis.cnf_audit can slice each
        # family and cross-check it against its closed-form clause count.
        self.families: Dict[str, Tuple[int, int]] = {}
        self._kms = kms
        self._var_of = var_of
        self._info = info
        self._lay = layout
        self._ii = ii
        self._lat = lat

    @property
    def kms(self) -> KMS:
        """The II's kernel mobility schedule — lazy, like var_of/info: only
        decode/diagnostics read it, never the solve path."""
        if self._kms is None:
            self._kms = build_kms(self.dfg, self._ii, lat=self._lat)
        return self._kms

    @property
    def var_of(self) -> Dict[Tuple[int, int, int, int], int]:
        """(n,p,c,it) -> var."""
        if self._var_of is None:
            ii = self._ii
            self._var_of = {(n, p, t % ii, t // ii): v
                            for (n, p, t), v in self._lay.var_of_t.items()}
        return self._var_of

    @property
    def info(self) -> Dict[int, Lit]:
        """var -> literal info."""
        if self._info is None:
            ii = self._ii
            self._info = {v + 1: Lit(n, p, t % ii, t // ii)
                          for v, (n, p, t) in enumerate(self._lay.info_t)}
        return self._info

    def decode(self, model: Sequence[bool]) -> Dict[int, Tuple[int, int, int]]:
        """model[v-1] -> placement {node: (pe, cycle, iteration)}."""
        placement: Dict[int, Tuple[int, int, int]] = {}
        for var, lit in self.info.items():
            if model[var - 1]:
                if lit.node in placement:
                    raise ValueError(f"node {lit.node} assigned twice")
                placement[lit.node] = (lit.pe, lit.cycle, lit.iteration)
        missing = set(self.dfg.nodes) - set(placement)
        if missing:
            raise ValueError(f"unplaced nodes {sorted(missing)}")
        return placement


@dataclass
class _Layout:
    """II-independent clause structure shared by every II of a session.

    The KMS candidate set of a node is ``{(t % II, t // II) : t in
    [asap, alap]}`` — the underlying *flat times* t do not depend on II, so
    one variable per (node, PE, flat time) covers every candidate II with
    identical numbering. C1 (exactly-one per node) ranges over exactly those
    variables and is therefore II-independent too; it is built once here
    into its own clause arena and copied (one memcpy) into every per-II
    CNF. C2's skeleton — which variables share a (PE, flat-time) slot — is
    also fixed; only the fold ``t % II`` that merges slots changes per II.

    A node's variables are contiguous and t-major: ``var(n, t, p_idx) =
    base0[n] + (t - asap[n]) * npes[n] + p_idx + 1``. The vectorised
    emitters lean on that closed form to compute whole clause families
    without touching the dicts.
    """
    var_of_t: Dict[Tuple[int, int, int], int]      # (node, pe, t) -> var
    info_t: List[Tuple[int, int, int]]             # var-1 -> (node, pe, t)
    by_pt: Dict[Tuple[int, int], List[int]]        # (pe, t) -> vars
    pt_keys: List[Tuple[int, int]]                 # insertion-ordered keys
    c1_arena: ClauseArena                          # C1 clauses, CSR form
    c1_trivial: bool                               # C1 contains an empty clause
    n_vars: int                                    # layout vars + C1 aux
    n_c1: int
    base0: Dict[int, int]                          # node -> #vars before it
    npes: Dict[int, int]                           # node -> |allowed PEs|
    pt_blocks: List[np.ndarray]                    # by_pt values as int32 arrays
    pt_index: Dict[Tuple[int, int], int]           # key -> index into pt_blocks
    v_pe: np.ndarray                               # var-1 -> PE id
    v_t: np.ndarray                                # var-1 -> flat time
    v_lat: np.ndarray                              # var-1 -> node latency
    mixed_lat: bool                                # any two node latencies differ


class EncoderSession:
    """Holds II-independent precomputation (windows, allowed PEs, neighbour
    tables, and the full C1/variable layout) so the Fig. 3 iterative loop —
    and the parallel II-sweep engine in ``sweep.py`` — re-derive only the
    II-dependent C2 fold and C3 timing windows per candidate II.

    Incremental-encoding contract (relied on by ``sweep.py``):
      * variable numbering is identical for every II of one session (one var
        per (node, allowed PE, flat mobility time), created in a fixed
        order), so models/phase hints are comparable across IIs;
      * ``encode(ii)`` never mutates shared state — each call returns a
        fresh ``Encoding`` whose CNF starts from a copy of the shared C1
        arena, so concurrent solvers may consume them freely;
      * with the "sequential" (Sinz) AMO, C1 auxiliary variables live in the
        shared prefix and C2 auxiliaries are allocated per II *after* it, so
        the shared numbering is still stable.

    ``emitters`` selects the per-II clause emitters: ``"vector"`` (default)
    computes each family as flat numpy blocks, ``"legacy"`` runs the
    original per-clause generator loops. Both produce bit-identical clause
    streams (property-tested); legacy is kept as the pinned benchmark
    baseline and test oracle.
    """

    def __init__(self, dfg: DFG, cgra: CGRA, amo: str = "pairwise",
                 emitters: str = "vector"):
        dfg.validate()
        if emitters not in ("vector", "legacy"):
            raise ValueError(f"unknown emitters mode {emitters!r}")
        self.dfg = dfg
        self.cgra = cgra          # a CGRA or a heterogeneous ArchSpec
        self.amo = amo
        self.emitters = emitters
        # per-node issue->result latencies from the fabric's op-class
        # latency table (all 1 on the paper's fabric): they stretch the
        # ASAP/ALAP windows and shift every C3 dependency window below
        self.lat = node_latencies(dfg, cgra)
        self.asap, self.alap, self.length = asap_alap(dfg, self.lat)
        # op-class -> PE compatibility: a node's candidate literals range
        # over exactly the PEs capable of its op class (mem/mul/alu), so
        # capability constraints are enforced by variable layout + C1
        # rather than by extra clauses (generalises the old can_mem check)
        self.allowed_pes: Dict[int, List[int]] = {
            nid: list(cgra.pes_for(node.op))
            for nid, node in dfg.nodes.items()
        }
        # src PE -> PEs that can consume from it (self + neighbours)
        self.consumers: List[List[int]] = [
            sorted({p} | set(cgra.neighbors(p))) for p in range(cgra.n_pes)
        ]
        # dst PE -> frozenset of src PEs that can feed it
        self.reach_from: List[frozenset] = [
            frozenset(ps for ps in range(cgra.n_pes) if cgra.reachable(ps, pd))
            for pd in range(cgra.n_pes)
        ]
        self._layout: Optional[_Layout] = None
        # II-independent per-clause-row constants for the batched C3
        # emitter (built lazily by _c3_rows)
        self._c3_row_cache: Optional[_C3Rows] = None

    # --------------------------------------------------- II-independent part
    def _ensure_layout(self) -> _Layout:
        if self._layout is not None:
            return self._layout
        dfg = self.dfg
        base = CNF()
        var_of_t: Dict[Tuple[int, int, int], int] = {}
        info_t: List[Tuple[int, int, int]] = []
        by_node: Dict[int, List[int]] = {}
        by_pt: Dict[Tuple[int, int], List[int]] = {}
        base0: Dict[int, int] = {}
        npes: Dict[int, int] = {}
        v_pe_parts: List[np.ndarray] = []
        v_t_parts: List[np.ndarray] = []
        v_lat_parts: List[np.ndarray] = []
        # one var per (node, allowed PE, flat mobility time); creation order
        # (node, then time, then PE) matches the historical per-II encoder,
        # because KMS candidates enumerate the same flat times in order.
        for nid in dfg.nodes:
            a, b = self.asap[nid], self.alap[nid]
            pes = self.allowed_pes[nid]
            base0[nid] = base.n_vars
            npes[nid] = len(pes)
            lits = []
            for t in range(a, b + 1):
                for p in pes:
                    v = base.new_var()
                    var_of_t[(nid, p, t)] = v
                    info_t.append((nid, p, t))
                    lits.append(v)
                    by_pt.setdefault((p, t), []).append(v)
            by_node[nid] = lits
            if pes:
                nt = b - a + 1
                v_pe_parts.append(np.tile(np.asarray(pes, np.int64), nt))
                v_t_parts.append(
                    np.repeat(np.arange(a, b + 1, dtype=np.int64), len(pes)))
                v_lat_parts.append(
                    np.full(nt * len(pes), self.lat[nid], dtype=np.int64))
        # C1: exactly one position per node (Eq. 1) — II-independent
        for nid, lits in by_node.items():
            if not lits:
                # node has no legal PE at any II -> trivially UNSAT
                base.add_clause([])
                continue
            base.exactly_one(lits, self.amo)
        empty = np.zeros(0, dtype=np.int64)
        self._layout = _Layout(
            var_of_t=var_of_t, info_t=info_t, by_pt=by_pt,
            pt_keys=list(by_pt), c1_arena=base.arena,
            c1_trivial=base.trivially_unsat,
            n_vars=base.n_vars, n_c1=base.n_clauses,
            base0=base0, npes=npes,
            pt_blocks=[np.asarray(v, dtype=np.int64)
                       for v in by_pt.values()],
            pt_index={k: i for i, k in enumerate(by_pt)},
            v_pe=np.concatenate(v_pe_parts) if v_pe_parts else empty,
            v_t=np.concatenate(v_t_parts) if v_t_parts else empty,
            v_lat=np.concatenate(v_lat_parts) if v_lat_parts else empty,
            mixed_lat=len(set(self.lat.values())) > 1)
        return self._layout

    # ------------------------------------------- per-II clause generators
    # Single source of truth for the II-dependent clause families: both
    # the cold per-II encoder (encode) and the layered incremental one
    # (IncrementalEncoding.ensure_ii) consume these. The legacy per-clause
    # generators below are the pinned oracle; the _*_flat methods are the
    # vectorised emitters asserted bit-identical to them.
    def c2_fold_groups(self, ii: int) -> List[List[Tuple[int, int]]]:
        """Groups of (PE, flat-time) slot keys merged by the ``t % II``
        fold — each group's variables share one kernel-cycle slot."""
        lay = self._ensure_layout()
        by_slot: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for (p, t) in lay.pt_keys:
            by_slot.setdefault((p, t % ii), []).append((p, t))
        return list(by_slot.values())

    def c2w_clauses(self, ii: int):
        """Yield output-register *write-port* conflict clauses for ``ii``:
        at most one result may land on a PE's output register per kernel
        cycle. C2 constrains issue slots, and with uniform latencies a
        completion clash implies an issue clash — so clauses are emitted
        only for pairs of nodes with *different* latencies (none at all
        on a unit-latency fabric, preserving CNF bit-parity)."""
        lay = self._ensure_layout()
        lat = self.lat
        groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for v, (n, p, t) in enumerate(lay.info_t):
            groups.setdefault((p, (t + lat[n]) % ii), []).append(
                (v + 1, lat[n]))
        for members in groups.values():
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    (u, lu), (w, lw) = members[a], members[b]
                    if lu != lw:
                        yield [-u, -w]

    def c3_clauses(self, ii: int):
        """Yield C3 per-edge implication clauses (Eq. 3/4/5 window) for
        ``ii`` — the only clause family whose structure depends on II.
        The window is shifted by the producer's latency (see module
        docstring); lat == 1 reproduces the paper's window exactly."""
        lay = self._ensure_layout()
        var_of_t = lay.var_of_t
        for src, dst, delta in self.dfg.edges():
            lat_s = self.lat[src]
            lo = lat_s - delta * ii
            hi = (1 - delta) * ii + lat_s - 1
            src_times = range(self.asap[src], self.alap[src] + 1)
            src_pes = self.allowed_pes[src]
            for td in range(self.asap[dst], self.alap[dst] + 1):
                ok_times = [ts for ts in src_times if lo <= td - ts <= hi]
                for pd in self.allowed_pes[dst]:
                    w = var_of_t[(dst, pd, td)]
                    reach = self.reach_from[pd]
                    support = [var_of_t[(src, ps, ts)]
                               for ts in ok_times
                               for ps in src_pes
                               if ps in reach]
                    yield [-w] + support

    # ------------------------------------------------- vectorised emitters
    def _c2_fold_flat(self, ii: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pairwise C2 fold as one flat block: per fold group, the ¬u∨¬w
        pairs in i<j order — the stream ``at_most_one(group_lits)`` emits."""
        lay = self._ensure_layout()
        flats: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for group in self.c2_fold_groups(ii):
            if len(group) == 1:
                arr = lay.pt_blocks[lay.pt_index[group[0]]]
            else:
                arr = np.concatenate(
                    [lay.pt_blocks[lay.pt_index[k]] for k in group])
            k = arr.size
            if k <= 1:
                continue
            iu, ju = _triu(k)
            flats.append(_neg_pairs(arr[iu], arr[ju]))
            lens.append(np.full(iu.size, 2, dtype=np.int64))
        return _concat(flats, lens)

    def _c2_delta_flat(self, ii: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pairwise C2 fold, *cross-time pairs only* (the incremental
        delta; within-slot pairs live in the base skeleton). Order matches
        the legacy loop: fold groups in order; inside a group, slot-block
        pairs (a,b) in lex order, then the (u,w) cartesian product
        row-major."""
        lay = self._ensure_layout()
        flats: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for group in self.c2_fold_groups(ii):
            if len(group) <= 1:
                continue
            blocks = [lay.pt_blocks[lay.pt_index[k]] for k in group]
            sizes = np.asarray([b.size for b in blocks], dtype=np.int64)
            ai, bi = _triu(len(blocks))
            cnt = sizes[ai] * sizes[bi]
            total = int(cnt.sum())
            if total == 0:
                continue
            rep = np.repeat(np.arange(ai.size), cnt)
            m = np.arange(total, dtype=np.int64) \
                - np.repeat(np.cumsum(cnt) - cnt, cnt)
            cat = np.concatenate(blocks)
            starts = np.cumsum(sizes) - sizes
            wb = sizes[bi][rep]
            u = cat[starts[ai][rep] + m // wb]
            w = cat[starts[bi][rep] + m % wb]
            flats.append(_neg_pairs(u, w))
            lens.append(np.full(total, 2, dtype=np.int64))
        return _concat(flats, lens)

    def _c2w_flat(self, ii: int) -> Tuple[np.ndarray, np.ndarray]:
        """Write-port conflicts as a flat block — same grouping-by-first-
        occurrence and var-major member order as ``c2w_clauses``. Uniform
        latencies short-circuit to zero clauses (as the generator does)."""
        lay = self._ensure_layout()
        empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        if not lay.mixed_lat or lay.v_t.size == 0:
            return empty
        keys = lay.v_pe * ii + (lay.v_t + lay.v_lat) % ii
        _, first_idx, inv = np.unique(keys, return_index=True,
                                      return_inverse=True)
        # rank sorted-unique groups by first occurrence (dict insertion order)
        grank = np.empty(first_idx.size, dtype=np.int64)
        grank[np.argsort(first_idx, kind="stable")] = \
            np.arange(first_idx.size)
        g = grank[inv]
        order = np.argsort(g, kind="stable")   # group-major, var-order within
        counts = np.bincount(g)
        starts = np.cumsum(counts) - counts
        vs = order + 1                         # member var ids, group-major
        lats = lay.v_lat[order]
        flats: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for gi in range(counts.size):
            k = int(counts[gi])
            if k < 2:
                continue
            s = int(starts[gi])
            mem_v = vs[s:s + k]
            mem_l = lats[s:s + k]
            iu, ju = _triu(k)
            mask = mem_l[iu] != mem_l[ju]
            if not mask.any():
                continue
            flats.append(_neg_pairs(mem_v[iu[mask]], mem_v[ju[mask]]))
            lens.append(np.full(int(mask.sum()), 2, dtype=np.int64))
        return _concat(flats, lens)

    def _c3_rows(self) -> "_C3Rows":
        """II-independent constants of every C3 clause row, batched.

        C3's clause set has one clause per (edge, td, pd) — the *rows* —
        and only the producer-time window per row moves with II. Everything
        else (the head literal, the per-row PE selection and its slice of
        the concatenated selection table, the window's affine coefficients)
        is fixed, so it is materialised once here as flat row-major arrays
        and each ``_c3_flat(ii)`` call is ~a dozen whole-array ops total,
        independent of edge count. Built on first use, ~O(rows)."""
        if self._c3_row_cache is not None:
            return self._c3_row_cache
        lay = self._ensure_layout()
        parts: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("td", "a_s", "b_s", "lo0", "hi0", "hi1",
                            "head", "npsel", "selstart", "const", "p_s")}
        sel_parts: List[np.ndarray] = []
        sel_top = 0
        for src, dst, delta in self.dfg.edges():
            p_d, p_s = lay.npes[dst], lay.npes[src]
            if p_d == 0:
                continue    # no dst literals -> the generator yields nothing
            src_pes = self.allowed_pes[src]
            sels = [np.asarray([i for i, ps in enumerate(src_pes)
                                if ps in self.reach_from[pd]],
                               dtype=np.int64)
                    for pd in self.allowed_pes[dst]]
            npsel = np.asarray([s.size for s in sels], dtype=np.int64)
            selstart = sel_top + np.cumsum(npsel) - npsel
            sel_parts.extend(sels)
            sel_top += int(npsel.sum())
            lat_s = self.lat[src]
            a_s, b_s = self.asap[src], self.alap[src]
            a_d, b_d = self.asap[dst], self.alap[dst]
            ntd = b_d - a_d + 1
            n_rows = ntd * p_d
            td = np.repeat(np.arange(a_d, b_d + 1, dtype=np.int64), p_d)
            parts["td"].append(td)
            parts["a_s"].append(np.full(n_rows, a_s, dtype=np.int64))
            parts["b_s"].append(np.full(n_rows, b_s, dtype=np.int64))
            # window bounds are affine in II: lo = lo0 + ii*(-delta),
            # hi = hi0 + ii*(1-delta) -> store the coefficients
            parts["lo0"].append(np.full(n_rows, lat_s, dtype=np.int64))
            parts["hi0"].append(np.full(n_rows, lat_s - 1, dtype=np.int64))
            parts["hi1"].append(np.full(n_rows, delta, dtype=np.int64))
            parts["head"].append(
                lay.base0[dst] + 1 + (td - a_d) * p_d
                + np.tile(np.arange(p_d, dtype=np.int64), ntd))
            parts["npsel"].append(np.tile(npsel, ntd))
            parts["selstart"].append(np.tile(selstart, ntd))
            # var(src, ts, psel) = const + ts*p_s + psel
            parts["const"].append(
                np.full(n_rows, lay.base0[src] + 1 - a_s * p_s,
                        dtype=np.int64))
            parts["p_s"].append(np.full(n_rows, p_s, dtype=np.int64))
        empty = np.zeros(0, dtype=np.int64)

        def cat(key: str) -> np.ndarray:
            return np.concatenate(parts[key]) if parts[key] else empty

        self._c3_row_cache = _C3Rows(
            td=cat("td"), a_s=cat("a_s"), b_s=cat("b_s"),
            lo0=cat("lo0"), hi0=cat("hi0"), hi1=cat("hi1"),
            head=cat("head"), npsel=cat("npsel"), selstart=cat("selstart"),
            const=cat("const"), p_s=cat("p_s"),
            sel=np.concatenate(sel_parts) if sel_parts else empty)
        return self._c3_row_cache

    def _c3_flat(self, ii: int) -> Tuple[np.ndarray, np.ndarray]:
        """C3 as one flat block over all edges. The legal producer times
        for a row form the contiguous range ``[max(asap_s, td-hi),
        min(alap_s, td-lo)]``; with the II-independent row constants from
        :meth:`_c3_rows`, each clause — head ``¬w`` plus its ts-major/
        psel-minor support — is a closed-form gather."""
        rows = self._c3_rows()
        n_rows = rows.td.size
        if n_rows == 0:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        # lo = lat_s - delta*ii ; hi = (1 - delta)*ii + lat_s - 1
        lo = rows.lo0 - rows.hi1 * ii
        hi = rows.hi0 + (1 - rows.hi1) * ii
        ts0 = np.maximum(rows.a_s, rows.td - hi)
        ntim = np.minimum(rows.b_s, rows.td - lo) - ts0 + 1
        np.maximum(ntim, 0, out=ntim)
        sup = ntim * rows.npsel
        lens = sup + 1
        offs = np.empty(n_rows + 1, dtype=np.int64)
        offs[0] = 0
        np.cumsum(lens, out=offs[1:])
        flat = np.empty(int(offs[-1]), dtype=np.int64)
        flat[offs[:-1]] = -rows.head
        total_sup = int(sup.sum())
        if total_sup:
            r = np.repeat(np.arange(n_rows), sup)
            m = np.arange(total_sup, dtype=np.int64) \
                - np.repeat(offs[:-1] - np.arange(n_rows), sup)
            nj = rows.npsel[r]
            k = m // nj
            val = rows.const[r] + (ts0[r] + k) * rows.p_s[r] \
                + rows.sel[rows.selstart[r] + m - k * nj]
            flat[np.repeat(offs[:-1] + 1, sup) + m] = val
        return flat, lens

    # ---------------------------------------------------------------- build
    def encode(self, ii: int, emitters: Optional[str] = None) -> Encoding:
        mode = self.emitters if emitters is None else emitters
        dfg, cgra = self.dfg, self.cgra
        lay = self._ensure_layout()

        cnf = CNF()
        cnf.n_vars = lay.n_vars
        cnf.arena = lay.c1_arena.copy()      # shared C1, one memcpy
        cnf.trivially_unsat = lay.c1_trivial
        n_c1 = lay.n_c1

        n_c2 = cnf.n_clauses
        # C2: at most one node per (PE, kernel cycle) (Eq. 2) — fold the
        # precomputed (PE, flat-time) slot skeleton by t % II
        if mode == "vector" and self.amo == "pairwise":
            cnf.extend_flat(*self._c2_fold_flat(ii))
        else:
            for group in self.c2_fold_groups(ii):
                lits = [v for key in group for v in lay.by_pt[key]]
                cnf.at_most_one(lits, self.amo)
        c2w_start = cnf.n_clauses
        # write-port conflicts between mixed-latency nodes (empty on
        # unit-latency fabrics), counted with C2 as resource conflicts
        if mode == "vector":
            cnf.extend_flat(*self._c2w_flat(ii))
        else:
            for cl in self.c2w_clauses(ii):
                cnf.add_clause(cl)
        n_c2 = cnf.n_clauses - n_c2

        n_c3 = cnf.n_clauses
        if mode == "vector":
            cnf.extend_flat(*self._c3_flat(ii))
        else:
            for cl in self.c3_clauses(ii):
                cnf.add_clause(cl)
        n_c3 = cnf.n_clauses - n_c3

        enc = Encoding(cnf=cnf, kms=None, cgra=cgra, dfg=dfg,
                       layout=lay, ii=ii, lat=self.lat)
        enc.stats = {"vars": cnf.n_vars, "clauses": cnf.n_clauses,
                     "c1": n_c1, "c2": n_c2, "c3": n_c3}
        c3_start = cnf.n_clauses - n_c3
        enc.families = {"c1": (0, n_c1), "c2": (n_c1, c2w_start),
                        "c2w": (c2w_start, c3_start),
                        "c3": (c3_start, cnf.n_clauses)}
        return enc


class IncrementalEncoding:
    """One persistent layered formula covering every II of a session.

    The II-independent structure — the (node, PE, flat-time) variable
    layout, C1 exactly-one, and the *within-slot* part of C2 (two nodes on
    the same (PE, flat time) collide at every II) — forms the unguarded
    base layer of an :class:`IncrementalCNF`. Each candidate II adds one
    delta layer guarded by a fresh selector literal:

      * the C2 *fold*: at-most-one across distinct flat times that the
        ``t % II`` fold merges into one kernel slot (for the pairwise AMO
        this is exactly the cross-time pairs; for the Sinz AMO the whole
        folded group is re-encoded in the layer, the base skeleton staying
        as redundant-but-sound helper clauses);
      * C3's per-edge timing windows for that II.

    "Try II=k" is then ``solve(assumptions=assumptions_for(k))`` on the one
    formula — no re-encode, and a solver that stays loaded keeps every
    learned clause across the II bump (assumptions are decisions, not
    axioms, so all learnt clauses remain globally valid).

    Variable numbering of the layout prefix is identical to
    ``EncoderSession.encode(ii)``'s, so models from assumption solves,
    from per-II projections (``project(ii)``), and from the cold path are
    all decoded by the same ``decode(ii, model)``.
    """

    def __init__(self, session: EncoderSession):
        self.session = session
        lay = session._ensure_layout()
        self._lay = lay
        inc = IncrementalCNF()
        inc.n_vars = lay.n_vars
        inc.arena = lay.c1_arena.copy()          # shared C1, one memcpy
        inc.trivially_unsat = lay.c1_trivial
        self.n_c1 = lay.n_c1
        # within-slot C2 skeleton: same (PE, flat-time) collisions hold at
        # every II (t1 == t2  =>  t1 % ii == t2 % ii); always pairwise,
        # emitted as one block (the stream per-key at_most_one would emit)
        flats: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for blk in lay.pt_blocks:
            k = blk.size
            if k <= 1:
                continue
            iu, ju = _triu(k)
            flats.append(_neg_pairs(blk[iu], blk[ju]))
            lens.append(np.full(iu.size, 2, dtype=np.int64))
        inc.extend_flat(*_concat(flats, lens))
        self.inc = inc
        self.n_base = inc.n_clauses
        # audit metadata: clause-index ranges of the base families and —
        # per encoded layer — of each II-dependent family, mirroring
        # Encoding.families on the cold path. "c2s" is the within-slot C2
        # skeleton (base), "c2" the per-II cross-time fold delta.
        self.base_families: Dict[str, Tuple[int, int]] = {
            "c1": (0, self.n_c1), "c2s": (self.n_c1, self.n_base)}
        self.layer_families: Dict[Hashable, Dict[str, Tuple[int, int]]] = {}
        # per-II projection memo: layers are immutable once encoded, so a
        # projection only changes when n_vars has grown (new layers add
        # selector/aux vars and project() stamps the current n_vars)
        self._proj_cache: Dict[Hashable, Tuple[int, CNF]] = {}

    # ---------------------------------------------------------------- build
    def ensure_ii(self, ii: int) -> int:
        """Encode the delta layer for ``ii`` if absent; returns its selector."""
        inc = self.inc
        if inc.has_layer(ii):
            return inc.selector(ii)
        session, lay = self.session, self._lay
        mode = session.emitters
        sel = inc.begin_layer(ii)
        # C2 fold: slots merged by t % II (shared generator with the cold
        # encoder — see EncoderSession.c2_fold_groups)
        if mode == "vector" and session.amo == "pairwise":
            # cross-time pairs only — within-slot pairs live in the base;
            # extend_flat guards every row with ¬selector
            inc.extend_flat(*session._c2_delta_flat(ii))
        else:
            for group in session.c2_fold_groups(ii):
                if len(group) <= 1:
                    continue
                if session.amo == "pairwise":
                    # cross-time pairs only — within-slot pairs live in the base
                    for a in range(len(group)):
                        for b in range(a + 1, len(group)):
                            for u in lay.by_pt[group[a]]:
                                for w in lay.by_pt[group[b]]:
                                    inc.add(-u, -w)
                else:
                    # Sinz over the whole folded group (aux vars live in the
                    # layer); the base pairwise skeleton stays as redundant
                    # helper clauses
                    lits = [v for key in group for v in lay.by_pt[key]]
                    inc.at_most_one(lits, session.amo)
        c2w_start = inc.n_clauses
        # write-port conflicts between mixed-latency nodes — same family
        # as the cold encoder (empty on unit-latency fabrics); then C3
        # timing windows for this II, clauses guarded by the layer selector
        if mode == "vector":
            inc.extend_flat(*session._c2w_flat(ii))
            c3_start = inc.n_clauses
            inc.extend_flat(*session._c3_flat(ii))
        else:
            for cl in session.c2w_clauses(ii):
                inc.add_clause(cl)
            c3_start = inc.n_clauses
            for cl in session.c3_clauses(ii):
                inc.add_clause(cl)
        inc.end_layer()
        start, end = inc.layer_slice(ii)
        self.layer_families[ii] = {"c2": (start, c2w_start),
                                   "c2w": (c2w_start, c3_start),
                                   "c3": (c3_start, end)}
        return sel

    # -------------------------------------------------------------- queries
    def assumptions(self, ii: int) -> List[int]:
        self.ensure_ii(ii)
        return self.inc.assumptions_for(ii)

    def project(self, ii: int) -> CNF:
        """Plain (unguarded) CNF for base + II's delta — for backends
        without assumption support and for cold-path equivalence checks.
        Memoised per (ii, n_vars): layers never change once encoded, so a
        cached projection stays valid until new layers grow ``n_vars``.
        Callers must treat the returned CNF as immutable."""
        self.ensure_ii(ii)
        nv = self.inc.n_vars
        hit = self._proj_cache.get(ii)
        if hit is not None and hit[0] == nv:
            return hit[1]
        cnf = self.inc.project(ii)
        self._proj_cache[ii] = (nv, cnf)
        return cnf

    def stats_for(self, ii: int) -> Dict[str, int]:
        self.ensure_ii(ii)
        return self.inc.layer_stats(ii)

    def projection_families(self, ii: int) -> Dict[str, Tuple[int, int]]:
        """Audit metadata: family -> [start, end) clause-index ranges in
        ``project(ii)``'s clause stream (base families first, then the
        layer's families shifted to follow them — exactly how
        ``IncrementalCNF.project`` lays the rows out)."""
        self.ensure_ii(ii)
        fams = dict(self.base_families)
        start, _ = self.inc.layer_slice(ii)
        shift = self.n_base - start
        for fam, (a, b) in self.layer_families[ii].items():
            fams[fam] = (a + shift, b + shift)
        return fams

    def decode(self, ii: int, model: Sequence[bool],
               ) -> Dict[int, Tuple[int, int, int]]:
        """Decode any model over (a prefix-compatible superset of) the
        layout variables into {node: (pe, kernel cycle, iteration)}."""
        placement: Dict[int, Tuple[int, int, int]] = {}
        for v, (n, p, t) in enumerate(self._lay.info_t):
            if model[v]:
                if n in placement:
                    raise ValueError(f"node {n} assigned twice")
                placement[n] = (p, t % ii, t // ii)
        missing = set(self.session.dfg.nodes) - set(placement)
        if missing:
            raise ValueError(f"unplaced nodes {sorted(missing)}")
        return placement


def encode(dfg: DFG, cgra: CGRA, ii: int, amo: str = "pairwise",
           emitters: str = "vector") -> Encoding:
    return EncoderSession(dfg, cgra, amo, emitters=emitters).encode(ii)
