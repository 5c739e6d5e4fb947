"""Static auditor for the emitted SAT encodings (`repro_torch.analysis`).

Independently re-derives the variable layout and the closed-form clause
counts of every family (C1 / C2 / C2W / C3) from the *inputs* of an
:class:`~repro_torch.core.encode.EncoderSession` — the ASAP/ALAP windows, the
allowed-PE sets, the per-node latencies, and the fabric's reachability —
then cross-checks the actual clause stream (via
``ClauseArena.padded_rows()`` and the family ranges recorded in
``Encoding.families`` / ``IncrementalEncoding.projection_families``)
against that model with whole-array numpy passes:

* per-family clause counts vs the closed forms (pairwise ``C(k,2)``,
  Sinz ``3k-4``, fold classes, the per-edge ``ntd * |PEs(dst)|`` C3 rows);
* AMO completeness and overlap: the multiset of emitted ``(¬u, ¬w)``
  pairs must equal the model's pair multiset per family (pairwise mode);
* C3 row alignment: head literal, row length ``1 + ntim*npsel``, and the
  closed-form support sum, row by row in emission order;
* tautological rows, duplicate rows, subsumed rows, and dead variables —
  each detected globally and compared against the *expected* benign
  classes below; a finding is suppressed only when the observed rows
  match the model's prediction exactly (set- or count-exact).

Known benign redundancy classes (suppressed when exact):

* ``dup:c1*c2`` — a pairwise C1 pair of one node duplicates a C2 fold
  pair when the node occupies one PE at two times ``t1 ≡ t2 (mod II)``;
* ``dup:c2*c2w`` — a write-port pair duplicates a C2 fold pair when the
  two completion times *and* the two issue times fold together;
* ``dup:c2s*c2`` — sequential-AMO incremental layers re-encode small
  folded groups pairwise, duplicating the base within-slot skeleton;
* ``dup:c3`` — parallel DFG edges whose clamped windows coincide;
* ``taut:c3-self`` — a self-edge row is tautological when its window
  contains 0 (the head variable supports itself; accumulators);
* ``subsume:unit-alo`` / ``subsume:unit-c3`` — a single-candidate node's
  unit ALO (or an empty-support C3 unit) subsumes longer rows that
  contain its literal;
* ``subsume:c3-full`` — a C3 row whose support covers the producer's
  whole candidate set is subsumed by that producer's ALO;
* ``dead:projection`` — in ``IncrementalEncoding.project(ii)`` the
  selector variables and other layers' aux variables occur in no clause
  (by construction; checked against ``layer_var_ranges()``).

Scope note: subsumption is checked for the classes that can structurally
arise in this encoding — units vs longer rows, and ALO ⊆ C3 row. Binary
AMO clauses cannot subsume anything but each other (that is the
duplicate check): C3 rows carry exactly one negative literal and ALO
rows none. Sinz (sequential-AMO) groups are count- and shape-checked
only; their pair content involves ladder aux variables and is covered by
the legacy-vs-vector bit-parity property tests instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.encode import Encoding, EncoderSession, IncrementalEncoding

_PAIRWISE_LIMIT = 4   # at_most_one's pairwise fallback threshold


class AuditError(RuntimeError):
    """The encoding lacks audit metadata or is structurally unanalysable
    (missing/overlapping family ranges, literals out of range). Distinct
    from a :class:`Finding`: findings describe the *formula*, an
    AuditError means the auditor itself cannot proceed."""


@dataclass
class Finding:
    code: str            # e.g. "dup:c1*c2", "family-count:c3"
    family: str          # family the finding anchors to ("*" = global)
    count: int           # rows / pairs / variables involved
    suppressed: bool     # True = known-benign class, matched exactly
    detail: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {"code": self.code, "family": self.family,
                "count": self.count, "suppressed": self.suppressed,
                "detail": self.detail}


@dataclass
class AuditReport:
    cell: str            # "<kernel>/<fabric>"
    mode: str            # "cold" | "projection"
    ii: int
    n_vars: int
    n_clauses: int
    family_counts: Dict[str, Tuple[int, int]]   # fam -> (actual, expected)
    findings: List[Finding] = field(default_factory=list)

    def ok(self) -> bool:
        return not any(not f.suppressed for f in self.findings)

    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def to_dict(self) -> Dict[str, object]:
        return {"cell": self.cell, "mode": self.mode, "ii": self.ii,
                "n_vars": self.n_vars, "n_clauses": self.n_clauses,
                "ok": self.ok(),
                "family_counts": {k: list(v)
                                  for k, v in self.family_counts.items()},
                "findings": [f.to_dict() for f in self.findings]}

    def summary(self) -> str:
        fams = " ".join(f"{k}={a}" + ("" if a == e else f"!={e}")
                        for k, (a, e) in self.family_counts.items())
        sup = sum(f.count for f in self.findings if f.suppressed)
        bad = self.unsuppressed()
        tail = (f" UNSUPPRESSED {[f.code for f in bad]}" if bad
                else f" suppressed={sup}")
        return (f"{self.cell} [{self.mode} ii={self.ii}] "
                f"{self.n_clauses}cl {fams}{tail}")


def _comb2(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.int64)
    return m * (m - 1) // 2


def _group_sizes(keys: np.ndarray) -> np.ndarray:
    """Sizes of the equal-key classes of ``keys``."""
    if keys.size == 0:
        return np.zeros(0, dtype=np.int64)
    _, counts = np.unique(keys, return_counts=True)
    return counts.astype(np.int64)


class _Model:
    """Independent re-derivation of the variable layout and of every
    closed-form family property for one (session, ii). Built from the
    session's *window/PE inputs* only — never from ``_Layout`` internals
    or the emitted arena."""

    def __init__(self, session: EncoderSession, ii: int):
        self.session = session
        self.ii = int(ii)
        self.amo = session.amo
        dfg, cgra = session.dfg, session.cgra
        # ---------------------------------------------- variable layout
        base0: Dict[int, int] = {}
        kvars: Dict[int, int] = {}
        v_node: List[np.ndarray] = []
        v_pe: List[np.ndarray] = []
        v_t: List[np.ndarray] = []
        v_lat: List[np.ndarray] = []
        top = 0
        for nid in dfg.nodes:
            a, b = session.asap[nid], session.alap[nid]
            pes = session.allowed_pes[nid]
            nt, npn = b - a + 1, len(pes)
            base0[nid] = top
            kvars[nid] = nt * npn
            top += nt * npn
            if npn:
                v_node.append(np.full(nt * npn, nid, dtype=np.int64))
                v_pe.append(np.tile(np.asarray(pes, np.int64), nt))
                v_t.append(np.repeat(np.arange(a, b + 1, dtype=np.int64),
                                     npn))
                v_lat.append(np.full(nt * npn, session.lat[nid],
                                     dtype=np.int64))
        empty = np.zeros(0, dtype=np.int64)
        self.base0, self.kvars = base0, kvars
        self.n_layout = top
        self.v_node = np.concatenate(v_node) if v_node else empty
        self.v_pe = np.concatenate(v_pe) if v_pe else empty
        self.v_t = np.concatenate(v_t) if v_t else empty
        self.v_lat = np.concatenate(v_lat) if v_lat else empty
        self.mixed_lat = len(set(session.lat.values())) > 1
        # node AMO emitted pairwise? (pairwise mode, or Sinz fallback)
        self.c1_pairwise = {n: self.amo == "pairwise"
                            or kvars[n] <= _PAIRWISE_LIMIT
                            for n in dfg.nodes}
        self.c1_aux = sum(kvars[n] - 1 for n in dfg.nodes
                          if not self.c1_pairwise[n] and kvars[n] > 1)
        # ------------------------------------------------- fold classes
        # issue-slot classes (C2): key = (pe, t % ii); slot classes
        # (incremental base C2S): key = (pe, t)
        nv = self.v_pe.size
        t_max = int(self.v_t.max()) + 1 if nv else 1
        self.issue_key = self.v_pe * ii + self.v_t % ii
        self.slot_key = self.v_pe * t_max + self.v_t
        uk, self.issue_inv, self.issue_counts = np.unique(
            self.issue_key, return_inverse=True, return_counts=True)
        self.issue_m = self.issue_counts[self.issue_inv] if nv else empty
        # distinct slot keys per issue class (sequential incremental:
        # single-slot folded groups are skipped entirely)
        if nv:
            slot_u, slot_first = np.unique(self.slot_key,
                                           return_index=True)
            cls_of_slot = self.issue_inv[slot_first]
            self.issue_nslots = np.bincount(cls_of_slot,
                                            minlength=uk.size)
        else:
            self.issue_nslots = empty
        # C2 class emitted pairwise? (vector mode is pairwise-only; the
        # legacy sequential path falls back to pairwise for m <= 4)
        self.c2_class_pairwise = (self.amo == "pairwise") | \
            (self.issue_counts <= _PAIRWISE_LIMIT)
        # ------------------------------------------------- C3 row model
        self._build_c3_rows()

    # ------------------------------------------------------------ C3 rows
    def _build_c3_rows(self) -> None:
        s, ii = self.session, self.ii
        cgra = s.cgra
        reach = [frozenset(ps for ps in range(cgra.n_pes)
                           if cgra.reachable(ps, pd))
                 for pd in range(cgra.n_pes)]
        cols = {k: [] for k in ("src", "dst", "td", "head", "ts0", "ntim",
                                "npsel", "selstart", "const", "ps",
                                "selfedge")}
        sel_parts: List[np.ndarray] = []
        sel_top = 0
        for src, dst, delta in s.dfg.edges():
            p_d, p_s = len(s.allowed_pes[dst]), len(s.allowed_pes[src])
            if p_d == 0:
                continue
            a_s, b_s = s.asap[src], s.alap[src]
            a_d, b_d = s.asap[dst], s.alap[dst]
            lat_s = s.lat[src]
            lo = lat_s - delta * ii
            hi = (1 - delta) * ii + lat_s - 1
            src_pes = s.allowed_pes[src]
            sels = [np.asarray([i for i, ps in enumerate(src_pes)
                                if ps in reach[pd]], dtype=np.int64)
                    for pd in s.allowed_pes[dst]]
            npsel = np.asarray([x.size for x in sels], dtype=np.int64)
            selstart = sel_top + np.cumsum(npsel) - npsel
            sel_parts.extend(sels)
            sel_top += int(npsel.sum())
            ntd = b_d - a_d + 1
            td = np.repeat(np.arange(a_d, b_d + 1, dtype=np.int64), p_d)
            n_rows = ntd * p_d
            ts0 = np.maximum(a_s, td - hi)
            ntim = np.maximum(np.minimum(b_s, td - lo) - ts0 + 1, 0)
            cols["src"].append(np.full(n_rows, src, dtype=np.int64))
            cols["dst"].append(np.full(n_rows, dst, dtype=np.int64))
            cols["td"].append(td)
            cols["head"].append(
                self.base0[dst] + 1 + (td - a_d) * p_d
                + np.tile(np.arange(p_d, dtype=np.int64), ntd))
            cols["ts0"].append(ts0)
            cols["ntim"].append(ntim)
            cols["npsel"].append(np.tile(npsel, ntd))
            cols["selstart"].append(np.tile(selstart, ntd))
            cols["const"].append(
                np.full(n_rows, self.base0[src] + 1 - a_s * p_s,
                        dtype=np.int64))
            cols["ps"].append(np.full(n_rows, p_s, dtype=np.int64))
            cols["selfedge"].append(
                np.full(n_rows, src == dst and lo <= 0 <= hi, dtype=bool))
        empty = np.zeros(0, dtype=np.int64)

        def cat(key):
            return (np.concatenate(cols[key]) if cols[key]
                    else (np.zeros(0, bool) if key == "selfedge"
                          else empty))

        self.r_src, self.r_dst = cat("src"), cat("dst")
        self.r_td, self.r_head = cat("td"), cat("head")
        self.r_ts0, self.r_ntim = cat("ts0"), cat("ntim")
        self.r_npsel, self.r_selstart = cat("npsel"), cat("selstart")
        self.r_const, self.r_ps = cat("const"), cat("ps")
        self.r_taut = cat("selfedge")
        self.sel = np.concatenate(sel_parts) if sel_parts else empty
        self.r_sup = self.r_ntim * self.r_npsel
        # per-row sel sums (for the closed-form support sum): sum of the
        # row's sel slice, via a cumulative sum over the concat table
        if self.sel.size:
            cs = np.concatenate([[0], np.cumsum(self.sel)])
            self.r_selsum = cs[self.r_selstart + self.r_npsel] \
                - cs[self.r_selstart]
        else:
            self.r_selsum = np.zeros(self.r_head.size, dtype=np.int64)
        # closed-form support sum: sum_{k<ntim} sum_{j} (const +
        # (ts0+k)*ps + sel_j)
        n, t0, j, c, p = (self.r_ntim, self.r_ts0, self.r_npsel,
                          self.r_const, self.r_ps)
        self.r_supsum = np.where(
            self.r_sup > 0,
            n * (j * c + self.r_selsum)
            + p * j * (n * t0 + n * (n - 1) // 2), 0)
        # full-support rows: the clamped window covers the producer's
        # whole candidate set -> subsumed by the producer's ALO
        nt_src = np.zeros(self.r_head.size, dtype=np.int64)
        a_src = np.zeros(self.r_head.size, dtype=np.int64)
        for nid in self.session.dfg.nodes:
            m = self.r_src == nid
            if m.any():
                a, b = self.session.asap[nid], self.session.alap[nid]
                nt_src[m] = b - a + 1
                a_src[m] = a
        self.r_full = ((self.r_sup > 0) & (self.r_ts0 == a_src)
                       & (self.r_ntim == nt_src)
                       & (self.r_npsel == self.r_ps))

    # ----------------------------------------------------- family counts
    def c1_count(self) -> int:
        total = 0
        for n, k in self.kvars.items():
            if k == 0:
                total += 1          # empty clause: node has no candidates
            elif k == 1:
                total += 1          # unit ALO, no AMO
            elif self.c1_pairwise[n]:
                total += 1 + k * (k - 1) // 2
            else:
                total += 1 + 3 * k - 4
        return total

    def c2_cold_count(self) -> int:
        m = self.issue_counts
        if self.amo == "pairwise":
            return int(_comb2(m).sum())
        pw = m <= _PAIRWISE_LIMIT
        return int(_comb2(m[pw]).sum()
                   + np.where(m[~pw] > 1, 3 * m[~pw] - 4, 0).sum())

    def c2s_count(self) -> int:
        return int(_comb2(_group_sizes(self.slot_key)).sum())

    def c2_delta_count(self) -> int:
        if self.amo == "pairwise":
            return self.c2_cold_count() - self.c2s_count()
        m, nk = self.issue_counts, self.issue_nslots
        multi = nk > 1
        mm = m[multi]
        return int(np.where(mm <= _PAIRWISE_LIMIT, _comb2(mm),
                            3 * mm - 4).sum())

    def c2w_count(self) -> int:
        if not self.mixed_lat or self.v_t.size == 0:
            return 0
        comp = self.v_pe * self.ii + (self.v_t + self.v_lat) % self.ii
        total = int(_comb2(_group_sizes(comp)).sum())
        lat_span = int(self.v_lat.max()) + 1
        same = int(_comb2(_group_sizes(comp * lat_span + self.v_lat)).sum())
        return total - same

    def c3_count(self) -> int:
        return int(self.r_head.size)

    def c2_aux_cold(self) -> int:
        """Sinz register variables allocated by the cold C2 fold (zero in
        pairwise mode, where no family creates per-II variables)."""
        if self.amo == "pairwise":
            return 0
        m = self.issue_counts
        big = m[m > _PAIRWISE_LIMIT]
        return int((big - 1).sum())

    # ------------------------------------------------- expected pair sets
    def _class_pairs(self, keys: np.ndarray, nv: int,
                     lat_filter: bool = False,
                     class_filter: Optional[np.ndarray] = None,
                     ) -> np.ndarray:
        """Canonical i64 keys ``u*(nv+1)+w`` (u<w, layout var ids) of all
        within-class pairs; ``lat_filter`` keeps only mixed-latency pairs,
        ``class_filter`` (bool per class, in sorted-unique-key order)
        drops whole classes (Sinz-emitted groups have no textual pairs)."""
        if keys.size == 0:
            return np.zeros(0, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
        ends = np.concatenate([starts[1:], [sk.size]])
        out: List[np.ndarray] = []
        for ci, (a, b) in enumerate(zip(starts, ends)):
            if b - a < 2:
                continue
            if class_filter is not None and not class_filter[ci]:
                continue
            mem = np.sort(order[a:b]) + 1      # var ids, ascending
            iu, ju = np.triu_indices(b - a, 1)
            if lat_filter:
                lat = self.v_lat[mem - 1]
                keep = lat[iu] != lat[ju]
                iu, ju = iu[keep], ju[keep]
            out.append(mem[iu] * (nv + 1) + mem[ju])
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.int64))

    def c1_pairs(self, nv: int) -> np.ndarray:
        out: List[np.ndarray] = []
        for n, k in self.kvars.items():
            if k < 2 or not self.c1_pairwise[n]:
                continue
            mem = np.arange(self.base0[n] + 1, self.base0[n] + k + 1,
                            dtype=np.int64)
            iu, ju = np.triu_indices(k, 1)
            out.append(mem[iu] * (nv + 1) + mem[ju])
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.int64))

    def c2_pairs(self, nv: int) -> np.ndarray:
        return self._class_pairs(self.issue_key, nv)

    def c2s_pairs(self, nv: int) -> np.ndarray:
        return self._class_pairs(self.slot_key, nv)

    def c2_delta_pairs(self, nv: int) -> np.ndarray:
        full = self.c2_pairs(nv)
        slot = self.c2s_pairs(nv)
        return np.setdiff1d(full, slot, assume_unique=False)

    def c2w_pairs(self, nv: int) -> np.ndarray:
        if not self.mixed_lat or self.v_t.size == 0:
            return np.zeros(0, dtype=np.int64)
        comp = self.v_pe * self.ii + (self.v_t + self.v_lat) % self.ii
        return self._class_pairs(comp, nv, lat_filter=True)

    def _c2_pairs_gated(self, nv: int, incremental: bool) -> np.ndarray:
        """The pairs *textually present* in the C2 family: everything in
        pairwise mode; in sequential mode only the pairwise-fallback
        groups (cold: m <= limit; incremental layers additionally skip
        single-slot groups but re-emit within-slot pairs)."""
        if not incremental:
            if self.amo == "pairwise":
                return self._class_pairs(self.issue_key, nv)
            return self._class_pairs(
                self.issue_key, nv,
                class_filter=self.issue_counts <= _PAIRWISE_LIMIT)
        if self.amo == "pairwise":
            return self.c2_delta_pairs(nv)
        filt = (self.issue_nslots > 1) \
            & (self.issue_counts <= _PAIRWISE_LIMIT)
        return self._class_pairs(self.issue_key, nv, class_filter=filt)

    # ------------------------------------------------ expected redundancy
    def expected_dup_patterns(self, incremental: bool, nv: int,
                              ) -> Dict[Tuple[str, ...], int]:
        """Predicted duplicate groups, keyed by the sorted family tuple of
        the group's members — e.g. ``("c1","c2"): 18`` means 18 canonical
        clauses each appearing once in C1 and once in C2. Binary families
        are intersected as exact pair-key sets (each family emits a given
        pair at most once), so every cross-family overlap — C1 vs the
        fold, the fold vs write-port pairs, a sequential layer vs the
        within-slot skeleton — falls out of one grouping pass."""
        out: Dict[Tuple[str, ...], int] = {}
        sets = {"c1": self.c1_pairs(nv),
                "c2": self._c2_pairs_gated(nv, incremental),
                "c2w": self.c2w_pairs(nv)}
        if incremental:
            sets["c2s"] = self.c2s_pairs(nv)
        keys = np.concatenate([v for v in sets.values()])
        tags = np.concatenate([np.full(v.size, i, dtype=np.int64)
                               for i, v in enumerate(sets.values())])
        names = list(sets)
        if keys.size:
            order = np.argsort(keys, kind="stable")
            sk, st = keys[order], tags[order]
            starts = np.flatnonzero(np.concatenate(
                [[True], sk[1:] != sk[:-1]]))
            ends = np.concatenate([starts[1:], [sk.size]])
            for a, b in zip(starts, ends):
                if b - a < 2:
                    continue
                pat = tuple(sorted(names[t] for t in st[a:b]))
                out[pat] = out.get(pat, 0) + 1
        # c3: rows with identical content (parallel edges / coinciding
        # clamped windows; empty-support rows collapse to the bare head)
        if self.r_head.size:
            key = np.stack([
                self.r_head,
                np.where(self.r_sup > 0, self.r_src + 1, -1),
                np.where(self.r_sup > 0, self.r_ts0, 0),
                np.where(self.r_sup > 0, self.r_ntim, 0)], axis=1)
            _, counts = np.unique(key, axis=0, return_counts=True)
            for c in counts[counts > 1]:
                pat = ("c3",) * int(c)
                out[pat] = out.get(pat, 0) + 1
        return out

    def expected_units(self) -> Dict[int, str]:
        """lit -> class for every predicted unit clause: ``+v`` pinned-node
        ALOs, ``-w`` empty-support C3 heads."""
        out: Dict[int, str] = {}
        for n, k in self.kvars.items():
            if k == 1:
                out[self.base0[n] + 1] = "unit-alo"
        for h in self.r_head[self.r_sup == 0]:
            out[-int(h)] = "unit-c3"
        return out

    def expected_unit_subsumed(self, lit: int, incremental: bool) -> int:
        """Rows (len > 1) the unit clause ``lit`` subsumes, per the model."""
        if lit > 0:
            # pinned node's ALO: subsumes C3 rows whose support contains
            # the (single) candidate variable
            v = lit
            nid = int(self.v_node[v - 1])
            t0, p0 = int(self.v_t[v - 1]), int(self.v_pe[v - 1])
            pes = self.session.allowed_pes[nid]
            pidx = pes.index(p0)
            n = 0
            rows = np.flatnonzero((self.r_src == nid) & (self.r_sup > 0)
                                  & (self.r_ts0 <= t0)
                                  & (t0 < self.r_ts0 + self.r_ntim))
            for r in rows:
                s0 = int(self.r_selstart[r])
                if pidx in self.sel[s0:s0 + int(self.r_npsel[r])]:
                    n += 1
            return n
        # empty-support C3 head: subsumes every longer row containing -w
        w = -lit
        nid = int(self.v_node[w - 1])
        n = 0
        k = self.kvars[nid]
        if k > 1 and self.c1_pairwise[nid]:
            n += k - 1
        elif k > 1:
            pos = w - (self.base0[nid] + 1)
            n += 1 if pos in (0, k - 1) else 2
        m = int(self.issue_m[w - 1])
        cls = self.issue_inv[w - 1]

        def sinz_occ() -> int:
            # occurrences of -w in a Sinz ladder depend on the member's
            # position in the concatenated group (ascending var order)
            mem = np.sort(np.flatnonzero(self.issue_inv == cls))
            pos = int(np.searchsorted(mem, w - 1))
            return 1 if pos in (0, m - 1) else 2

        if not incremental:
            if self.c2_class_pairwise[cls]:
                n += m - 1
            else:
                n += sinz_occ()
        else:
            # base within-slot skeleton (always pairwise)
            slot_sz = int((self.slot_key == self.slot_key[w - 1]).sum())
            n += slot_sz - 1
            if self.issue_nslots[cls] > 1:
                if self.amo == "pairwise":
                    # delta layer: cross-time pairs only
                    n += (m - 1) - (slot_sz - 1)
                elif m <= _PAIRWISE_LIMIT:
                    # sequential fallback re-encodes the whole group
                    n += m - 1
                else:
                    n += sinz_occ()
        if self.mixed_lat:
            comp = self.v_pe * self.ii + (self.v_t + self.v_lat) % self.ii
            peers = np.flatnonzero(comp == comp[w - 1])
            n += int((self.v_lat[peers] != self.v_lat[w - 1]).sum())
        n += int(((self.r_head == w) & (self.r_sup > 0)).sum())
        return n


# ---------------------------------------------------------------- checking
def _sorted_families(families: Dict[str, Tuple[int, int]], n_clauses: int,
                     ) -> List[Tuple[str, int, int]]:
    """Families sorted by start; must tile [0, n_clauses) exactly."""
    fams = sorted(((name, a, b) for name, (a, b) in families.items()),
                  key=lambda x: x[1])
    pos = 0
    for name, a, b in fams:
        if a != pos or b < a:
            raise AuditError(f"family ranges do not tile the arena "
                             f"(at {name}: [{a},{b}) after {pos})")
        pos = b
    if pos != n_clauses:
        raise AuditError(f"family ranges cover {pos} of {n_clauses} clauses")
    return fams


def _extract_pairs(lits: np.ndarray, offs: np.ndarray, s: int, e: int,
                   nv: int, skip_rows: Optional[np.ndarray] = None,
                   ) -> Tuple[Optional[np.ndarray], str]:
    """Canonical keys of the (¬u, ¬w) binary rows in family rows [s, e),
    or (None, why) if the slice is not all negative binary clauses.
    ``skip_rows`` excludes absolute row indices (C1's ALO/empty rows)."""
    rows = np.arange(s, e)
    if skip_rows is not None and skip_rows.size:
        rows = rows[~np.isin(rows, skip_rows)]
    if rows.size == 0:
        return np.zeros(0, dtype=np.int64), ""
    lens = offs[rows + 1] - offs[rows]
    if not (lens == 2).all():
        return None, f"{int((lens != 2).sum())} non-binary rows"
    a = -lits[offs[rows]].astype(np.int64)
    b = -lits[offs[rows] + 1].astype(np.int64)
    if (a <= 0).any() or (b <= 0).any():
        return None, "positive literal in an AMO pair"
    if (a == b).any():
        return None, f"{int((a == b).sum())} self-pairs (¬v ∨ ¬v)"
    return np.minimum(a, b) * (nv + 1) + np.maximum(a, b), ""


def _audit(cell: str, mode: str, model: _Model, cnf, families,
           expected_counts: Dict[str, int],
           expected_dead: Optional[set] = None,
           incremental: bool = False) -> AuditReport:
    arena = cnf.arena
    n_vars, n_clauses = cnf.n_vars, len(arena)
    fams = _sorted_families(families, n_clauses)
    offs = arena.offs_view().astype(np.int64)
    lits = arena.lits_view().astype(np.int64)
    lens = np.diff(offs)
    rep = AuditReport(cell=cell, mode=mode, ii=model.ii, n_vars=n_vars,
                      n_clauses=n_clauses, family_counts={})
    add = rep.findings.append

    # ------------------------------------------------------- literal range
    if lits.size and ((lits == 0).any()
                      or (np.abs(lits) > n_vars).any()):
        bad = int(((lits == 0) | (np.abs(lits) > n_vars)).sum())
        add(Finding("litrange", "*", bad, False,
                    "zero or out-of-range literals"))
        return rep   # nothing downstream is trustworthy

    # ------------------------------------------------------- family counts
    counts_ok: Dict[str, bool] = {}
    for name, a, b in fams:
        exp = expected_counts.get(name)
        if exp is None:
            raise AuditError(f"no closed form for family {name!r}")
        rep.family_counts[name] = (b - a, exp)
        counts_ok[name] = (b - a) == exp
        if not counts_ok[name]:
            add(Finding(f"family-count:{name}", name, abs(b - a - exp),
                        False, f"actual {b - a} != closed-form {exp}"))
    fam_ranges = {name: (a, b) for name, a, b in fams}

    # --------------------------------------------- cold n_vars closed form
    if mode == "cold":
        exp_nv = model.n_layout + model.c1_aux + model.c2_aux_cold()
        if n_vars != exp_nv:
            add(Finding("nvars", "*", abs(n_vars - exp_nv), False,
                        f"n_vars {n_vars} != closed-form {exp_nv}"))

    # ---------------------------------------------------- C1 structure walk
    alo_rows: List[int] = []
    s1, e1 = fam_ranges["c1"]
    if counts_ok["c1"]:
        idx = s1
        bad_alo = 0
        for nid, k in model.kvars.items():
            if k == 0:
                if lens[idx] != 0:
                    bad_alo += 1
                idx += 1
                continue
            base = model.base0[nid]
            row = lits[offs[idx]:offs[idx + 1]]
            if lens[idx] != k or not np.array_equal(
                    row, np.arange(base + 1, base + k + 1)):
                bad_alo += 1
            alo_rows.append(idx)
            if k == 1:
                idx += 1
            elif model.c1_pairwise[nid]:
                idx += 1 + k * (k - 1) // 2
            else:
                idx += 1 + 3 * k - 4
        if bad_alo:
            add(Finding("c1-alo", "c1", bad_alo, False,
                        "ALO rows diverge from the node's variable range"))
        if idx != e1:
            add(Finding("c1-walk", "c1", abs(idx - e1), False,
                        "per-node C1 block walk does not close the family"))

    # ------------------------------------------------- AMO pair multisets
    def check_pairs(name: str, expected: np.ndarray,
                    skip: Optional[np.ndarray] = None) -> None:
        if name not in fam_ranges or not counts_ok.get(name):
            return
        a, b = fam_ranges[name]
        got, why = _extract_pairs(lits, offs, a, b, n_vars, skip)
        if got is None:
            add(Finding(f"amo-shape:{name}", name, 1, False, why))
            return
        got, expected = np.sort(got), np.sort(expected)
        if not np.array_equal(got, expected):
            diff = int(np.setdiff1d(got, expected).size
                       + np.setdiff1d(expected, got).size)
            add(Finding(f"amo-pairs:{name}", name, max(diff, 1), False,
                        "emitted pair multiset != model (completeness/"
                        "overlap violation)"))

    if model.amo == "pairwise" and counts_ok.get("c1"):
        check_pairs("c1", model.c1_pairs(n_vars),
                    skip=np.asarray(alo_rows, dtype=np.int64))
    if "c2s" in fam_ranges:
        check_pairs("c2s", model.c2s_pairs(n_vars))
    if model.amo == "pairwise":
        if incremental:
            check_pairs("c2", model.c2_delta_pairs(n_vars))
        else:
            check_pairs("c2", model.c2_pairs(n_vars))
    check_pairs("c2w", model.c2w_pairs(n_vars))

    # --------------------------------------------------- C3 aligned checks
    c3_aligned = counts_ok.get("c3", False)
    s3, e3 = fam_ranges["c3"]
    emp_full = None
    if c3_aligned and e3 > s3:
        ro = offs[s3:e3 + 1]
        heads = lits[ro[:-1]]
        if not np.array_equal(heads, -model.r_head):
            add(Finding("c3-head", "c3",
                        int((heads != -model.r_head).sum()), False,
                        "row head literals diverge from the model"))
            c3_aligned = False
        if c3_aligned and not np.array_equal(np.diff(ro),
                                             1 + model.r_sup):
            add(Finding("c3-lens", "c3",
                        int((np.diff(ro) != 1 + model.r_sup).sum()),
                        False, "row lengths != 1 + ntim*npsel"))
            c3_aligned = False
        if c3_aligned:
            cs = np.concatenate([[0], np.cumsum(lits)])
            rowsum = cs[ro[1:]] - cs[ro[:-1]]
            supsum = rowsum + model.r_head     # head lit is -head
            if not np.array_equal(supsum, model.r_supsum):
                add(Finding("c3-supsum", "c3",
                            int((supsum != model.r_supsum).sum()), False,
                            "support sums diverge from the closed form"))
                c3_aligned = False
        if c3_aligned:
            # support min/max per row (head slot masked out) -> exact
            # full-support detection; support literals are distinct by
            # construction, so min/max/len pin the contiguous range
            buf = lits[ro[0]:ro[-1]].copy()
            starts_rel = ro[:-1] - ro[0]
            big = 2 * n_vars + 3
            buf_min = buf.copy()
            buf_min[starts_rel] = big
            minv = np.minimum.reduceat(buf_min, starts_rel)
            maxv = np.maximum.reduceat(buf, starts_rel)
            k_src = np.asarray([model.kvars[int(n)] for n in model.r_src],
                               dtype=np.int64)
            b_src = np.asarray([model.base0[int(n)] for n in model.r_src],
                               dtype=np.int64)
            emp_full = ((model.r_sup > 0) & (minv == b_src + 1)
                        & (maxv == b_src + k_src)
                        & (model.r_sup == k_src))
            if not np.array_equal(emp_full, model.r_full):
                add(Finding("subsume:c3-full-mismatch", "c3",
                            int((emp_full != model.r_full).sum()), False,
                            "full-support rows diverge from the model"))
            elif emp_full.any():
                add(Finding("subsume:c3-full", "c3",
                            int(emp_full.sum()), True,
                            "C3 rows whose support covers the producer's "
                            "whole candidate set (subsumed by its ALO)"))

    # --------------------------------------------------------- tautologies
    row_of = np.repeat(np.arange(n_clauses), lens)
    pos = lits > 0
    kp = row_of[pos] * (n_vars + 1) + lits[pos]
    kn = row_of[~pos] * (n_vars + 1) - lits[~pos]
    taut_rows = np.unique(np.intersect1d(kp, kn) // (n_vars + 1))
    exp_taut = (s3 + np.flatnonzero(model.r_taut) if c3_aligned
                else np.zeros(0, dtype=np.int64))
    if np.array_equal(taut_rows, exp_taut):
        if taut_rows.size:
            add(Finding("taut:c3-self", "c3", int(taut_rows.size), True,
                        "self-edge rows whose window contains 0 "
                        "(accumulator supports itself)"))
    else:
        add(Finding("taut", "*",
                    int(np.setdiff1d(taut_rows, exp_taut).size
                        + np.setdiff1d(exp_taut, taut_rows).size), False,
                    "tautological rows do not match the self-edge model"))

    # ---------------------------------------------------------- duplicates
    if (lens == 0).any():
        add(Finding("empty-clause", "*", int((lens == 0).sum()), False,
                    "empty clauses (trivially UNSAT input)"))
    pad, _ = arena.padded_rows()
    if pad.size:
        pad = pad.copy()
        pad[pad == 0] = 2 * n_vars + 3
        pad.sort(axis=1)
        _, inv, cnt = np.unique(pad, axis=0, return_inverse=True,
                                return_counts=True)
        fam_starts = np.asarray([a for _, a, _ in fams])
        fam_names = [name for name, _, _ in fams]

        def fam_of(r: int) -> str:
            return fam_names[int(np.searchsorted(fam_starts, r, "right")) - 1]

        actual: Dict[Tuple[str, ...], int] = {}
        if (cnt > 1).any():
            order = np.argsort(inv, kind="stable")
            ginv = inv[order]
            gstarts = np.flatnonzero(np.concatenate(
                [[True], ginv[1:] != ginv[:-1]]))
            gends = np.concatenate([gstarts[1:], [ginv.size]])
            for a, b in zip(gstarts, gends):
                if b - a < 2:
                    continue
                pat = tuple(sorted(fam_of(r) for r in order[a:b]))
                actual[pat] = actual.get(pat, 0) + 1
        expected = model.expected_dup_patterns(incremental, n_vars)
        if actual == expected:
            for pat, n in sorted(actual.items()):
                add(Finding("dup:" + "*".join(pat), "*", n, True,
                            f"{n} clause(s) emitted {len(pat)}x — known "
                            "benign overlap, count matches the model"))
        else:
            add(Finding("dup:mismatch", "*",
                        sum(actual.values()) + sum(expected.values()), False,
                        f"duplicate groups {actual} != model {expected}"))

    # ------------------------------------------------- unit subsumption
    unit_rows = np.flatnonzero(lens == 1)
    unit_lits = {int(lits[offs[r]]) for r in unit_rows}
    exp_units = model.expected_units()
    if unit_lits != set(exp_units):
        add(Finding("unit:unexpected", "*",
                    len(unit_lits.symmetric_difference(exp_units)), False,
                    f"unit clauses {sorted(unit_lits)} != model "
                    f"{sorted(exp_units)}"))
    else:
        for lit, cls in sorted(exp_units.items()):
            occ_rows = row_of[lits == lit]
            got = int((lens[occ_rows] > 1).sum())
            exp = model.expected_unit_subsumed(lit, incremental)
            if got == exp:
                if got:
                    add(Finding(f"subsume:{cls}", "*", got, True,
                                f"unit {lit} subsumes {got} longer rows "
                                "(count matches the model)"))
            else:
                add(Finding(f"subsume:{cls}-mismatch", "*",
                            abs(got - exp), False,
                            f"unit {lit}: {got} subsumed rows != model "
                            f"{exp}"))

    # ----------------------------------------------------------- dead vars
    occ = np.bincount(np.abs(lits), minlength=n_vars + 1)
    dead = set((np.flatnonzero(occ[1:] == 0) + 1).tolist())
    exp_dead = expected_dead or set()
    if dead == exp_dead:
        if dead:
            add(Finding("dead:projection", "*", len(dead), True,
                        "selector/other-layer variables stripped by "
                        "project() (matches layer_var_ranges)"))
    else:
        add(Finding("dead:unexpected", "*",
                    len(dead.symmetric_difference(exp_dead)), False,
                    f"dead vars {sorted(dead - exp_dead)[:8]} / missing "
                    f"{sorted(exp_dead - dead)[:8]}"))
    return rep


# ----------------------------------------------------------- entry points
def audit_encoding(session: EncoderSession, ii: int,
                   enc: Optional[Encoding] = None,
                   cell: str = "?") -> AuditReport:
    """Audit one cold per-II encoding against the independent model."""
    if enc is None:
        enc = session.encode(ii)
    if not enc.families:
        raise AuditError("Encoding.families is empty — encode() must "
                         "record the family ranges")
    model = _Model(session, ii)
    expected = {"c1": model.c1_count(), "c2": model.c2_cold_count(),
                "c2w": model.c2w_count(), "c3": model.c3_count()}
    return _audit(cell, "cold", model, enc.cnf, enc.families, expected)


def audit_projection(inc: IncrementalEncoding, ii: int,
                     cell: str = "?") -> AuditReport:
    """Audit ``IncrementalEncoding.project(ii)`` — the guard-stripped
    base+delta CNF — including the expected-dead selector/aux variables
    of the other layers."""
    inc.ensure_ii(ii)
    cnf = inc.project(ii)
    model = _Model(inc.session, ii)
    expected = {"c1": model.c1_count(), "c2s": model.c2s_count(),
                "c2": model.c2_delta_count(), "c2w": model.c2w_count(),
                "c3": model.c3_count()}
    exp_dead: set = set()
    for key, (sel, vs, ve) in inc.inc.layer_var_ranges().items():
        if key == ii:
            exp_dead.add(sel)
        else:
            exp_dead.update(range(vs, ve + 1))
    return _audit(cell, "projection", model, cnf,
                  inc.projection_families(ii), expected,
                  expected_dead=exp_dead, incremental=True)


def suite_fabrics() -> List[Tuple[str, object]]:
    """The 3-fabric audit grid: the paper's homogeneous mesh, a
    multi-cycle (mixed-latency) fabric exercising C2W, and a restricted
    heterogeneous one-hop fabric (memory ops pinned to column 0)."""
    from ..core.arch import arch
    from ..core.cgra import cgra_from_name
    return [("3x3", cgra_from_name("3x3")),
            ("4x4:mul2:mem2", cgra_from_name("4x4:mul2:mem2")),
            ("4x4-onehop:r2+memcol0", arch("4x4-onehop:r2", mem="col0"))]


def audit_suite(names: Optional[Sequence[str]] = None,
                fabrics: Optional[List[Tuple[str, object]]] = None,
                amo: str = "pairwise", emitters: str = "vector",
                incremental: bool = True,
                progress=None) -> List[AuditReport]:
    """Audit every suite cell (kernel x fabric) at its minimal II: the
    cold encoding always, plus — with ``incremental=True`` — the layered
    projection with a second (II+1) layer encoded so the expected-dead
    variable check is non-trivial."""
    from ..core import suite
    from ..core.schedule import min_ii
    fabrics = fabrics if fabrics is not None else suite_fabrics()
    reports: List[AuditReport] = []
    for name in (names or suite.names()):
        g = suite.get(name)
        for label, fab in fabrics:
            cell = f"{name}/{label}"
            session = EncoderSession(g, fab, amo=amo, emitters=emitters)
            ii0 = max(min_ii(g, fab), 1)
            reports.append(audit_encoding(session, ii0, cell=cell))
            if incremental:
                inc = IncrementalEncoding(session)
                inc.ensure_ii(ii0)
                inc.ensure_ii(ii0 + 1)
                reports.append(audit_projection(inc, ii0, cell=cell))
            if progress is not None:
                progress(reports[-1])
    return reports


def reports_to_json(reports: Sequence[AuditReport]) -> Dict[str, object]:
    """Machine-readable audit artifact (CI uploads this as AUDIT_cnf.json)."""
    return {
        "cells": sorted({r.cell for r in reports}),
        "ok": all(r.ok() for r in reports),
        "n_reports": len(reports),
        "n_suppressed": sum(f.count for r in reports
                            for f in r.findings if f.suppressed),
        "n_unsuppressed": sum(1 for r in reports
                              for f in r.findings if not f.suppressed),
        "reports": [r.to_dict() for r in reports],
    }
