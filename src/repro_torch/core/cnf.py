"""CNF containers + cardinality encodings on a flat clause arena.

Variables are positive ints (DIMACS convention); a literal is ±var. The
paper's C1 uses the naive pairwise at-most-one (its Eq. 1 ``M(n)`` set); we
also provide the Sinz sequential encoding as a beyond-paper option — it turns
O(k^2) binary clauses into O(k) ternary ones, which dominates encode time on
big KMS instances.

Clause storage is a :class:`ClauseArena`: one append-only int32 literal
buffer plus an int64 clause-offset index (CSR layout). Clause ``i`` is
``lits[offs[i]:offs[i+1]]``; insertion order is the clause order. The arena
is the single source of truth — the encoder extends it in bulk, the walksat
packer reshapes it without per-clause iteration, and the CDCL worker ships
it across the process pool as two numpy arrays. ``CNF.clauses`` stays
available as a list-of-tuples *view* so existing call sites (iteration,
slicing, membership, equality) keep working unchanged.

``IncrementalCNF`` is the layered container behind the assumption-based
solver core: a shared *base* layer of unguarded clauses plus named delta
layers whose clauses carry a fresh selector literal, so one persistent
formula covers every candidate II of a sweep and "try II=k" is an
assumption solve rather than a fresh encode.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np


class EmptyClauseError(ValueError):
    """Raised when an empty clause reaches ``CNF.add(*lits)``.

    ``add`` is the literal-varargs fast path and cannot represent "the
    formula is trivially UNSAT" — that is ``add_clause([])``'s job, which
    also sets ``trivially_unsat`` so backends fail fast. A bare ``assert``
    here would be stripped under ``python -O`` and let the empty clause
    slip in silently, corrupting UNSAT detection (same failure mode as the
    ``NonModelError`` guard in the walksat layer).
    """


class ArenaFormatError(ValueError):
    """A serialised :class:`ClauseArena` blob failed validation (bad magic,
    truncation, CRC mismatch, or broken CSR invariants). The disk store
    treats this as "quarantine the record", never as a crash."""


class ClauseArena:
    """Append-only CSR clause store: int32 literals + int64 row offsets.

    Invariants:
      * ``offs[0] == 0`` and ``offs`` is non-decreasing with ``n + 1``
        live entries; clause ``i`` is ``lits[offs[i]:offs[i+1]]``.
      * rows are never mutated or removed once appended — growth is
        amortised-doubling realloc of the two buffers only, so trimmed
        views taken before an append remain valid snapshots.
    """

    __slots__ = ("_lits", "_offs", "_n", "_top")

    def __init__(self):
        self._lits = np.empty(64, dtype=np.int32)
        self._offs = np.zeros(17, dtype=np.int64)
        self._n = 0     # live clause count
        self._top = 0   # live literal count

    @classmethod
    def from_arrays(cls, lits: np.ndarray, offs: np.ndarray) -> "ClauseArena":
        """Adopt (copies of) a (lits, offs) CSR pair, e.g. from a pickle."""
        out = cls.__new__(cls)
        out._lits = np.ascontiguousarray(lits, dtype=np.int32).copy()
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        out._offs = offs.copy()
        out._n = offs.size - 1
        out._top = int(offs[-1]) if offs.size else 0
        return out

    # ------------------------------------------------------------- growth
    def _reserve_lits(self, extra: int) -> None:
        need = self._top + extra
        if need > self._lits.size:
            new = np.empty(max(need, self._lits.size * 2), dtype=np.int32)
            new[:self._top] = self._lits[:self._top]
            self._lits = new

    def _reserve_rows(self, extra: int) -> None:
        need = self._n + 1 + extra
        if need > self._offs.size:
            new = np.empty(max(need, self._offs.size * 2), dtype=np.int64)
            new[:self._n + 1] = self._offs[:self._n + 1]
            self._offs = new

    # ------------------------------------------------------------- append
    def add(self, lits: Sequence[int]) -> None:
        """Append one clause (any sequence of ints, may be empty)."""
        k = len(lits)
        self._reserve_rows(1)
        self._reserve_lits(k)
        top = self._top
        self._lits[top:top + k] = lits
        self._top = top + k
        self._n += 1
        self._offs[self._n] = self._top

    def extend_flat(self, flat: np.ndarray, lens: np.ndarray) -> None:
        """Bulk-append: ``flat`` concatenates rows whose lengths are ``lens``."""
        k = int(lens.size)
        if k == 0:
            return
        total = int(flat.size)
        self._reserve_rows(k)
        self._reserve_lits(total)
        n, top = self._n, self._top
        self._lits[top:top + total] = flat
        self._offs[n + 1:n + 1 + k] = top + np.cumsum(lens)
        self._n = n + k
        self._top = top + total

    def extend_rows(self, rows: Iterable[Sequence[int]]) -> None:
        for r in rows:
            self.add(r)

    # -------------------------------------------------------------- reads
    def __len__(self) -> int:
        return self._n

    @property
    def n_lits(self) -> int:
        return self._top

    def lits_view(self) -> np.ndarray:
        """Trimmed literal buffer ``[n_lits]`` — treat as read-only."""
        return self._lits[:self._top]

    def offs_view(self) -> np.ndarray:
        """Trimmed offsets ``[n_clauses + 1]`` — treat as read-only."""
        return self._offs[:self._n + 1]

    def lens(self) -> np.ndarray:
        return np.diff(self.offs_view())

    def clause(self, i: int) -> Tuple[int, ...]:
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError("clause index out of range")
        a, b = int(self._offs[i]), int(self._offs[i + 1])
        return tuple(self._lits[a:b].tolist())

    def iter_tuples(self, start: int = 0, stop: Optional[int] = None,
                    ) -> Iterator[Tuple[int, ...]]:
        stop = self._n if stop is None else stop
        offs = self._offs[start:stop + 1].tolist()
        if not offs:
            return
        flat = self._lits[offs[0]:offs[-1]].tolist()
        base = offs[0]
        for i in range(len(offs) - 1):
            yield tuple(flat[offs[i] - base:offs[i + 1] - base])

    def iter_lists(self) -> Iterator[List[int]]:
        """Rows as plain-int lists (one ``tolist`` total — the fast path
        for consumers that re-normalise per clause, e.g. CDCL intake)."""
        offs = self._offs[:self._n + 1].tolist()
        flat = self._lits[:self._top].tolist()
        for i in range(self._n):
            yield flat[offs[i]:offs[i + 1]]

    def max_var(self) -> int:
        return int(np.abs(self.lits_view()).max()) if self._top else 0

    def padded_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Audit hook: the clause stream as one dense ``[n_clauses, Lmax]``
        int64 matrix (rows zero-padded on the right — 0 is never a
        literal) plus the per-row lengths. This is the whole-arena view
        the static CNF auditor (``repro.analysis.cnf_audit``) vectorises
        over: row-wise sorts, uniqueness, and membership tests become
        single numpy ops instead of per-clause Python loops."""
        lens = self.lens()
        n = self._n
        if n == 0:
            return np.zeros((0, 0), dtype=np.int64), lens
        lmax = int(lens.max()) if lens.size else 0
        pad = np.zeros((n, lmax), dtype=np.int64)
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(self._top) - np.repeat(self.offs_view()[:-1], lens)
        pad[rows, cols] = self.lits_view()
        return pad, lens

    def copy(self) -> "ClauseArena":
        out = ClauseArena.__new__(ClauseArena)
        out._lits = self._lits[:self._top].copy()
        out._offs = self._offs[:self._n + 1].copy()
        out._n = self._n
        out._top = self._top
        return out

    # ------------------------------------------------------- serialisation
    # Binary layout (little-endian, 8-byte aligned arrays — designed so a
    # reader holding an mmap of a store file can np.frombuffer the two
    # array segments without copying):
    #
    #   b"CArn" | u32 version | u64 n_clauses | u64 n_lits
    #   | offs  int64[n_clauses + 1]
    #   | lits  int32[n_lits]   (+ 4 pad bytes when n_lits is odd)
    #   | u32 crc32 over everything above
    _SER_MAGIC = b"CArn"
    _SER_VERSION = 1
    _SER_HEAD = struct.Struct("<4sIQQ")

    def to_bytes(self) -> bytes:
        """Serialise the arena; ``from_bytes`` round-trips stream-exactly
        (identical ``offs``/``lits`` arrays, hence identical clause
        stream — empty clauses and guard literals included)."""
        offs = np.ascontiguousarray(self.offs_view(), dtype="<i8")
        lits = np.ascontiguousarray(self.lits_view(), dtype="<i4")
        head = self._SER_HEAD.pack(self._SER_MAGIC, self._SER_VERSION,
                                   self._n, self._top)
        pad = b"\x00\x00\x00\x00" if self._top % 2 else b""
        body = head + offs.tobytes() + lits.tobytes() + pad
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ClauseArena":
        """Rebuild an arena serialised by :meth:`to_bytes`.

        Raises :class:`ArenaFormatError` on any mismatch — bad magic,
        truncation, CRC failure, or violated CSR invariants — so a store
        reading a corrupted record can quarantine it instead of crashing
        (or worse, silently adopting a garbled clause stream)."""
        data = bytes(data)
        head_n = cls._SER_HEAD.size
        if len(data) < head_n + 4:
            raise ArenaFormatError("arena blob truncated (header)")
        magic, version, n, top = cls._SER_HEAD.unpack_from(data)
        if magic != cls._SER_MAGIC:
            raise ArenaFormatError("bad arena magic")
        if version != cls._SER_VERSION:
            raise ArenaFormatError(f"unsupported arena version {version}")
        pad = 4 if top % 2 else 0
        need = head_n + 8 * (n + 1) + 4 * top + pad + 4
        if len(data) != need:
            raise ArenaFormatError(
                f"arena blob length {len(data)} != expected {need}")
        crc = struct.unpack_from("<I", data, need - 4)[0]
        if zlib.crc32(data[:need - 4]) & 0xFFFFFFFF != crc:
            raise ArenaFormatError("arena CRC mismatch")
        offs = np.frombuffer(data, dtype="<i8", count=n + 1, offset=head_n)
        lits = np.frombuffer(data, dtype="<i4", count=top,
                             offset=head_n + 8 * (n + 1))
        if n < 0 or top < 0 or offs.size == 0 or offs[0] != 0 \
                or int(offs[-1]) != top or (np.diff(offs) < 0).any():
            raise ArenaFormatError("arena CSR invariants violated")
        return cls.from_arrays(lits.astype(np.int32),
                               offs.astype(np.int64))


class _ClausesView:
    """List-of-tuples facade over a CNF's arena.

    Supports the whole legacy surface: iteration, ``len``, indexing,
    slicing (returns a plain list of tuples), membership, equality against
    another view or a list, and ``append``. Bound to the CNF (not the
    arena object) so it stays valid if the arena is swapped wholesale.
    """

    __slots__ = ("_cnf",)

    def __init__(self, cnf: "CNF"):
        self._cnf = cnf

    @property
    def _arena(self) -> ClauseArena:
        return self._cnf.arena

    def __len__(self) -> int:
        return len(self._arena)

    def __iter__(self) -> Iterator[Tuple[int, ...]]:
        return self._arena.iter_tuples()

    def __getitem__(self, idx):
        a = self._arena
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(a))
            if step == 1:
                return list(a.iter_tuples(start, stop))
            return [a.clause(i) for i in range(start, stop, step)]
        return a.clause(idx)

    def __contains__(self, item) -> bool:
        key = tuple(item)
        return any(t == key for t in self)

    def __eq__(self, other) -> bool:
        if isinstance(other, _ClausesView):
            a, b = self._arena, other._arena
            return (len(a) == len(b)
                    and np.array_equal(a.offs_view(), b.offs_view())
                    and np.array_equal(a.lits_view(), b.lits_view()))
        if isinstance(other, (list, tuple)):
            if len(other) != len(self):
                return False
            return all(mine == tuple(theirs)
                       for mine, theirs in zip(self, other))
        return NotImplemented

    __hash__ = None  # mutable container, like list

    def append(self, lits: Sequence[int]) -> None:
        self._arena.add(tuple(lits))

    def iter_lists(self) -> Iterator[List[int]]:
        return self._arena.iter_lists()

    def max_var(self) -> int:
        return self._arena.max_var()

    def __repr__(self) -> str:
        return f"_ClausesView({list(self)!r})"


def _append_guard(flat: np.ndarray, lens: np.ndarray, sel: int,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Append ``-sel`` to every row of a flat clause block (vectorised)."""
    k = int(lens.size)
    out_lens = lens + 1
    out = np.empty(int(flat.size) + k, dtype=np.int32)
    ends = np.cumsum(out_lens)
    out[ends - 1] = -sel
    mask = np.ones(out.size, dtype=bool)
    mask[ends - 1] = False
    out[mask] = flat
    return out, out_lens


# pairwise AMO groups emit via numpy above this size; below it the plain
# Python double loop beats array dispatch overhead (stream is identical)
_PAIRWISE_BULK_MIN = 9


class CNF:
    def __init__(self):
        self.n_vars = 0
        self.arena = ClauseArena()
        # set when an empty clause is recorded: the formula is trivially
        # UNSAT and every backend may (and should) fail fast on it
        self.trivially_unsat = False

    # ------------------------------------------------------- clause views
    @property
    def clauses(self) -> _ClausesView:
        return _ClausesView(self)

    @clauses.setter
    def clauses(self, value) -> None:
        if isinstance(value, ClauseArena):
            self.arena = value.copy()
        elif isinstance(value, _ClausesView):
            self.arena = value._arena.copy()
        else:
            a = ClauseArena()
            a.extend_rows(tuple(c) for c in value)
            self.arena = a

    def new_var(self) -> int:
        self.n_vars += 1
        return self.n_vars

    def new_vars(self, k: int) -> List[int]:
        return [self.new_var() for _ in range(k)]

    def add(self, *lits: int) -> None:
        if not lits:
            raise EmptyClauseError(
                "empty clause added directly (use add_clause([]))")
        self.arena.add(lits)

    def add_clause(self, lits: Sequence[int]) -> None:
        lits = tuple(lits)
        if not lits:
            self.trivially_unsat = True
        self.arena.add(lits)

    def extend_flat(self, flat: np.ndarray, lens: np.ndarray) -> None:
        """Bulk ``add_clause``: ``flat`` int32 concatenated rows, ``lens``
        per-row lengths. Zero-length rows mark ``trivially_unsat`` exactly
        like ``add_clause([])``."""
        lens = np.asarray(lens, dtype=np.int64)
        if lens.size == 0:
            return
        if not lens.all():
            self.trivially_unsat = True
        self.arena.extend_flat(np.asarray(flat, dtype=np.int32), lens)

    # ------------------------------------------------------------ cardinality
    def at_least_one(self, lits: Sequence[int]) -> None:
        self.add_clause(list(lits))

    def at_most_one(self, lits: Sequence[int], encoding: str = "pairwise",
                    pairwise_limit: int = 4) -> None:
        """Encode sum(lits) <= 1.

        ``"pairwise"`` is the paper's M(n) set: one binary clause per pair,
        O(k^2) clauses, no fresh variables. ``"sequential"`` is Sinz's
        LTSEQ with k-1 register variables and O(k) ternary clauses — but
        it *falls back to pairwise when* ``len(lits) <= pairwise_limit``
        (default 4): at k=4 pairwise costs 6 binary clauses while LTSEQ
        costs 3 fresh variables + 8 clauses, so tiny groups are strictly
        cheaper pairwise. ``pairwise_limit`` exposes that crossover so the
        encoder benchmark can sweep it; 1 disables the fallback entirely.

        Large pairwise groups are emitted as one vectorised block (same
        clause stream as the loop, bit for bit).
        """
        lits = list(lits)
        k = len(lits)
        if k <= 1:
            return
        if encoding == "pairwise" or k <= pairwise_limit:
            if k < _PAIRWISE_BULK_MIN:
                for i in range(k):
                    for j in range(i + 1, k):
                        self.add(-lits[i], -lits[j])
            else:
                neg = -np.asarray(lits, dtype=np.int32)
                iu, ju = np.triu_indices(k, 1)
                flat = np.empty(iu.size * 2, dtype=np.int32)
                flat[0::2] = neg[iu]
                flat[1::2] = neg[ju]
                self.extend_flat(flat, np.full(iu.size, 2, dtype=np.int64))
        elif encoding == "sequential":
            # Sinz 2005 LTSEQ: registers s_i == "some lit among first i+1 true"
            s = self.new_vars(k - 1)
            self.add(-lits[0], s[0])
            for i in range(1, k - 1):
                self.add(-lits[i], s[i])
                self.add(-s[i - 1], s[i])
                self.add(-lits[i], -s[i - 1])
            self.add(-lits[-1], -s[-1])
        else:
            raise ValueError(f"unknown AMO encoding {encoding!r}")

    def exactly_one(self, lits: Sequence[int], encoding: str = "pairwise",
                    pairwise_limit: int = 4) -> None:
        self.at_least_one(lits)
        self.at_most_one(lits, encoding, pairwise_limit=pairwise_limit)

    # ---------------------------------------------------------------- stats
    @property
    def n_clauses(self) -> int:
        return len(self.arena)

    def stats(self) -> Dict[str, int]:
        return {"vars": self.n_vars, "clauses": self.n_clauses,
                "lits": self.arena.n_lits}

    def to_dimacs(self) -> str:
        head = f"p cnf {self.n_vars} {self.n_clauses}\n"
        body = "\n".join(" ".join(map(str, c)) + " 0"
                         for c in self.arena.iter_tuples())
        return head + body + "\n"

    def check(self, assignment: Sequence[bool]) -> bool:
        """assignment[v-1] is the value of var v. True iff all clauses sat."""
        arena = self.arena
        n = len(arena)
        if n == 0:
            return True
        lens = arena.lens()
        if not lens.all():
            return False  # an empty clause is unsatisfiable
        lits = arena.lits_view()
        vals = np.asarray(assignment, dtype=bool)
        idx = np.abs(lits) - 1
        if int(idx.max()) >= vals.size:
            raise IndexError("assignment shorter than highest variable")
        true_lit = vals[idx] == (lits > 0)
        sat = np.logical_or.reduceat(true_lit, arena.offs_view()[:-1])
        return bool(sat.all())


@dataclass
class _IncLayer:
    selector: int                   # selector var guarding every clause
    start: int                      # [start, end) slice of self.clauses
    end: int
    var_start: int                  # vars created before this layer
    var_end: int


class IncrementalCNF(CNF):
    """Layered CNF for assumption-based incremental solving.

    Clauses added outside any layer form the shared *base* (unguarded —
    active in every solve). ``begin_layer(key)`` allocates a fresh selector
    variable ``s``; until ``end_layer()`` every added clause ``C`` is stored
    as ``C ∨ ¬s``, so the layer is inert unless the solve assumes ``s``.
    Layers are never removed — a solver that keeps the whole formula loaded
    retains every learned clause across layer switches, because assumptions
    are decisions, not axioms: anything the solver derives is a consequence
    of the (guarded) clause database alone and stays valid forever.

    ``assumptions_for(key)`` activates exactly one layer (and explicitly
    deactivates the others, so a solve is precisely base+delta regardless of
    solver phase defaults); ``project(key)`` materialises the equivalent
    plain :class:`CNF` for backends without assumption support (the batched
    WalkSAT) and for cold-path equivalence checks.
    """

    def __init__(self):
        super().__init__()
        self._layers: Dict[Hashable, _IncLayer] = {}
        self._open: Optional[_IncLayer] = None
        self._open_key: Optional[Hashable] = None
        self.n_base_vars = 0   # frozen at the first begin_layer()

    # ------------------------------------------------------------- layers
    def begin_layer(self, key: Hashable) -> int:
        """Open delta layer ``key``; returns its selector variable."""
        if self._open is not None:
            raise AssertionError("nested layers are not supported")
        if key in self._layers:
            raise AssertionError(f"layer {key!r} already encoded")
        if not self._layers:
            self.n_base_vars = self.n_vars
        sel = self.new_var()
        n = len(self.arena)
        self._open = _IncLayer(selector=sel, start=n, end=n,
                               var_start=self.n_vars, var_end=self.n_vars)
        self._open_key = key
        return sel

    def end_layer(self) -> None:
        if self._open is None:
            raise AssertionError("no open layer")
        self._open.end = len(self.arena)
        self._open.var_end = self.n_vars
        self._layers[self._open_key] = self._open
        self._open = None
        self._open_key = None

    def add_clause(self, lits: Sequence[int]) -> None:
        lits = tuple(lits)
        if self._open is not None:
            # an empty clause inside a layer is not a global contradiction:
            # it only forbids activating this layer, i.e. unit(¬selector)
            self.arena.add(lits + (-self._open.selector,))
            return
        if self._layers:
            raise AssertionError("base is frozen once the first layer exists")
        if not lits:
            self.trivially_unsat = True
        self.arena.add(lits)

    def add(self, *lits: int) -> None:
        if not lits:
            raise EmptyClauseError(
                "empty clause added directly (use add_clause([]))")
        self.add_clause(lits)

    def extend_flat(self, flat: np.ndarray, lens: np.ndarray) -> None:
        """Bulk ``add_clause`` — inside an open layer every row gets the
        ``¬selector`` guard appended (vectorised), matching the per-clause
        path bit for bit."""
        lens = np.asarray(lens, dtype=np.int64)
        if lens.size == 0:
            return
        flat = np.asarray(flat, dtype=np.int32)
        if self._open is not None:
            flat, lens = _append_guard(flat, lens, self._open.selector)
            self.arena.extend_flat(flat, lens)
            return
        if self._layers:
            raise AssertionError("base is frozen once the first layer exists")
        if not lens.all():
            self.trivially_unsat = True
        self.arena.extend_flat(flat, lens)

    # ------------------------------------------------------------ queries
    def layer_keys(self) -> List[Hashable]:
        return list(self._layers)

    def has_layer(self, key: Hashable) -> bool:
        return key in self._layers

    def selector(self, key: Hashable) -> int:
        return self._layers[key].selector

    def assumptions_for(self, key: Hashable) -> List[int]:
        """Assumption literals that activate exactly layer ``key``."""
        on = self._layers[key].selector
        return [on] + [-l.selector for k, l in self._layers.items()
                       if k != key]

    def layer_slice(self, key: Hashable) -> Tuple[int, int]:
        lay = self._layers[key]
        return lay.start, lay.end

    def layer_var_ranges(self) -> Dict[Hashable, Tuple[int, int, int]]:
        """Audit hook: ``{key: (selector, var_start, var_end)}`` per layer.

        A layer's variables are its selector (allocated first, so
        ``selector == var_start``) plus any aux vars created while it was
        open — the full range is ``var_start <= v <= var_end``.
        ``project(other_key)`` strips this layer's clauses
        entirely, so these variables legitimately occur in no clause of
        the projection — the CNF auditor uses this map to tell that
        expected deadness apart from a genuinely dangling variable."""
        return {k: (lay.selector, lay.var_start, lay.var_end)
                for k, lay in self._layers.items()}

    def project(self, key: Hashable) -> CNF:
        """Plain CNF equivalent to base + layer ``key`` (guards stripped).

        Variable numbering is preserved (selector/other-layer variables
        simply occur in no clause), so models are interchangeable with
        assumption solves over the full formula. Vectorised: base rows are
        one memcpy, layer rows drop their trailing guard literal with one
        masked copy (the guard position of every row is verified).
        """
        if self._open is not None:
            raise AssertionError("close the open layer before projecting")
        lay = self._layers[key]
        out = CNF()
        out.n_vars = self.n_vars
        offs = self.arena.offs_view()
        lits = self.arena.lits_view()
        base_end = min(l.start for l in self._layers.values())
        if base_end:
            base_lens = np.diff(offs[:base_end + 1])
            out.extend_flat(lits[:int(offs[base_end])], base_lens)
        s, e = lay.start, lay.end
        if e > s:
            row_offs = offs[s:e + 1]
            guard_pos = row_offs[1:] - 1
            if not (lits[guard_pos] == -lay.selector).all():
                raise AssertionError("layer guard literal mismatch")
            lo = int(row_offs[0])
            seg = lits[lo:int(row_offs[-1])]
            keep = np.ones(seg.size, dtype=bool)
            keep[guard_pos - lo] = False
            out.extend_flat(seg[keep], np.diff(row_offs) - 1)
        return out

    def layer_stats(self, key: Hashable) -> Dict[str, int]:
        lay = self._layers[key]
        base_end = min(l.start for l in self._layers.values())
        return {"vars": self.n_vars,
                "base_clauses": base_end,
                "delta_clauses": lay.end - lay.start,
                "clauses": base_end + (lay.end - lay.start)}
