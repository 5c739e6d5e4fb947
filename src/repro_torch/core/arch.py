"""Declarative CGRA architecture specification.

The paper targets one fixed fabric (Fig. 1: a 4-neighbour mesh of identical
PEs), but the SAT formulation only ever reads two things off the hardware:
a *reachability* relation (which PE's output register can each PE consume)
and per-PE *capabilities* (which operations may execute where, how many
local registers back them). :class:`ArchSpec` makes exactly those two
things declarative data, so real CGRA variants — HyCUBE-style one-hop
bypass links, memory-restricted PE columns, heterogeneous multiplier
placement — are a spec change, not a code change.

Operations are grouped into *op classes*; a PE's capability set says which
classes it executes:

  * ``"mem"`` — ``load`` / ``store`` (the paper's memory-line access),
  * ``"mul"`` — ``mul`` / ``div`` / ``rem`` (the expensive functional unit
    real fabrics place sparsely),
  * ``"alu"`` — everything else (single-cycle ALU ops).

Op classes also carry a *latency* (``ArchSpec.lat(cls)``, cycles from
issue to result availability). The paper's fabric is fully unit-latency;
HyCUBE/ADRES-class fabrics pipeline multipliers and memory ports over
2+ cycles. Latencies default to 1 everywhere — and with every latency 1
the whole mapping pipeline (KMS windows, CNF, register allocation,
simulator) is bit-identical to the unit-latency model, so unit fabrics
keep their exact pre-latency signatures and pooled solver sessions.

Interconnects: ``"mesh"`` (paper Fig. 1), ``"torus"`` (wrap-around),
``"diag"`` (8-neighbour), ``"onehop"`` (mesh plus one-hop bypass links two
steps along each row/column, HyCUBE-flavoured), and ``"custom"`` (an
explicit adjacency list).

The :func:`arch` builder parses compact fabric names —

    arch("4x4")                          # the paper's homogeneous mesh
    arch("4x4-torus", regs=8)            # wrap-around links, 8 regs per PE
    arch("8x8:r8")                       # ':rN' register-count suffix
    arch("4x4-onehop", mem="col0")       # loads/stores only on column 0
    arch("4x4", mul="corners", mem="row0")
    arch("4x4-torus:r8:mul2:mem2")       # 2-cycle multipliers + memory
    arch("4x4", lat={"mul": 3})          # explicit latency table

— where ``mem=`` / ``mul=`` / ``alu=`` restrict an op class to a *region*
(``"all"``, ``"none"``, ``"colK"``, ``"rowK"``, ``"corners"``,
``"border"``, ``"even"``/``"odd"`` checkerboards, or an explicit iterable
of PE ids). ``ArchSpec.signature()`` is the stable key the mapping service
pools solver sessions by; the legacy :class:`repro_torch.core.cgra.CGRA` adapter
delegates here, so equivalent homogeneous fabrics share one signature (and
one pooled session) regardless of which front-end class described them.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, FrozenSet, Iterable, Optional, Sequence, Tuple, Union

# ------------------------------------------------------------- op classes

OP_CLASS_OF: Dict[str, str] = {
    "load": "mem", "store": "mem",
    "mul": "mul", "div": "mul", "rem": "mul",
}
OP_CLASSES: Tuple[str, ...] = ("alu", "mem", "mul")

INTERCONNECTS: Tuple[str, ...] = ("mesh", "torus", "diag", "onehop",
                                  "custom")
_TOPO_ALIASES = {"": "mesh", "mesh": "mesh", "torus": "torus",
                 "diag": "diag", "diagonal": "diag",
                 "onehop": "onehop", "one-hop": "onehop", "1hop": "onehop",
                 "hycube": "onehop", "custom": "custom"}


def op_class(op: str) -> str:
    """The resource class a DFG op occupies ("alu" | "mem" | "mul")."""
    return OP_CLASS_OF.get(op, "alu")


# ---------------------------------------------------------------- regions


def region(spec, rows: int, cols: int) -> FrozenSet[int]:
    """Resolve a region spec to a set of PE ids on a rows x cols grid.

    ``None``/``"all"`` -> every PE; ``"none"`` -> no PE; ``"colK"`` /
    ``"rowK"`` (K may be negative, python-style) -> one column/row;
    ``"corners"`` / ``"border"`` / ``"even"`` / ``"odd"`` -> the obvious
    geometric subsets; any iterable of ints -> those PE ids.
    """
    n = rows * cols
    if spec is None:
        return frozenset(range(n))
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "all":
            return frozenset(range(n))
        if s == "none":
            return frozenset()
        if s.startswith("col") or s.startswith("row"):
            try:
                k = int(s[3:])
            except ValueError:
                raise ValueError(f"bad region {spec!r}: expected "
                                 f"'{s[:3]}<int>'") from None
            if s.startswith("col"):
                k %= cols
                return frozenset(r * cols + k for r in range(rows))
            k %= rows
            return frozenset(k * cols + c for c in range(cols))
        if s == "corners":
            return frozenset({0, cols - 1, (rows - 1) * cols, n - 1})
        if s == "border":
            return frozenset(r * cols + c for r in range(rows)
                             for c in range(cols)
                             if r in (0, rows - 1) or c in (0, cols - 1))
        if s in ("even", "odd"):
            want = 0 if s == "even" else 1
            return frozenset(r * cols + c for r in range(rows)
                             for c in range(cols) if (r + c) % 2 == want)
        raise ValueError(f"unknown region {spec!r}")
    try:
        pes = frozenset(int(p) for p in spec)
    except TypeError:
        raise ValueError(f"bad region {spec!r}: expected a region name or "
                         f"an iterable of PE ids") from None
    for p in pes:
        if not 0 <= p < n:
            raise ValueError(f"region PE id {p} outside [0, {n})")
    return pes


# ----------------------------------------------------------- fabric names


def parse_fabric(name: str) -> Tuple[int, int, str, Optional[int],
                                     Dict[str, int]]:
    """Parse ``"RxC[-topology][:rN][:clsK...]"`` ->
    (rows, cols, interconnect, regs, latencies).

    ``regs`` is None when the name carries no ``:rN`` suffix. Any number
    of ``:aluK`` / ``:memK`` / ``:mulK`` suffixes set that op class's
    latency to K cycles (``latencies`` is {} when none appear). Examples:
    ``"4x4"``, ``"4x4-torus"``, ``"8x8:r8"``, ``"4x4-one-hop:r2"``,
    ``"4x4-torus:r8:mul2:mem2"``.
    """
    parts = name.strip().split(":")
    base, regs, lats = parts[0], None, {}
    for suf in parts[1:]:
        s = suf.strip().lower()
        if s.startswith("r") and s[1:].isdigit():
            regs = int(s[1:])
        elif s[:3] in OP_CLASSES and s[3:].isdigit():
            lats[s[:3]] = int(s[3:])
        else:
            raise ValueError(f"bad fabric suffix {s!r} in {name!r} "
                             f"(expected ':rN' or ':aluK'/':memK'/':mulK', "
                             f"e.g. '4x4:r8:mul2')")
    geom, _, topo = base.partition("-")
    interconnect = _TOPO_ALIASES.get(topo.strip().lower())
    if interconnect is None:
        raise ValueError(f"unknown interconnect {topo!r} in {name!r} "
                         f"(know: {', '.join(sorted(set(_TOPO_ALIASES) - {''}))})")
    r, x, c = geom.strip().lower().partition("x")
    if x != "x" or not (r.isdigit() and c.isdigit()):
        raise ValueError(f"bad fabric geometry {geom!r} in {name!r} "
                         f"(expected 'RxC', e.g. '4x4')")
    return int(r), int(c), interconnect, regs, lats


# ----------------------------------------------------------------- spec


@dataclass(frozen=True)
class ArchSpec:
    """Declarative CGRA fabric: geometry + interconnect + per-PE
    capability sets + per-PE register counts.

    ``pe_caps[p]`` is the frozenset of op classes PE ``p`` executes
    (``None`` normalises to "every class everywhere" — the paper's
    homogeneous fabric). ``pe_regs`` is per-PE local register counts (an
    int normalises to a uniform tuple). ``adjacency`` (required iff
    ``interconnect == "custom"``) lists, per PE, the PEs whose operands
    may read *its* output register. ``op_lat`` is the per-op-class
    latency table (mapping or item tuple, cycles from issue to result);
    absent classes — and ``None`` — mean unit latency, and an all-unit
    table normalises to ``None`` so unit-latency fabrics compare and
    ``signature()`` exactly as before latencies existed.
    """
    rows: int
    cols: int
    interconnect: str = "mesh"
    pe_caps: Optional[Tuple[FrozenSet[str], ...]] = None
    pe_regs: Union[int, Tuple[int, ...]] = 4
    adjacency: Optional[Tuple[Tuple[int, ...], ...]] = None
    op_lat: Optional[Tuple[Tuple[str, int], ...]] = None
    name: str = ""

    def __post_init__(self):
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"bad geometry {self.rows}x{self.cols}")
        inter = _TOPO_ALIASES.get(str(self.interconnect).strip().lower())
        if inter is None:
            raise ValueError(f"unknown interconnect {self.interconnect!r}")
        object.__setattr__(self, "interconnect", inter)
        n = self.rows * self.cols
        # capabilities: None -> homogeneous (all classes on every PE)
        if self.pe_caps is None:
            caps = tuple(frozenset(OP_CLASSES) for _ in range(n))
        else:
            caps = tuple(frozenset(c) for c in self.pe_caps)
            if len(caps) != n:
                raise ValueError(f"pe_caps has {len(caps)} entries for "
                                 f"{n} PEs")
            for p, cs in enumerate(caps):
                bad = cs - set(OP_CLASSES)
                if bad:
                    raise ValueError(f"PE {p}: unknown op classes {bad}")
        object.__setattr__(self, "pe_caps", caps)
        # registers: int -> uniform per-PE tuple
        regs = self.pe_regs
        if isinstance(regs, int):
            regs = (regs,) * n
        else:
            regs = tuple(int(r) for r in regs)
        if len(regs) != n:
            raise ValueError(f"pe_regs has {len(regs)} entries for {n} PEs")
        if any(r < 0 for r in regs):
            raise ValueError("negative register count")
        object.__setattr__(self, "pe_regs", regs)
        # latencies: mapping/items -> canonical sorted tuple; all-unit -> None
        if self.op_lat is not None:
            lat = dict(self.op_lat)
            bad = set(lat) - set(OP_CLASSES)
            if bad:
                raise ValueError(f"unknown op classes in op_lat: {bad}")
            lat = {c: int(v) for c, v in lat.items()}
            if any(v < 1 for v in lat.values()):
                raise ValueError("op latencies must be >= 1 cycle")
            lat = {c: v for c, v in lat.items() if v != 1}
            object.__setattr__(self, "op_lat",
                               tuple(sorted(lat.items())) or None)
        # adjacency: custom interconnect only; normalised (sorted, no self)
        if (self.adjacency is None) != (inter != "custom"):
            raise ValueError("adjacency is required iff "
                             "interconnect == 'custom'")
        if self.adjacency is not None:
            adj = tuple(tuple(sorted({int(q) for q in row} - {p}))
                        for p, row in enumerate(self.adjacency))
            if len(adj) != n:
                raise ValueError(f"adjacency has {len(adj)} rows for "
                                 f"{n} PEs")
            for p, row in enumerate(adj):
                for q in row:
                    if not 0 <= q < n:
                        raise ValueError(f"adjacency[{p}]: PE id {q} "
                                         f"outside [0, {n})")
            object.__setattr__(self, "adjacency", adj)

    # ----------------------------------------------------------- geometry
    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    def coords(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.cols)

    def pe(self, r: int, c: int) -> int:
        return r * self.cols + c

    # ------------------------------------------------------- interconnect
    @cached_property
    def _neighbors(self) -> Tuple[FrozenSet[int], ...]:
        if self.interconnect == "custom":
            return tuple(frozenset(row) for row in self.adjacency)
        deltas = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        if self.interconnect == "diag":
            deltas += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        elif self.interconnect == "onehop":
            # HyCUBE-style one-hop bypass: a value also crosses *two* PEs
            # along a straight row/column in a single cycle
            deltas += [(-2, 0), (2, 0), (0, -2), (0, 2)]
        out = []
        for p in range(self.n_pes):
            r, c = self.coords(p)
            acc = set()
            for dr, dc in deltas:
                nr, nc = r + dr, c + dc
                if self.interconnect == "torus":
                    q = self.pe(nr % self.rows, nc % self.cols)
                    # degenerate grids (1 row/col, 2-wide wrap) can fold a
                    # delta back onto p itself; neighbours exclude self by
                    # contract, so drop those wraparounds here
                    if q != p:
                        acc.add(q)
                elif 0 <= nr < self.rows and 0 <= nc < self.cols:
                    acc.add(self.pe(nr, nc))
            out.append(frozenset(acc))
        return tuple(out)

    def neighbors(self, p: int) -> FrozenSet[int]:
        """PEs whose operands can read PE ``p``'s output register
        (excl. self)."""
        return self._neighbors[p]

    def reachable(self, src: int, dst: int) -> bool:
        """True if a value produced on ``src`` is directly consumable on
        ``dst``."""
        return src == dst or dst in self._neighbors[src]

    # ------------------------------------------------------- capabilities
    @cached_property
    def _pes_by_class(self) -> Dict[str, Tuple[int, ...]]:
        return {cls: tuple(p for p in range(self.n_pes)
                           if cls in self.pe_caps[p])
                for cls in OP_CLASSES}

    def can_execute(self, p: int, op: str) -> bool:
        """True if PE ``p`` supports the op class of DFG op ``op``."""
        return op_class(op) in self.pe_caps[p]

    def pes_for(self, op: str) -> Tuple[int, ...]:
        """Ascending PE ids able to execute ``op`` (the encoder's
        allowed-PE set for a node with that op)."""
        return self._pes_by_class[op_class(op)]

    def pes_for_class(self, cls: str) -> Tuple[int, ...]:
        return self._pes_by_class[cls]

    def can_mem(self, p: int) -> bool:
        return "mem" in self.pe_caps[p]

    def regs(self, p: int) -> int:
        """Local register count of PE ``p``."""
        return self.pe_regs[p]

    # ----------------------------------------------------------- latencies
    @cached_property
    def _lat_map(self) -> Dict[str, int]:
        return dict(self.op_lat or ())

    def lat(self, cls: str) -> int:
        """Latency (cycles, >= 1) of op class ``cls``; classes absent
        from the table are single-cycle."""
        return self._lat_map.get(cls, 1)

    def lat_of(self, op: str) -> int:
        """Latency of the DFG op ``op`` (via its op class)."""
        return self._lat_map.get(op_class(op), 1)

    @property
    def unit_latency(self) -> bool:
        """True when every op class is single-cycle (the paper's model)."""
        return self.op_lat is None

    # ----------------------------------------------------------- identity
    def signature(self) -> Tuple:
        """Stable hashable identity of everything the encoding, register
        allocation, and simulator read off the fabric — the mapping
        service's solver-pool / result-cache key component. The latency
        table is appended only when some class is multi-cycle, so
        unit-latency fabrics keep their exact pre-latency signatures
        (existing caches, pooled sessions, and proven-UNSAT registries
        stay valid)."""
        sig = ("arch", self.rows, self.cols, self.interconnect,
               self.adjacency,
               tuple(tuple(sorted(c)) for c in self.pe_caps),
               self.pe_regs)
        if self.op_lat is not None:
            sig = sig + (("lat",) + self.op_lat,)
        return sig

    def __str__(self) -> str:  # pragma: no cover
        n = self.n_pes
        regs = (str(self.pe_regs[0]) if len(set(self.pe_regs)) == 1
                else f"{min(self.pe_regs)}-{max(self.pe_regs)}")
        parts = [f"{self.rows}x{self.cols}-{self.interconnect}",
                 f"regs={regs}"]
        for cls in ("mem", "mul"):
            k = len(self._pes_by_class[cls])
            if k != n:
                parts.append(f"{cls}={k}/{n}")
        if self.op_lat is not None:
            parts.append("lat=" + ",".join(f"{c}:{v}" for c, v in self.op_lat))
        label = f" {self.name!r}" if self.name else ""
        return f"Arch({', '.join(parts)}{label})"


# ---------------------------------------------------------------- builder


def arch(name: str = "4x4", *, regs=None, mem=None, mul=None, alu=None,
         lat: Optional[Dict[str, int]] = None,
         adjacency: Optional[Sequence[Iterable[int]]] = None) -> ArchSpec:
    """Build an :class:`ArchSpec` from a compact fabric name plus optional
    heterogeneity knobs.

    ``name`` follows ``"RxC[-topology][:rN][:clsK...]"`` (see
    :func:`parse_fabric`). ``regs`` overrides the register count (int, or
    a per-PE sequence). ``mem`` / ``mul`` / ``alu`` restrict that op
    class to a *region* (see :func:`region`); unset classes stay
    available on every PE. ``lat`` is a per-op-class latency table
    ({"mul": 2, ...}; entries win over the name's ``:mulK``-style
    suffixes, unset classes are single-cycle). ``adjacency`` switches the
    interconnect to ``"custom"`` with the given per-PE consumer lists.
    """
    rows, cols, interconnect, suffix_regs, suffix_lat = parse_fabric(name)
    if adjacency is not None:
        interconnect = "custom"
        adjacency = tuple(tuple(row) for row in adjacency)
    if regs is None:
        regs = suffix_regs if suffix_regs is not None else 4
    lat_map = dict(suffix_lat)
    if lat:
        lat_map.update(lat)
    n = rows * cols
    caps = [set(OP_CLASSES) for _ in range(n)]
    for cls, spec in (("mem", mem), ("mul", mul), ("alu", alu)):
        if spec is None:
            continue
        allowed = region(spec, rows, cols)
        for p in range(n):
            if p not in allowed:
                caps[p].discard(cls)
    return ArchSpec(rows, cols, interconnect,
                    tuple(frozenset(c) for c in caps),
                    regs if isinstance(regs, int) else tuple(regs),
                    adjacency=adjacency,
                    op_lat=tuple(sorted(lat_map.items())) or None,
                    name=name)
