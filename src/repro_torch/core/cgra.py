"""CGRA architecture model (legacy front end).

The target architecture (paper Fig. 1): a 2-D mesh of processing elements
(PEs). Each PE has a single-cycle ALU, ``n_regs`` local registers, and an
output register readable by its 4-neighbours in later cycles. Memory lines
give (by default all) PEs load/store access.

:class:`CGRA` is kept as a thin adapter over the declarative
:class:`repro_torch.core.arch.ArchSpec`: the homogeneous ``spec`` it constructs
is the single source of truth for neighbour tables, capability checks, and
the service-keying ``signature()``, so a ``CGRA(4, 4)`` and an
``arch("4x4")`` describe — and pool as — the identical fabric. New code
(and every heterogeneous fabric) should use ``ArchSpec`` /
:func:`repro_torch.core.arch.arch` directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import FrozenSet, Tuple

from .arch import OP_CLASSES, ArchSpec, parse_fabric


@dataclass(frozen=True)
class CGRA:
    rows: int
    cols: int
    n_regs: int = 4
    # "mesh" (paper) | "torus" | "diag" | "onehop" (HyCUBE-style bypass)
    topology: str = "mesh"
    # PE ids with memory access; None -> all PEs can load/store (paper default)
    mem_pes: Tuple[int, ...] | None = None
    # per-op-class latency table as sorted (cls, cycles) items; None -> the
    # paper's all-unit-latency model
    latencies: Tuple[Tuple[str, int], ...] | None = None

    @cached_property
    def spec(self) -> ArchSpec:
        """The equivalent homogeneous :class:`ArchSpec` (ground truth for
        neighbours, capabilities, latencies, and the service signature)."""
        caps = None
        if self.mem_pes is not None:
            with_mem = frozenset(OP_CLASSES)
            without = with_mem - {"mem"}
            mem = set(self.mem_pes)
            caps = tuple(with_mem if p in mem else without
                         for p in range(self.rows * self.cols))
        return ArchSpec(self.rows, self.cols, self.topology,
                        pe_caps=caps, pe_regs=self.n_regs,
                        op_lat=self.latencies)

    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    def coords(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.cols)

    def pe(self, r: int, c: int) -> int:
        return r * self.cols + c

    def neighbors(self, p: int) -> FrozenSet[int]:
        """PEs whose output register PE ``p``'s operands can read (excl. self)."""
        return self.spec._neighbors[p]

    def reachable(self, src: int, dst: int) -> bool:
        """True if a value produced on ``src`` is directly consumable on ``dst``."""
        return self.spec.reachable(src, dst)

    def can_mem(self, p: int) -> bool:
        return self.spec.can_mem(p)

    def can_execute(self, p: int, op: str) -> bool:
        return self.spec.can_execute(p, op)

    def pes_for(self, op: str) -> Tuple[int, ...]:
        return self.spec.pes_for(op)

    def pes_for_class(self, cls: str) -> Tuple[int, ...]:
        return self.spec.pes_for_class(cls)

    def regs(self, p: int) -> int:
        return self.n_regs

    def lat(self, cls: str) -> int:
        """Latency (cycles) of op class ``cls`` (1 unless ``latencies``
        says otherwise)."""
        return self.spec.lat(cls)

    def lat_of(self, op: str) -> int:
        return self.spec.lat_of(op)

    def signature(self) -> Tuple:
        return self.spec.signature()

    def __str__(self) -> str:  # pragma: no cover
        return f"CGRA({self.rows}x{self.cols}, {self.topology}, {self.n_regs} regs)"


def cgra_from_name(name: str, **kw) -> CGRA:
    """'4x4' -> CGRA(4, 4); the grammar also carries the interconnect,
    register count, and op-class latencies: '4x4-torus' ->
    CGRA(4, 4, topology="torus"), '8x8:r8' -> CGRA(8, 8, n_regs=8),
    '4x4:mul2:mem2' -> 2-cycle multipliers and memory ports,
    '4x4-onehop:r2' combines suffixes. Explicit keyword arguments win
    over name suffixes."""
    rows, cols, interconnect, regs, lats = parse_fabric(name)
    if interconnect == "custom":
        raise ValueError("custom adjacency needs repro_torch.core.arch.arch(), "
                         "not cgra_from_name()")
    kw.setdefault("topology", interconnect)
    if regs is not None:
        kw.setdefault("n_regs", regs)
    if lats:
        kw.setdefault("latencies", tuple(sorted(lats.items())))
    return CGRA(rows, cols, **kw)
