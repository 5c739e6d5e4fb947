"""Mapping-campaign engine: procedural DFG corpus + sharded cell dataset.

The mapper's II sweep burns most of its wall-clock refuting IIs below the
true minimum, and the serving tier (PR 8) can absorb far more traffic than
the 11 suite kernels generate. This module is the *data flywheel* that
closes the loop (following the Gerador exemplar, SNIPPETS.md §3, and
GenMap's population-scale framing, §1–2):

  * **corpus** — :func:`random_dfg` grows loop DFGs from a seeded,
    level-structured grammar (op-class mix, loop-carried-dependence depth,
    fan-out / reconvergence knobs), and :func:`mutate_dfg` derives variants
    of existing kernels (op swaps, edge rewires, node growth, back-edge
    re-distancing, pure relabelings). Everything is driven by one
    ``random.Random`` stream — the same seed reproduces the corpus
    byte-for-byte in any process (no ``hash()``, no set iteration order).
  * **dedup** — :func:`canonical_key` canonicalises a DFG (Weisfeiler-
    Lehman colour refinement with individualise-and-refine tie-breaking)
    and keys it by the existing :func:`~repro_torch.core.service.dfg_signature`
    of the canonical form, so isomorphic mutants (any node relabeling)
    collapse to one corpus entry.
  * **dataset** — :class:`CampaignDataset` appends one compact
    :class:`CellRecord` per mapped (DFG × fabric) cell to sharded logs
    that reuse the exact :mod:`repro_torch.core.store` record framing (CRC'd
    frames, torn-tail tolerance, 8-byte alignment): canonical keys, the
    feature vector, per-II attempt outcomes, final II vs MII, wall-clock,
    and — for cells the sweep refuted outright — the MII projection's
    ``ClauseArena.to_bytes`` as a re-solvable UNSAT witness.
  * **campaign** — :func:`run_campaign` fans the (corpus × fabric
    gallery) grid through a :class:`~repro_torch.core.workers.WorkerPool`
    (affinity-sharded multi-process solves over one shared store) and
    streams records into the dataset as results land.

The dataset feeds :mod:`repro_torch.core.guide`: a small MLP trained with
torch on these records predicts each cell's feasible II, and the sweep
uses the prediction *soundly* — window seeding and candidate ordering
only, never skipping an II without a proven core.

This is the port of the JAX package's ``core/campaign.py``. Corpus,
canonical keys, features and cell keys are byte-identical to the
reference's. One difference: dataset records are read through the store's
restricted unpickler, so a record written by the JAX package (it names
``repro.core.campaign.CellRecord``) is skipped and counted in
:attr:`CampaignDataset.foreign_cells`, never imported.
"""
from __future__ import annotations

import copy
import io
import os
import pickle
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .dfg import DFG, Node
from .schedule import (Infeasible, asap_alap, node_latencies, rec_mii,
                       res_mii)
from .service import dfg_signature, topology_signature
from .store import (_FileLock, _RecordUnpickler, ForeignRecord,
                    StoreCorruption, iter_framed, key_hash, write_framed)

# campaign-cell record type in the shared store framing (MappingStore's
# scanner skips unknown rtypes, so these frames are forward-compatible
# with every reader of the format)
RT_CELL = 4

# ------------------------------------------------------------ canonical form


def _refine_colors(dfg: DFG, colors: Dict[int, object],
                   out_edges: Dict[int, List[Tuple[int, int, int]]],
                   ) -> Dict[int, int]:
    """Weisfeiler-Lehman colour refinement to a fixpoint. In-edges keep
    their slot order (operand position is semantic: sub/select/store are
    not commutative); out-edges contribute as a sorted multiset. Colours
    are re-ranked each round by *sorting the signature values*, never by
    ``hash()`` — the result is identical across processes."""
    n = len(dfg.nodes)
    for _ in range(n + 1):
        sigs = {}
        for nid, nd in dfg.nodes.items():
            ins_sig = tuple((dist, colors[src]) for src, dist in nd.ins)
            outs_sig = tuple(sorted(
                (dist, slot, colors[dst])
                for dst, slot, dist in out_edges[nid]))
            sigs[nid] = (colors[nid], ins_sig, outs_sig)
        ranks = {s: i for i, s in enumerate(sorted(set(sigs.values())))}
        new = {nid: ranks[sigs[nid]] for nid in dfg.nodes}
        if new == colors:
            return new
        colors = new
    return colors


def _relabel_nodes(dfg: DFG, order: List[int]) -> DFG:
    """Rebuild ``dfg`` with node ids renumbered by position in ``order``
    (names dropped: they are display-only and excluded from signatures)."""
    idx = {old: new for new, old in enumerate(order)}
    g = DFG(dfg.name)
    for new, old in enumerate(order):
        nd = dfg.nodes[old]
        g.nodes[new] = Node(new, nd.op,
                            tuple((idx[src], dist) for src, dist in nd.ins),
                            nd.imm, "")
    g.touch()
    return g


def canonical_dfg(dfg: DFG, budget: int = 128) -> DFG:
    """A canonical relabeling of ``dfg``: isomorphic DFGs (same structure
    under any node-id permutation) produce the *same* canonical form, so
    ``dfg_signature(canonical_dfg(g))`` is an isomorphism-invariant key.

    WL refinement separates almost every node of a realistic DFG; ties
    are broken by individualise-and-refine — each member of the first
    ambiguous colour class is individualised in turn, refinement recurses,
    and the lexicographically smallest resulting signature wins (truly
    automorphic nodes tie harmlessly: every branch yields the same form).
    ``budget`` caps the explored leaves; past it, remaining ties fall back
    to a deterministic (but only best-effort canonical) ordering — dedup
    then *over-keeps*, which is safe."""
    out_edges: Dict[int, List[Tuple[int, int, int]]] = {
        nid: [] for nid in dfg.nodes}
    for nid, nd in dfg.nodes.items():
        for slot, (src, dist) in enumerate(nd.ins):
            out_edges[src].append((nid, slot, dist))
    init: Dict[int, object] = {
        nid: (nd.op, nd.imm, len(nd.ins))
        for nid, nd in dfg.nodes.items()}
    base = _refine_colors(dfg, init, out_edges)

    best: List[Optional[Tuple[Tuple, List[int]]]] = [None]
    leaves = [0]

    def consider(order: List[int]) -> None:
        sig = dfg_signature(_relabel_nodes(dfg, order))
        if best[0] is None or sig < best[0][0]:
            best[0] = (sig, order)

    def search(colors: Dict[int, int]) -> None:
        groups: Dict[int, List[int]] = {}
        for nid, c in colors.items():
            groups.setdefault(c, []).append(nid)
        ambiguous = [c for c in sorted(groups) if len(groups[c]) > 1]
        if not ambiguous:
            leaves[0] += 1
            consider(sorted(dfg.nodes, key=lambda nid: colors[nid]))
            return
        if leaves[0] >= budget:
            # best-effort fallback: stable but not isomorphism-invariant
            leaves[0] += 1
            consider(sorted(dfg.nodes,
                            key=lambda nid: (colors[nid], nid)))
            return
        cls = groups[ambiguous[0]]
        for nid in sorted(cls):
            if leaves[0] >= budget:
                break
            forced = dict(colors)
            forced[nid] = -1          # unique smallest colour
            search(_refine_colors(dfg, forced, out_edges))

    search(base)
    if best[0] is None:
        raise RuntimeError("canonical_dfg: refinement search exhausted its "
                           "budget without producing a labelling")
    return _relabel_nodes(dfg, best[0][1])


def canonical_key(dfg: DFG) -> bytes:
    """Isomorphism-invariant digest of a DFG — the corpus dedup key and
    the ``dfg_key`` stored in every campaign cell record."""
    return key_hash(("campaign-dfg", dfg_signature(canonical_dfg(dfg))))


# ------------------------------------------------------------------ corpus

_ALU_OPS = ("add", "sub", "and", "or", "xor", "shl", "shr", "min", "max",
            "lt", "eq", "ne")

MUTATION_KINDS = ("relabel", "op", "imm", "rewire", "grow", "carry")


@dataclass(frozen=True)
class CorpusSpec:
    """Knobs of the seeded DFG grammar (one frozen spec = one corpus)."""
    seed: int = 0
    n_random: int = 96            # procedurally generated DFGs
    n_mutants: int = 64           # mutation attempts over the parent pool
    include_suite: bool = True    # seed the parent pool with suite kernels
    min_nodes: int = 6
    max_nodes: int = 18
    p_mem: float = 0.22           # op-class mix: P(load/store)
    p_mul: float = 0.12           # P(mul)
    p_select: float = 0.05        # P(3-input select)
    recent_window: int = 4        # input locality: how far back a chained
    #                               input reaches (controls path depth)
    p_far_edge: float = 0.30      # P(an input reaches *anywhere*) — the
    #                               fan-out / reconvergence knob
    p_carry: float = 0.65         # P(a DFG gets loop-carried back-edges)
    max_carry: int = 2            # loop-carried-dependence depth (max dist)


@dataclass
class CorpusItem:
    name: str
    dfg: DFG
    key: bytes                    # canonical (isomorphism-invariant) key
    kind: str                     # "suite" | "random" | "mutant:<kind>"


def random_dfg(rng, spec: CorpusSpec, name: str = "rand") -> DFG:
    """One grammar-generated loop DFG: iv/const sources, a level-built
    body whose op classes follow the spec's mix, input locality controlled
    by ``recent_window`` (chains) vs ``p_far_edge`` (fan-out and
    reconvergent paths), and optional loop-carried back-edges of distance
    1..``max_carry``. Always validates and executes."""
    g = DFG(name)
    n_target = rng.randint(spec.min_nodes, spec.max_nodes)
    values: List[int] = [g.add("iv", name="i")]
    for _ in range(rng.randint(1, 3)):
        values.append(g.add("const", imm=rng.randint(-64, 64)))

    def pick() -> int:
        if rng.random() < spec.p_far_edge:
            return values[rng.randrange(len(values))]
        lo = max(0, len(values) - spec.recent_window)
        return values[rng.randrange(lo, len(values))]

    while g.n < n_target:
        r = rng.random()
        if r < spec.p_mem:
            if rng.random() < 0.5:
                nid = g.add("load", [(pick(), 0)],
                            imm=rng.randrange(0, 512, 64))
            else:
                nid = g.add("store", [(pick(), 0), (pick(), 0)],
                            imm=rng.randrange(0, 512, 64))
        elif r < spec.p_mem + spec.p_mul:
            nid = g.add("mul", [(pick(), 0), (pick(), 0)])
        elif r < spec.p_mem + spec.p_mul + spec.p_select:
            nid = g.add("select", [(pick(), 0), (pick(), 0), (pick(), 0)])
        else:
            op = _ALU_OPS[rng.randrange(len(_ALU_OPS))]
            nid = g.add(op, [(pick(), 0), (pick(), 0)])
        values.append(nid)

    if rng.random() < spec.p_carry:
        # Loop-carried deps run from a *late* producer back to an *early*
        # consumer: the C2 window t_d - t_s <= (1-dist)*II + lat - 1 means
        # a dist-1 edge needs the consumer no later than the producer and
        # a dist-2 edge needs >= II cycles of slack, so endpoints are
        # chosen asap-aware (a uniform choice makes ~half the corpus
        # structurally unmappable at every II — bad training signal).
        asap, _alap, _L = asap_alap(g)
        targets = sorted((nid for nid in g.nodes if g.nodes[nid].ins),
                         key=lambda nid: (asap[nid], nid))
        for _ in range(rng.randint(1, 2)):
            dst = targets[rng.randrange(max(1, len(targets) // 2))]
            dist = 1 if (spec.max_carry < 2 or rng.random() < 0.8) \
                else rng.randint(2, spec.max_carry)
            late = [nid for nid in g.nodes
                    if asap[nid] >= asap[dst] + (dist - 1)]
            if not late:
                dist, late = 1, [nid for nid in g.nodes
                                 if asap[nid] >= asap[dst]]
            src = late[rng.randrange(len(late))]
            ins = list(g.nodes[dst].ins)
            ins[rng.randrange(len(ins))] = (src, dist)
            g.nodes[dst].ins = tuple(ins)
        g.touch()
    g.validate()
    return g


def mutate_dfg(dfg: DFG, rng, kind: Optional[str] = None,
               spec: Optional[CorpusSpec] = None) -> Tuple[DFG, str]:
    """One mutation of ``dfg`` -> (mutant, kind). ``relabel`` permutes
    node ids (an isomorphic copy — the dedup stress case); the others
    change structure or semantics: ``op`` swaps an ALU opcode, ``imm``
    perturbs a constant, ``rewire`` re-sources a forward edge (topo-safe),
    ``grow`` appends a consumer node, ``carry`` re-distances or adds a
    loop-carried back-edge."""
    spec = spec or CorpusSpec()
    kind = kind or MUTATION_KINDS[rng.randrange(len(MUTATION_KINDS))]
    if kind == "relabel":
        order = list(dfg.nodes)
        rng.shuffle(order)
        g = _relabel_nodes(dfg, order)
        g.name = dfg.name + "~relabel"
        return g, kind

    g = copy.deepcopy(dfg)
    g.name = dfg.name + "~" + kind
    if kind == "op":
        cands = [nid for nid, nd in g.nodes.items() if nd.op in _ALU_OPS]
        if cands:
            nid = cands[rng.randrange(len(cands))]
            choices = [op for op in _ALU_OPS if op != g.nodes[nid].op]
            g.nodes[nid].op = choices[rng.randrange(len(choices))]
    elif kind == "imm":
        cands = [nid for nid, nd in g.nodes.items() if nd.op == "const"]
        if cands:
            nid = cands[rng.randrange(len(cands))]
            g.nodes[nid].imm += rng.randint(1, 97)
    elif kind == "rewire":
        topo = g.topo_order()
        pos = {nid: i for i, nid in enumerate(topo)}
        cands = [(nid, slot) for nid, nd in g.nodes.items()
                 for slot, (_src, dist) in enumerate(nd.ins)
                 if dist == 0 and pos[nid] > 0]
        if cands:
            nid, slot = cands[rng.randrange(len(cands))]
            earlier = topo[:pos[nid]]
            src = earlier[rng.randrange(len(earlier))]
            ins = list(g.nodes[nid].ins)
            ins[slot] = (src, 0)
            g.nodes[nid].ins = tuple(ins)
    elif kind == "grow":
        a = rng.randrange(g.n)
        b = rng.randrange(g.n)
        op = _ALU_OPS[rng.randrange(len(_ALU_OPS))]
        g.add(op, [(a, 0), (b, 0)])
    elif kind == "carry":
        back = [(nid, slot) for nid, nd in g.nodes.items()
                for slot, (_src, dist) in enumerate(nd.ins) if dist > 0]
        if back:
            nid, slot = back[rng.randrange(len(back))]
            ins = list(g.nodes[nid].ins)
            src, _dist = ins[slot]
            ins[slot] = (src, rng.randint(1, max(2, spec.max_carry)))
            g.nodes[nid].ins = tuple(ins)
        else:
            targets = [nid for nid in g.nodes if g.nodes[nid].ins]
            if targets:
                nid = targets[rng.randrange(len(targets))]
                ins = list(g.nodes[nid].ins)
                slot = rng.randrange(len(ins))
                ins[slot] = (rng.randrange(g.n),
                             rng.randint(1, max(1, spec.max_carry)))
                g.nodes[nid].ins = tuple(ins)
    else:
        raise ValueError(f"unknown mutation kind {kind!r}")
    g.touch()
    g.validate()
    return g, kind


def build_corpus(spec: CorpusSpec,
                 ) -> Tuple[List[CorpusItem], Dict[str, int]]:
    """Generate the deduplicated corpus for ``spec``: suite kernels (when
    included), ``n_random`` grammar DFGs, and ``n_mutants`` mutations of
    uniformly chosen parents. Returns ``(items, stats)`` where stats
    counts generated/unique/duplicate DFGs — ``duplicates > 0`` is the
    expected steady state because relabel mutants collapse onto their
    parents by construction."""
    import random as _random
    rng = _random.Random(spec.seed)
    items: List[CorpusItem] = []
    seen: Dict[bytes, str] = {}
    generated = 0

    def admit(name: str, dfg: DFG, kind: str) -> bool:
        nonlocal generated
        generated += 1
        key = canonical_key(dfg)
        if key in seen:
            return False
        seen[key] = name
        items.append(CorpusItem(name=name, dfg=dfg, key=key, kind=kind))
        return True

    if spec.include_suite:
        from . import suite
        for name in suite.names():
            admit(name, suite.get(name), "suite")
    for i in range(spec.n_random):
        admit(f"rand{i:04d}", random_dfg(rng, spec, f"rand{i:04d}"),
              "random")
    parents = list(items)
    for i in range(spec.n_mutants):
        if not parents:
            break
        parent = parents[rng.randrange(len(parents))]
        try:
            mutant, kind = mutate_dfg(parent.dfg, rng, spec=spec)
        except ValueError:
            continue                  # a rewire made a forward cycle
        admit(f"{parent.name}~m{i:03d}", mutant, f"mutant:{kind}")
    stats = {"generated": generated, "unique": len(items),
             "duplicates": generated - len(items)}
    return items, stats


def corpus_digest(items: Sequence[CorpusItem]) -> str:
    """SHA-256 over the canonical encoding of every item's canonical key
    and signature — equal digests mean byte-identical corpora (the
    cross-process determinism contract)."""
    import hashlib
    h = hashlib.sha256()
    for item in items:
        h.update(item.key)
        h.update(canonical_key(item.dfg))
    return h.hexdigest()


# ---------------------------------------------------------------- features

N_FEATURES = 31


def cell_features(dfg: DFG, fabric) -> np.ndarray:
    """Fixed-length float32 feature vector for one (DFG, fabric) cell:
    DFG statistics, the KMS mobility histogram (per-node ``alap - asap``
    window sizes — the II-independent shape of the paper's KMS), and
    fabric geometry/capability/latency summary. This is the *input
    contract* of :mod:`repro_torch.core.guide` — extend only by appending and
    bumping ``N_FEATURES``."""
    from .arch import op_class
    lat = node_latencies(dfg, fabric)
    asap, alap, length = asap_alap(dfg, lat)
    n = max(1, dfg.n)
    edges = dfg.edges()
    back = [(s, d, dist) for s, d, dist in edges if dist > 0]
    fanout: Dict[int, int] = {}
    for s, _d, _dist in edges:
        fanout[s] = fanout.get(s, 0) + 1
    cls_counts = {"alu": 0, "mem": 0, "mul": 0}
    n_source = 0
    for nd in dfg.nodes.values():
        if nd.op in ("const", "iv"):
            n_source += 1
        cls_counts[op_class(nd.op)] += 1
    mob = np.array([alap[nid] - asap[nid] for nid in dfg.nodes],
                   dtype=np.int64)
    hist = np.bincount(np.clip(mob, 0, 5), minlength=6).astype(np.float32)
    hist /= n
    rmii = res_mii(dfg, fabric)
    rcmii = rec_mii(dfg, lat)
    mii = max(rmii, rcmii)
    rows = getattr(fabric, "rows", 0)
    cols = getattr(fabric, "cols", 0)
    n_pes = max(1, fabric.n_pes)
    deg = np.mean([len(fabric.neighbors(p))
                   for p in range(fabric.n_pes)]) if fabric.n_pes else 0.0
    regs = min(fabric.regs(p) for p in range(fabric.n_pes))
    lat_max = max(lat.values()) if lat else 1
    feats = [
        # --- DFG stats
        float(dfg.n),
        float(len(edges)),
        float(len(back)),
        float(max((dist for _s, _d, dist in back), default=0)),
        float(length),
        float(cls_counts["alu"]) / n,
        float(cls_counts["mem"]) / n,
        float(cls_counts["mul"]) / n,
        float(n_source) / n,
        float(max(fanout.values(), default=0)),
        float(sum(fanout.values())) / n,
        float(sum(1 for v in fanout.values() if v >= 2)) / n,
        # --- KMS mobility histogram + summary
        *hist.tolist(),                                       # 6 buckets
        float(mob.mean()) if mob.size else 0.0,
        float(mob.max()) if mob.size else 0.0,
        # --- lower bounds
        float(rmii),
        float(rcmii),
        float(mii),
        # --- fabric
        float(rows),
        float(cols),
        float(n_pes),
        float(len(fabric.pes_for_class("mem"))) / n_pes,
        float(len(fabric.pes_for_class("mul"))) / n_pes,
        float(deg),
        float(regs),
        float(lat_max),
    ]
    out = np.asarray(feats, dtype=np.float32)
    if out.shape != (N_FEATURES,):
        raise ValueError(f"cell feature vector has shape {out.shape}, "
                         f"expected ({N_FEATURES},) — keep N_FEATURES in "
                         f"sync with the feats list")
    return out


# ---------------------------------------------------------------- dataset


@dataclass
class CellRecord:
    """One campaign cell: everything the guide trainer (and any later
    analysis) needs, independent of the process that mapped it."""
    key: bytes                     # canonical cell key (dfg+fabric+config)
    dfg_key: bytes                 # canonical DFG key (corpus identity)
    name: str
    kind: str                      # corpus item kind
    fabric: str                    # fabric grammar name
    n_nodes: int
    features: np.ndarray           # float32[N_FEATURES]
    mii: int
    ii: Optional[int]              # final II (None when no mapping found)
    success: bool
    infeasible: bool
    attempts: Tuple[Tuple[int, str, str, float], ...]  # (ii, status, via, s)
    total_time: float
    sweep_width: int = 1
    witness: Optional[bytes] = None   # ClauseArena.to_bytes of the MII
    #                                   projection for refuted cells

    def to_payload(self) -> bytes:
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_payload(payload: bytes) -> "CellRecord":
        """Unpickle a record through the store's restricted unpickler:
        raises :class:`~repro_torch.core.store.ForeignRecord` for a record
        that names a module outside the port (the JAX package's)."""
        return _RecordUnpickler(io.BytesIO(payload)).load()

    @property
    def offset(self) -> Optional[int]:
        """The guide's training label: final II - MII (None = unmapped)."""
        return None if self.ii is None else self.ii - self.mii


class CampaignDataset:
    """Sharded campaign logs under ``path``: ``cells-<k>.log`` files of
    store-framed :data:`RT_CELL` records, routed by the cell key hash.
    Appends are flock-serialised per shard, so several campaign processes
    may share one dataset directory; reads tolerate torn tails (truncated
    away implicitly) and stop at — but survive — corrupt shards. Records
    that name a module outside the port are skipped and counted in
    ``foreign_cells`` (for the latest pass over the shards)."""

    def __init__(self, path: str, n_shards: int = 4):
        self.path = os.path.abspath(path)
        self.n_shards = max(1, n_shards)
        os.makedirs(self.path, exist_ok=True)
        self.corrupt_shards = 0
        self.foreign_cells = 0

    def shard_path(self, shard: int) -> str:
        return os.path.join(self.path, f"cells-{shard:02d}.log")

    def shard_of(self, key: bytes) -> int:
        return struct.unpack("<Q", key[:8])[0] % self.n_shards

    def append(self, rec: CellRecord) -> None:
        shard = self.shard_of(rec.key)
        path = self.shard_path(shard)
        with _FileLock(path + ".lock", exclusive=True):
            with open(path, "ab") as f:
                write_framed(f, RT_CELL, rec.key, rec.to_payload())
                f.flush()

    def iter_cells(self) -> Iterator[CellRecord]:
        self.foreign_cells = 0          # counted afresh on every pass
        for shard in range(self.n_shards):
            path = self.shard_path(shard)
            if not os.path.exists(path):
                continue
            try:
                for rtype, _key, payload, _off, _end in iter_framed(path):
                    if rtype != RT_CELL:
                        continue
                    try:
                        rec = CellRecord.from_payload(payload)
                    except ForeignRecord:
                        self.foreign_cells += 1
                        continue
                    yield rec
            except StoreCorruption:
                self.corrupt_shards += 1

    def __iter__(self) -> Iterator[CellRecord]:
        return self.iter_cells()

    def count(self) -> int:
        return sum(1 for _ in self.iter_cells())

    def describe(self) -> Dict[str, int]:
        sizes = [os.path.getsize(self.shard_path(s))
                 for s in range(self.n_shards)
                 if os.path.exists(self.shard_path(s))]
        return {"shards": self.n_shards, "bytes": sum(sizes),
                "cells": self.count(),
                "corrupt_shards": self.corrupt_shards,
                "foreign_cells": self.foreign_cells}


# --------------------------------------------------------------- campaign


@dataclass
class CampaignStats:
    cells: int = 0
    mapped: int = 0
    failed: int = 0                # swept every II, no mapping
    infeasible: int = 0            # structurally impossible cells
    witnesses: int = 0
    wall_s: float = 0.0
    cells_per_sec: float = 0.0
    errors: int = 0
    # the first few errors as "<item> on <fabric>: <type>: <message>" (the
    # JAX package counts them only)
    error_samples: List[str] = field(default_factory=list)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.__dict__)


def cell_key(dfg_key: bytes, fabric, cfg, sweep_width: int) -> bytes:
    """Canonical key of one campaign cell (mirrors the service cache key
    but swaps the raw DFG signature for the isomorphism-invariant corpus
    key)."""
    from dataclasses import astuple
    return key_hash(("campaign-cell", dfg_key, topology_signature(fabric),
                     astuple(cfg), sweep_width))


def _mii_witness(dfg: DFG, fabric, amo: str,
                 max_clauses: int = 50_000) -> Optional[bytes]:
    """The MII projection's clause arena for a refuted cell — a compact,
    self-contained formula any process can re-solve to re-check the
    verdict (the same pattern as ``MappingStore.verify_core``)."""
    try:
        from .encode import EncoderSession
        from .schedule import min_ii
        mii = min_ii(dfg, fabric)
        enc = EncoderSession(dfg, fabric, amo).encode(mii)
        if enc.cnf.n_clauses > max_clauses:
            return None
        return enc.cnf.arena.to_bytes()
    except Exception:
        return None


def run_campaign(items: Sequence[CorpusItem], fabrics: Sequence,
                 pool, dataset: Optional[CampaignDataset] = None,
                 cfg=None, sweep_width: int = 1,
                 max_in_flight: int = 128,
                 witness_unsat: bool = True,
                 progress=None) -> Tuple[CampaignStats, List[CellRecord]]:
    """Map every (corpus item × fabric) cell through ``pool`` (a
    :class:`~repro_torch.core.workers.WorkerPool` — or any object with the same
    ``submit``) and stream one :class:`CellRecord` per cell into
    ``dataset``. Returns (stats, records).

    Submission is bounded (``max_in_flight``) so a million-cell campaign
    never balloons the caller; records are appended as futures land.
    Structurally infeasible cells are recorded (they are real data — the
    guide must not be trained to predict IIs for them) and refuted cells
    get an MII-projection arena witness when ``witness_unsat``."""
    from collections import deque
    from .mapper import MapperConfig
    cfg = cfg or MapperConfig(timeout_s=30.0)
    stats = CampaignStats()
    records: List[CellRecord] = []
    t0 = time.time()

    grid = [(item, fabric) for item in items for fabric in fabrics]
    pending = deque()

    def harvest(block_one: bool) -> None:
        while pending and (block_one or pending[0][0].done()):
            fut, item, fabric, fname, feats = pending.popleft()
            block_one = False
            try:
                res = fut.result(timeout=max(60.0, 4 * cfg.timeout_s))
            except Exception as err:
                stats.errors += 1
                if len(stats.error_samples) < 8:
                    stats.error_samples.append(
                        f"{item.name} on {fname}: {type(err).__name__}: "
                        f"{err}")
                continue
            rec = _record_of(item, fabric, fname, feats, res, cfg,
                             sweep_width, witness_unsat)
            stats.cells += 1
            if rec.infeasible:
                stats.infeasible += 1
            elif rec.success:
                stats.mapped += 1
            else:
                stats.failed += 1
            if rec.witness is not None:
                stats.witnesses += 1
            if dataset is not None:
                dataset.append(rec)
            records.append(rec)
            if progress is not None:
                progress(stats)

    for item, fabric in grid:
        fname = str(fabric)
        try:
            feats = cell_features(item.dfg, fabric)
        except Infeasible:
            feats = None
        if feats is None:
            # res_mii-infeasible: record without ever touching the pool
            rec = CellRecord(
                key=cell_key(item.key, fabric, cfg, sweep_width),
                dfg_key=item.key, name=item.name, kind=item.kind,
                fabric=fname, n_nodes=item.dfg.n,
                features=np.zeros(N_FEATURES, dtype=np.float32),
                mii=0, ii=None, success=False, infeasible=True,
                attempts=(), total_time=0.0, sweep_width=sweep_width)
            stats.cells += 1
            stats.infeasible += 1
            if dataset is not None:
                dataset.append(rec)
            records.append(rec)
            continue
        fut = pool.submit(item.dfg, fabric, cfg, sweep_width=sweep_width)
        pending.append((fut, item, fabric, fname, feats))
        if len(pending) >= max_in_flight:
            harvest(block_one=True)
    while pending:
        harvest(block_one=True)

    stats.wall_s = time.time() - t0
    stats.cells_per_sec = stats.cells / max(stats.wall_s, 1e-9)
    return stats, records


def _record_of(item: CorpusItem, fabric, fname: str, feats: np.ndarray,
               res, cfg, sweep_width: int,
               witness_unsat: bool) -> CellRecord:
    attempts = tuple(
        (int(a.ii), str(a.status), str(a.via), float(a.solve_time))
        for a in res.attempts)
    infeasible = bool(res.infeasible)
    success = bool(res.success)
    witness = None
    if witness_unsat and not success and not infeasible:
        witness = _mii_witness(item.dfg, fabric, cfg.amo)
    return CellRecord(
        key=cell_key(item.key, fabric, cfg, sweep_width),
        dfg_key=item.key, name=item.name, kind=item.kind, fabric=fname,
        n_nodes=item.dfg.n, features=feats, mii=int(res.mii),
        ii=None if res.ii is None else int(res.ii), success=success,
        infeasible=infeasible, attempts=attempts,
        total_time=float(res.total_time), sweep_width=sweep_width,
        witness=witness)


__all__ = [
    "RT_CELL", "N_FEATURES", "MUTATION_KINDS",
    "CorpusSpec", "CorpusItem", "CellRecord", "CampaignDataset",
    "CampaignStats",
    "canonical_dfg", "canonical_key", "random_dfg", "mutate_dfg",
    "build_corpus", "corpus_digest", "cell_features", "cell_key",
    "run_campaign",
]
