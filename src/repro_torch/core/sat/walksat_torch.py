"""Batched probSAT/WalkSAT in PyTorch — the mapper's accelerator search path.

The port of the JAX package's ``repro/core/sat/walksat_jax.py``. The KMS
CNF is lowered to dense padded tensors; a *batch* of candidate assignments
walks in parallel (one probSAT chain per batch row), so clause evaluation
becomes regular tensor work. The first chain to satisfy a formula wins.

Two engines drive the chunked walk, bit-compatible for a fixed seed:

  * ``engine="device"`` (default) — the chunk loop stays on the device. The
    host plans chunk lengths with :func:`_next_chunk` (no device read
    needed), enqueues ``_POLL_CHUNKS`` chunks per segment, and then reads
    one small status tensor (per-candidate solved flags) to poll
    ``stop()`` / ``should_skip`` and extract freshly certified models.
    Per-candidate solved flags, first-solution snapshots and
    best-over-all-chunks near-miss state are device tensors; nothing inside
    a segment waits for the device.
  * ``engine="host"`` — the reference loop: one chunk per host iteration,
    true counts recomputed at the chunk start, flags read after every
    chunk. Kept as the oracle of the device engine and selectable via
    ``REPRO_WALKSAT_ENGINE=host``.

Both engines share one inner step (:func:`_pick_flip` plus the
``flip_update`` kernel) and draw their noise from one ``torch.Generator``
in the same order, so they return identical results. The step samples as
``jax.random.categorical`` does — ``argmax(logits + gumbel)`` — with the
Gumbel noise an explicit input, so given the same noise it picks exactly
what the JAX step picks. True counts come from the ``clause_eval`` kernel
and the flip + incremental count update from the ``flip_update`` kernel;
on CPU tensors both take their plain torch versions.

This solver is incomplete: it can certify SAT but returns UNKNOWN instead of
UNSAT — the Fig. 3 loop then falls back to CDCL for the UNSAT proof.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.clause_eval import true_counts_window
from ...kernels.flip_update import flip_update
from ..cnf import CNF

_INT32_MAX = np.iinfo(np.int32).max

# chunks walked on-device between host polls of the status tensor (device
# engine): larger values amortise the poll, smaller values make stop()/
# should_skip() more responsive. The per-chunk step count is already
# bounded by formula size (see _chunk_plan).
_POLL_CHUNKS = 4


class NonModelError(RuntimeError):
    """A walksat leg returned an assignment that does not satisfy its CNF.

    This is a *miscompiled-kernel / packer-bug* guard, not a user error: a
    chain is only reported SAT after its padded true-count vector shows
    every clause satisfied, so a failing ``CNF.check`` means the device
    computation and the host formula disagree. Raised as a structured
    error (never a bare ``assert``) so the guard survives ``python -O``.
    """


def _validate_model(cnf: CNF, model: List[bool], ctx: str) -> None:
    if not cnf.check(model):
        raise NonModelError(
            f"walksat returned a non-model ({ctx}): device true-counts "
            f"claim SAT but CNF.check fails on {cnf.n_vars} vars / "
            f"{cnf.n_clauses} clauses")


class PackedCNF(NamedTuple):
    """A stacked window pack as torch tensors on the walk's device."""
    cvars: torch.Tensor  # [K, C, Lmax] int32 var ids (1-based), 0 = padding
    csign: torch.Tensor  # [K, C, Lmax] bool, True = positive literal
    ovars: torch.Tensor  # [K, V+1, Omax] int32 clause ids, -1 = padding
    osign: torch.Tensor  # [K, V+1, Omax] bool sign of the var in that clause
    n_vars: int
    n_clauses: int


class HostPack(NamedTuple):
    """Host-side (numpy) pack: of one CNF ([C, L] / [V+1, O]) from
    :func:`pack_cnf_np`, or of a stacked window from
    :func:`pack_cnf_window_np` — what the session-level pack cache stores,
    so reuse never round-trips through device tensors."""
    cvars: np.ndarray
    csign: np.ndarray
    ovars: np.ndarray
    osign: np.ndarray
    n_vars: int
    n_clauses: int


def pack_cnf_np(cnf: CNF) -> HostPack:
    """Vectorised dense pack of one CNF, straight off the clause arena.

    The arena *is* the CSR form of the formula — ``lits[offs[i]:offs[i+1]]``
    is clause i — so the padded clause matrix is one scatter of the literal
    buffer at ``(repeat(clause_id, lens), ranges(lens))`` and the occurrence
    lists are the same scatter after a stable sort of the literals by
    variable (stability keeps each variable's occurrences in (clause,
    position) order). No per-clause Python iteration anywhere.
    """
    arena = getattr(cnf, "arena", None)
    if arena is not None:
        lits = arena.lits_view()
        offs = arena.offs_view()
        lens = np.diff(offs)
    else:   # degenerate / mock CNFs without an arena
        rows = [list(c) for c in cnf.clauses]
        lens = np.asarray([len(r) for r in rows], dtype=np.int64)
        lits = np.asarray([l for r in rows for l in r], dtype=np.int32)
        offs = np.concatenate([[0], np.cumsum(lens)])
    C = cnf.n_clauses
    V = cnf.n_vars
    n = lits.size
    lmax = int(lens.max()) if C else 1
    cvars = np.zeros((C, lmax), np.int32)
    csign = np.zeros((C, lmax), bool)
    rows = np.repeat(np.arange(C), lens)
    cols = np.arange(n) - np.repeat(offs[:-1], lens)
    av = np.abs(lits)
    sg = lits > 0
    cvars[rows, cols] = av
    csign[rows, cols] = sg
    counts = np.bincount(av, minlength=V + 1)
    omax = int(counts.max()) if counts.size else 0
    ovars = np.full((V + 1, omax), -1, np.int32)
    osign = np.zeros((V + 1, omax), bool)
    if n:
        order = np.argsort(av, kind="stable")
        va = av[order]
        j = np.arange(n) - (np.cumsum(counts) - counts)[va]
        ovars[va, j] = rows[order]
        osign[va, j] = sg[order]
    return HostPack(cvars, csign, ovars, osign, V, C)


def _bucket(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def pack_cnf_window_np(cnfs: List[CNF],
                       packs: Optional[List[Optional[HostPack]]] = None,
                       ) -> HostPack:
    """Pack K CNFs into one stacked numpy pack padded to common shapes.

    Shorter clause lists are padded with the tautology clause (v1 ∨ ¬v1) —
    always exactly one true literal, so padded rows are never selected as
    unsat and never reach a solved flag. Padding rows are *excluded* from
    the occurrence lists, so break counts and incremental true-count
    updates are unaffected. Variable counts are padded to the max; extra
    vars occur in no clause and are never flipped.

    All dims are rounded up to coarse buckets (V to 128, C to 1024, L to 4,
    O to 8), byte for byte as the JAX package packs them, so a window has
    the same tensors in both packages.

    ``packs``, when given, supplies a precomputed :func:`pack_cnf_np` per
    CNF (``None`` entries are packed here) — the session-level cache path
    that makes warm window solves skip per-CNF packing entirely.
    """
    host: List[HostPack] = []
    for k, c in enumerate(cnfs):
        p = packs[k] if packs is not None else None
        host.append(p if p is not None else pack_cnf_np(c))
    K = len(host)
    V = _bucket(max(p.n_vars for p in host), 128)
    C = _bucket(max(p.n_clauses for p in host), 1024)
    L = max(p.cvars.shape[1] for p in host)
    O = max(p.ovars.shape[1] for p in host)
    L = _bucket(max(L, 2), 4)  # room for the (v1, ¬v1) padding tautology
    O = _bucket(O, 8)
    cvars = np.zeros((K, C, L), np.int32)
    csign = np.zeros((K, C, L), bool)
    ovars = np.full((K, V + 1, O), -1, np.int32)
    osign = np.zeros((K, V + 1, O), bool)
    for k, p in enumerate(host):
        c, l = p.cvars.shape
        cvars[k, :c, :l] = p.cvars
        csign[k, :c, :l] = p.csign
        # tautology padding for clause rows [c, C)
        cvars[k, c:, 0] = 1
        cvars[k, c:, 1] = 1
        csign[k, c:, 0] = True
        csign[k, c:, 1] = False
        v, o = p.ovars.shape
        ovars[k, :v, :o] = p.ovars
        osign[k, :v, :o] = p.osign
    return HostPack(cvars, csign, ovars, osign, V, C)


def pack_cnf_window(cnfs: List[CNF],
                    packs: Optional[List[Optional[HostPack]]] = None,
                    device=None) -> PackedCNF:
    """:func:`pack_cnf_window_np` moved to ``device`` (default: the
    package's device, see ``repro_torch.device``)."""
    from ...convert import window_from_numpy
    return window_from_numpy(pack_cnf_window_np(cnfs, packs),
                             device if device is not None
                             else resolve_device())


# -------------------------------------------------------- chunk scheduling

def _chunk_plan(steps: int, n_clauses: int) -> Tuple[int, int]:
    """(cap, first_chunk) of the progressive chunk schedule, shared by both
    walksat entry points: the per-chunk step count is bounded by the caller
    budget AND by formula size (stop/skip are only polled between chunks,
    and a cancelled racer must drain fast — fewer steps for big formulas),
    and the first chunk never exceeds the cap, so a small ``steps`` budget
    is honoured instead of being rounded up to 256."""
    cap = max(64, min(steps, 2048, 2_000_000 // max(n_clauses, 1)))
    return cap, min(256, cap)


def _next_chunk(prev: int, cap: int, remaining: int) -> int:
    """Progressive chunk schedule: double from the first chunk up to
    ``cap``, then shrink back down (halving only) to land on the step
    budget without overshooting by more than one minimal chunk."""
    c = min(prev * 2, cap)
    while c > 256 and c > remaining:
        c //= 2
    return c


# ------------------------------------------------------------ probSAT step

def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, float32, as ``jax.random.gumbel`` draws it:
    ``-log(-log(u))`` with ``u`` uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class OccTables(NamedTuple):
    """The occurrence lists recast for the break-count gather, made once
    per window: ``idx`` [K,V+1,O] int64 clause ids with padding sent to
    clause 0, ``sign`` [K,V+1,O] int8 literal signs with padding 2, a value
    no assignment bit equals, so padded slots never count as support."""
    idx: torch.Tensor
    sign: torch.Tensor


def occ_tables(ovars: torch.Tensor, osign: torch.Tensor) -> OccTables:
    valid = ovars >= 0
    return OccTables(torch.where(valid, ovars, 0).long(),
                     torch.where(valid, osign.to(torch.int8), 2).to(
                         torch.int8))


def _pick_flip(cvars: torch.Tensor, occ: OccTables, assign: torch.Tensor,
               tc: torch.Tensor, g_clause: torch.Tensor, g_var: torch.Tensor,
               cb: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One probSAT variable pick per chain, for a window of K CNFs.

    cvars [K,C,L] int32; ``occ`` from :func:`occ_tables`; assign [K,B,V+1]
    bool; tc [K,B,C] int32; g_clause [K,B,C] and g_var [K,B,L] float32
    Gumbel noise. Returns (v_flip [K,B] int32 — var 0, the dummy, for chains
    that are already solved — and new_val [K,B] bool).

    Given the same noise it picks what the JAX package's ``_pick_flip_one``
    picks with ``jax.random.categorical`` (``argmax(logits + gumbel)``):
    the same -1e30 mask, the same float32 ``-cb * log1p(brk)`` weights and
    argmax's first-index tie rule. The clause logits take only the values
    0 and -1e30, and -1e30 + g rounds to -1e30 for any finite noise g, so
    ``where(unsat, g, -1e30)`` equals ``logits + g`` bit for bit, and the
    clause pick depends only on the order of ``g_clause``: the walk passes
    the uniform draws themselves there (the same order as their Gumbel
    transform), which spares the two logarithms over [K,B,C].
    """
    K, B, _ = assign.shape
    L = cvars.shape[2]
    O = occ.idx.shape[2]
    unsat = tc == 0                                           # [K,B,C]
    # pick a random unsat clause per chain (clause 0, satisfied, if none)
    cidx = torch.argmax(torch.where(unsat, g_clause, -1e30), -1)  # [K,B]
    any_unsat = torch.gather(unsat, 2, cidx[..., None])[..., 0]
    vs = torch.gather(cvars, 1, cidx[..., None].expand(K, B, L))  # [K,B,L]
    vsl = vs.long()
    # break count per candidate var: clauses where v is the sole support
    kk = torch.arange(K, device=assign.device)[:, None, None]
    occ_i = occ.idx[kk, vsl]                                  # [K,B,L,O]
    occ_s = occ.sign[kk, vsl]
    tc_at = torch.gather(tc, 2, occ_i.reshape(K, B, L * O)).reshape(
        K, B, L, O)
    a_at = torch.gather(assign, 2, vsl).to(torch.int8)        # [K,B,L]
    supports = occ_s == a_at[..., None]       # var currently satisfies c'
    brk = (supports & (tc_at == 1)).sum(-1)                   # [K,B,L]
    # probSAT polynomial heuristic: p ∝ (1 + brk)^-cb
    w = torch.where(vs > 0, -cb * torch.log1p(brk.float()), -1e30)
    pick = torch.argmax(g_var + w, -1)                        # [K,B]
    v_flip = torch.gather(vs, 2, pick[..., None])[..., 0]
    v_flip = torch.where(any_unsat, v_flip, 0)  # flip dummy var 0 if solved
    new_val = ~torch.gather(assign, 2, v_flip.long()[..., None])[..., 0]
    return v_flip, new_val


def _window_chunk(packed: PackedCNF, occ: OccTables, assign: torch.Tensor,
                  tc: torch.Tensor, n_steps: int, cb: float,
                  gen: torch.Generator, stop=None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk all K CNFs of the window for ``n_steps`` probSAT steps. Both
    engines run exactly this, so they consume the generator identically.
    ``stop()``, a host-side callable, is asked before every step; a stopped
    walk returns early (only a cancelled walk stops, so its result is not
    compared with anything).

    assign [K,B,V+1] bool; tc [K,B,C] int32. On a CUDA device ``assign``
    and ``tc`` are updated in place (the ``flip_update`` kernel)."""
    K, B, _ = assign.shape
    C, L = packed.cvars.shape[1], packed.cvars.shape[2]
    dev = assign.device
    kk = torch.arange(K, device=dev)[:, None]
    for _ in range(n_steps):
        if stop is not None and stop():
            break
        g_clause = torch.rand((K, B, C), generator=gen, device=dev)
        g_var = _gumbel(gen, (K, B, L), dev)
        v_flip, new_val = _pick_flip(packed.cvars, occ, assign, tc,
                                     g_clause, g_var, cb)
        vfl = v_flip.long()
        assign, tc = flip_update(assign, tc, v_flip, packed.ovars[kk, vfl],
                                 packed.osign[kk, vfl], new_val)
    return assign, tc


def _init_assign(gen: torch.Generator, batch: int, n_vars_padded: int,
                 init: Optional[List[bool]], device) -> torch.Tensor:
    """Initial chain assignments [B, V+1]. Without ``init``: uniform
    random. With ``init`` (a warm start, e.g. the previous II's best
    near-miss under the shared variable numbering): chain 0 starts from it
    exactly and chain b flips a growing fraction (up to half,
    ``linspace(0, 0.5, B)``) of the variables, so the batch explores a
    widening neighbourhood of the hint while keeping full random restarts
    in the tail.

    The hint is truncated/padded defensively: a sweep window can *shrink*,
    so ``init`` may be longer or shorter than this window's variable
    space — extra entries are dropped, missing ones default to False."""
    shape = (batch, n_vars_padded + 1)
    if init is None:
        return torch.rand(shape, generator=gen, device=device) < 0.5
    base = np.zeros(n_vars_padded + 1, bool)
    hint = np.asarray(init, bool)[:n_vars_padded]
    base[1:len(hint) + 1] = hint
    ps = torch.linspace(0.0, 0.5, batch, device=device)[:, None]
    flips = torch.rand(shape, generator=gen, device=device) < ps
    return torch.from_numpy(base).to(device)[None, :] ^ flips


def _maybe_shard_window(assign0: torch.Tensor) -> torch.Tensor:
    """Single-GPU pass-through. The JAX package shards the restart batch
    over a device mesh here; the port walks on one card, and sharding the
    chains across GPUs is later work."""
    return assign0


def _start(cnfs, live, packed, inits, seed, batch):
    """Generator and initial assignments [K,B,V+1] of one walk — the first
    draws of the stream, made the same way by both engines."""
    dev = packed.cvars.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    assign0 = torch.stack([
        _init_assign(gen, batch, packed.n_vars,
                     inits[live[j]] if inits is not None else None, dev)
        for j in range(len(live))])
    return gen, _maybe_shard_window(assign0)


def _model(row: torch.Tensor, cnf: CNF) -> List[bool]:
    return [bool(b) for b in row.cpu().numpy()[1:cnf.n_vars + 1]]


# ---------------------------------------------------------- device engine

class _WalkState(NamedTuple):
    """The device engine's walk, all on the device: assign [K,B,V+1], tc
    [K,B,C], solved [K], solved_assign [K,V+1] — the assignment of the
    first chain observed solved, snapshotted in the chunk it solved so a
    late poll returns the model the per-chunk host engine returns — skip
    [K], best_unsat [K] and best_assign [K,V+1] — best-over-all-chunks
    near-miss state, tracked only while a candidate is still pending."""
    assign: torch.Tensor
    tc: torch.Tensor
    solved: torch.Tensor
    solved_assign: torch.Tensor
    skip: torch.Tensor
    best_unsat: torch.Tensor
    best_assign: torch.Tensor


def _initial_state(packed: PackedCNF, assign0: torch.Tensor) -> _WalkState:
    """The walk before its first chunk: true counts of the initial
    assignments, nothing solved, skipped or banked yet."""
    K = assign0.shape[0]
    dev = assign0.device
    v1 = packed.n_vars + 1
    return _WalkState(
        assign0, true_counts_window(packed.cvars, packed.csign, assign0),
        torch.zeros(K, dtype=torch.bool, device=dev),
        torch.zeros((K, v1), dtype=torch.bool, device=dev),
        torch.zeros(K, dtype=torch.bool, device=dev),
        torch.full((K,), int(_INT32_MAX), dtype=torch.int64, device=dev),
        torch.zeros((K, v1), dtype=torch.bool, device=dev))


def _device_segment(packed: PackedCNF, occ: OccTables, st: _WalkState,
                    chunks: List[int], cb: float, gen: torch.Generator,
                    stop=None) -> _WalkState:
    """Walk the planned ``chunks`` (host-side lengths) and fold each
    chunk's outcome into the per-candidate state. Only kernels are
    enqueued: nothing here reads the device, so the host runs ahead of the
    card for the whole segment. Chunks after every candidate is solved or
    skipped change nothing the caller reads (solved flags latch, near-miss
    updates are masked), so a segment need not stop early."""
    assign, tc, solved, solved_assign, skip, best_unsat, best_assign = st
    K = assign.shape[0]
    ks = torch.arange(K, device=assign.device)
    for chunk in chunks:
        assign, tc = _window_chunk(packed, occ, assign, tc, chunk, cb, gen,
                                   stop)
        unsat = tc == 0
        chain_ok = ~unsat.any(-1)                          # [K,B]
        fresh = chain_ok.any(-1) & ~solved
        row = torch.argmax(chain_ok.to(torch.uint8), -1)   # first solved
        solved_assign = torch.where(fresh[:, None], assign[ks, row],
                                    solved_assign)
        solved = solved | fresh
        # near-miss: best assignment over all chunks, per still-pending
        # candidate (solved/skipped candidates stop accumulating)
        n_unsat = unsat.sum(-1)                            # [K,B]
        brow = torch.argmin(n_unsat, -1)
        bu = torch.gather(n_unsat, 1, brow[:, None])[:, 0]
        improve = ~solved & ~skip & (bu < best_unsat)
        best_unsat = torch.where(improve, bu, best_unsat)
        best_assign = torch.where(improve[:, None], assign[ks, brow],
                                  best_assign)
    return _WalkState(assign, tc, solved, solved_assign, skip, best_unsat,
                      best_assign)


def _solve_window_device(cnfs, live, packed, results, *, seed, steps, batch,
                         cb, stop, should_skip, on_sat, inits, near_miss,
                         on_near_miss):
    from . import SAT
    K = len(live)
    gen, assign0 = _start(cnfs, live, packed, inits, seed, batch)
    occ = occ_tables(packed.ovars, packed.osign)
    dev = assign0.device
    cap, chunk = _chunk_plan(steps, packed.n_clauses)
    st = _initial_state(packed, assign0)
    skip_host = np.zeros(K, bool)
    pending = set(range(K))
    nm_emitted = np.full(K, _INT32_MAX, np.int64)   # last streamed quality
    done = 0
    while done < steps and pending:
        if stop is not None and stop():
            break
        if should_skip is not None:
            newly = [j for j in sorted(pending) if should_skip(live[j])]
            if newly:
                for j in newly:
                    pending.discard(j)
                    skip_host[j] = True
                if not pending:
                    break
                st = st._replace(skip=torch.tensor(skip_host, device=dev))
        plan = []
        while len(plan) < _POLL_CHUNKS and done < steps:
            plan.append(chunk)
            done += chunk
            chunk = _next_chunk(chunk, cap, steps - done)
        st = _device_segment(packed, occ, st, plan, cb, gen, stop)
        # the host waits only on the small status tensor; the walk state
        # (assignments, true counts, near-miss buffers) stays on the device
        solved_np = st.solved.cpu().numpy()
        for j in sorted(pending):
            if not solved_np[j]:
                continue
            i = live[j]
            model = _model(st.solved_assign[j], cnfs[i])
            _validate_model(cnfs[i], model, f"device engine, candidate {i}")
            results[i] = (SAT, model)
            pending.discard(j)
            if on_sat is not None:
                on_sat(i, model)
        if on_near_miss is not None and pending:
            # stream near-miss improvements at each poll — the caller's
            # feedback channel (e.g. CDCL phase hints) sees them while
            # the walk is still running, not only at budget exhaustion
            bu = st.best_unsat.cpu().numpy()
            for j in sorted(pending):
                if bu[j] < nm_emitted[j]:
                    nm_emitted[j] = bu[j]
                    i = live[j]
                    on_near_miss(i, int(bu[j]),
                                 _model(st.best_assign[j], cnfs[i]))
    if near_miss is not None and pending:
        bu = st.best_unsat.cpu().numpy()
        ba = st.best_assign.cpu().numpy()
        for j in sorted(pending):
            if bu[j] >= _INT32_MAX:
                continue
            i = live[j]
            near_miss[i] = (int(bu[j]),
                            [bool(b) for b in ba[j][1:cnfs[i].n_vars + 1]])
    return results


# ------------------------------------------------------------ host engine

def _solve_window_host(cnfs, live, packed, results, *, seed, steps, batch,
                       cb, stop, should_skip, on_sat, inits, near_miss,
                       on_near_miss):
    """The per-chunk host loop (the reference engine): identical chunk
    schedule, noise stream, and near-miss bookkeeping as the device engine,
    with true counts recomputed and flags read after every chunk."""
    from . import SAT
    K = len(live)
    gen, assign = _start(cnfs, live, packed, inits, seed, batch)
    occ = occ_tables(packed.ovars, packed.osign)
    cap, chunk = _chunk_plan(steps, packed.n_clauses)
    done = 0
    pending = set(range(K))
    # best-over-all-chunks near-miss per candidate (not final-chunk-only)
    nm_best = {j: (_INT32_MAX, None) for j in range(K)}
    while done < steps and pending:
        if stop is not None and stop():
            break
        tc = true_counts_window(packed.cvars, packed.csign, assign)
        assign, tc = _window_chunk(packed, occ, assign, tc, chunk, cb, gen,
                                   stop)
        solved_np = (~(tc == 0).any(-1)).cpu().numpy()        # [K, B]
        for j in sorted(pending):
            i = live[j]
            if should_skip is not None and should_skip(i):
                pending.discard(j)
                continue
            if not solved_np[j].any():
                continue
            row = int(np.argmax(solved_np[j]))
            model = _model(assign[j, row], cnfs[i])
            _validate_model(cnfs[i], model, f"host engine, candidate {i}")
            results[i] = (SAT, model)
            pending.discard(j)
            if on_sat is not None:
                on_sat(i, model)
        if (near_miss is not None or on_near_miss is not None) and pending:
            n_unsat = (tc == 0).sum(-1).cpu().numpy()         # [K, B]
            assign_np = None
            for j in sorted(pending):
                row = int(np.argmin(n_unsat[j]))
                if int(n_unsat[j, row]) < nm_best[j][0]:
                    if assign_np is None:
                        assign_np = assign.cpu().numpy()
                    nm_best[j] = (int(n_unsat[j, row]),
                                  assign_np[j, row].copy())
                    if on_near_miss is not None:
                        i = live[j]
                        on_near_miss(
                            i, nm_best[j][0],
                            [bool(b) for b in
                             nm_best[j][1][1:cnfs[i].n_vars + 1]])
        done += chunk
        chunk = _next_chunk(chunk, cap, steps - done)
    if near_miss is not None:
        for j in sorted(pending):
            nu, arr = nm_best[j]
            if arr is None:
                continue
            i = live[j]
            near_miss[i] = (nu, [bool(b) for b in arr[1:cnfs[i].n_vars + 1]])
    return results


# -------------------------------------------------------------- front door

def solve_walksat_window(cnfs: List[CNF], *, seed: int = 0,
                         steps: int = 8192, batch: int = 24, cb: float = 2.3,
                         stop=None, should_skip=None, on_sat=None,
                         inits: Optional[List[Optional[List[bool]]]] = None,
                         near_miss: Optional[dict] = None,
                         on_near_miss=None,
                         engine: Optional[str] = None,
                         packed: Optional[PackedCNF] = None,
                         packs: Optional[List[Optional[HostPack]]] = None,
                         ) -> List[Tuple[str, Optional[List[bool]]]]:
    """Batched probSAT across a window of candidate-II CNFs.

    All K formulas walk together on the package's device (see
    ``repro_torch.device``; ``cuda`` unless the caller chose the CPU).
    Incomplete: per-CNF result is SAT or UNKNOWN, never UNSAT
    (structurally-empty-clause CNFs excepted).

    ``stop()`` aborts the whole window; ``should_skip(i)`` marks candidate i
    as no longer interesting (e.g. its complete solver already finished);
    ``on_sat(i, model)`` fires as soon as candidate i is certified, so the
    caller can early-cancel other work while remaining candidates keep
    walking.

    ``inits[i]`` warm-starts candidate i's chains from a prior assignment
    (see ``_init_assign``); ``near_miss``, when given a dict, receives
    ``{i: (n_unsat, assignment)}`` — the best assignment each *still
    pending* candidate reached over the whole walk (solved and skipped
    candidates are excluded). ``on_near_miss(i, n_unsat, assignment)``
    streams improvements *during* the walk (per host poll on the device
    engine, per chunk on the host engine).

    ``engine`` selects the chunk driver: ``"device"`` (default) keeps the
    chunk loop on the device with the host polling a small status tensor
    every few chunks; ``"host"`` is the per-chunk reference loop. Both are
    bit-compatible for a fixed seed; ``REPRO_WALKSAT_ENGINE`` overrides the
    default.

    ``packed`` supplies a ready stacked window pack (used only when every
    candidate turns out live and it lies on the walk's device); ``packs``
    supplies per-CNF host packs for the stacker. Both come from the
    ``SolverSession`` pack cache.
    """
    from . import SAT, UNKNOWN, UNSAT
    K = len(cnfs)
    results: List[Tuple[str, Optional[List[bool]]]] = [(UNKNOWN, None)] * K
    live = []
    for i, cnf in enumerate(cnfs):
        arena = getattr(cnf, "arena", None)
        if arena is not None:
            has_empty = bool((np.diff(arena.offs_view()) == 0).any())
        else:
            has_empty = any(len(c) == 0 for c in cnf.clauses)
        if getattr(cnf, "trivially_unsat", False) or has_empty:
            results[i] = (UNSAT, None)
        elif cnf.n_clauses == 0 or cnf.n_vars == 0:
            results[i] = (SAT, [False] * cnf.n_vars)
            if on_sat is not None:
                on_sat(i, results[i][1])
        else:
            live.append(i)
    if not live:
        return results
    if engine is None:
        engine = os.environ.get("REPRO_WALKSAT_ENGINE", "device")
    if engine not in ("device", "host"):
        raise ValueError(f"unknown walksat engine {engine!r}")
    dev = resolve_device()
    if packed is None or len(live) != K or packed.cvars.device != dev:
        packed = pack_cnf_window(
            [cnfs[i] for i in live],
            [packs[i] for i in live] if packs is not None else None, dev)
    run = _solve_window_device if engine == "device" else _solve_window_host
    return run(cnfs, live, packed, results, seed=seed, steps=steps,
               batch=batch, cb=cb, stop=stop, should_skip=should_skip,
               on_sat=on_sat, inits=inits, near_miss=near_miss,
               on_near_miss=on_near_miss)


def solve_walksat(cnf: CNF, *, seed: int = 0, steps: int = 20000,
                  batch: int = 64, cb: float = 2.3, stop=None,
                  init: Optional[List[bool]] = None,
                  near_miss: Optional[dict] = None,
                  engine: Optional[str] = None,
                  pack: Optional[HostPack] = None,
                  ) -> Tuple[str, Optional[List[bool]]]:
    """Single-CNF probSAT: the K=1 window. Shares the window engines, the
    bucketed padded pack and the budget/formula-size chunk schedule, so a
    caller-provided ``steps`` is honoured exactly the same way in both
    entry points. ``near_miss`` receives ``{0: (n_unsat, assignment)}``
    when the instance stays unsolved; ``pack`` supplies a cached
    :func:`pack_cnf_np` of the CNF."""
    res = solve_walksat_window(
        [cnf], seed=seed, steps=steps, batch=batch, cb=cb, stop=stop,
        inits=[init] if init is not None else None,
        near_miss=near_miss, engine=engine,
        packs=[pack] if pack is not None else None)
    return res[0]
