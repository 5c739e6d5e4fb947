"""Plain torch versions of the flip update and of the walk chunk.

``flip_update_ref``: given one probSAT flip per chain (variable id, its new
value, and the pre-gathered occurrence row of that variable), apply the
flip to the assignment and bump the true count of every clause the
variable occurs in: +1 where the new value satisfies the literal, -1 where
it un-satisfies it. Integer-exact, so the CUDA kernel must agree with it
bit for bit.

``walk_chunk_ref``: ``n_steps`` whole probSAT steps for every chain of a
window, the contract of the ``walk_chunk`` kernel (``csrc/flip_update.cu``),
which must agree with it bit for bit. Each step draws its noise from
Philox4x32-10 (:func:`philox4x32_10`) at counters that name the step, the
chain and the clause or literal slot, so the noise does not depend on how
the walk is cut into chunks, and a kernel can draw it only where it needs
it. The step is :func:`pick_flip_ref` (held to the JAX package's
``_pick_flip_one`` given the same noise) followed by
:func:`flip_update_ref`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_10)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
# counter word 3: which draw of a step a word belongs to
CLAUSE_STREAM, VAR_STREAM = 0, 1


def flip_update_ref(assign: torch.Tensor, tc: torch.Tensor,
                    v_flip: torch.Tensor, occ_c: torch.Tensor,
                    occ_s: torch.Tensor, new_val: torch.Tensor,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """assign [K,B,V+1] bool; tc [K,B,C] int32; v_flip [K,B] int32
    (0 = the dummy variable of a solved chain); occ_c [K,B,O] int32 clause
    ids (-1 = padding); occ_s [K,B,O] bool; new_val [K,B] bool. Returns new
    (assign', tc'); the inputs are left as they were."""
    K, B = v_flip.shape
    kk = torch.arange(K, device=assign.device)[:, None]
    bb = torch.arange(B, device=assign.device)[None, :]
    assign = assign.clone()
    assign[kk, bb, v_flip.long()] = new_val
    valid = occ_c >= 0
    delta = torch.where(occ_s == new_val[..., None], 1, -1).to(torch.int32)
    delta = delta * valid
    tc = tc.clone().scatter_add_(2, torch.where(valid, occ_c, 0).long(),
                                 delta)
    return assign, tc


# ------------------------------------------------------------ probSAT step

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


def pick_flip_ref(cvars: torch.Tensor, occ: OccTables, assign: torch.Tensor,
                  tc: torch.Tensor, g_clause: torch.Tensor,
                  g_var: torch.Tensor, cb: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One probSAT variable pick per chain, for a window of K CNFs.

    cvars [K,C,L] int32; ``occ`` from :func:`occ_tables`; assign [K,B,V+1]
    bool; tc [K,B,C] int32; g_clause [K,B,C] and g_var [K,B,L] float32
    noise. Returns (v_flip [K,B] int32 — var 0, the dummy, for chains
    that are already solved — and new_val [K,B] bool).

    Given the same noise it picks what the JAX package's ``_pick_flip_one``
    picks with ``jax.random.categorical`` (``argmax(logits + gumbel)``):
    the same -1e30 mask, the same float32 ``-cb * log1p(brk)`` weights and
    argmax's first-index tie rule. The clause logits take only the values
    0 and -1e30, and -1e30 + g rounds to -1e30 for any noise g below 2^75,
    so ``where(unsat, g, -1e30)`` equals ``logits + g`` bit for bit, and
    the clause pick depends only on the order of ``g_clause``: the walk
    passes uniform integers there (the same order as their Gumbel
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


# ------------------------------------------------------------------ Philox

def philox4x32_10(ctr, key: Tuple[int, int]):
    """Philox4x32-10 on int64 tensors that hold uint32 values.

    ``ctr`` is four broadcastable int64 tensors (the counter words),
    ``key`` two Python ints below 2^32. Returns the four output words as
    int64 tensors in [0, 2^32). The product of two uint32 wraps mod 2^64
    in int64, and ``(p >> 32) & 0xFFFFFFFF`` is still its exact high word
    (the arithmetic shift only changes the bits that the mask drops), so
    this runs unchanged on CPU and CUDA tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def _words(key, i, chain, step: int, stream: int) -> torch.Tensor:
    """``word(step, chain, i, stream)``: word ``i & 3`` of Philox4x32-10
    at counter ``(i >> 2, chain, step, stream)``; ``i`` and ``chain`` are
    broadcastable int64 tensors."""
    step_t = torch.full((), step & _MASK, dtype=torch.int64, device=i.device)
    out = torch.stack(torch.broadcast_tensors(*philox4x32_10(
        (i >> 2, chain, step_t, torch.full_like(step_t, stream)), key)), -1)
    return torch.gather(out, -1, (i & 3).expand(out.shape[:-1])[..., None]
                        )[..., 0]


def walk_noise(key: Tuple[int, int], step: int, tc: torch.Tensor, L: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The noise of walk step ``step`` for ``pick_flip_ref``: g_clause
    [K,B,C], the 24-bit uniform ``word(step, r, c, 0) >> 8`` as float32
    (exact) at every unsat clause (0 elsewhere: the pick masks it), and
    g_var [K,B,L], the Gumbel transform ``-log(-log(u))`` of
    ``u = max((word(step, r, l, 1) >> 8) * 2^-24, FLT_MIN)``; chain
    ``r = k * B + b``. Only unsat clauses are drawn, as the kernel does;
    the generator is counter-based, so that changes no value."""
    K, B, C = tc.shape
    dev = tc.device
    kk, bb, cc = (tc == 0).nonzero(as_tuple=True)
    g_clause = torch.zeros((K, B, C), dtype=torch.float32, device=dev)
    g_clause[kk, bb, cc] = (_words(key, cc, kk * B + bb, step, CLAUSE_STREAM)
                            >> 8).float()
    chain = torch.arange(K * B, dtype=torch.int64, device=dev).view(K, B, 1)
    slot = torch.arange(L, dtype=torch.int64, device=dev)
    u = (_words(key, slot, chain, step, VAR_STREAM) >> 8).float() * 2.0 ** -24
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return g_clause, -torch.log(-torch.log(u))


def walk_chunk_ref(cvars: torch.Tensor, ovars: torch.Tensor,
                   osign: torch.Tensor, assign: torch.Tensor,
                   tc: torch.Tensor, key: Tuple[int, int], step0: int,
                   n_steps: int, cb: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps ``step0 .. step0 + n_steps - 1`` of the walk for every chain.

    cvars [K,C,L] int32; ovars [K,V+1,O] int32 (-1 = padding); osign
    [K,V+1,O] bool; assign [K,B,V+1] bool; tc [K,B,C] int32; ``key`` two
    uint32 as Python ints. Each step draws :func:`walk_noise` at its
    global index, picks with :func:`pick_flip_ref` and flips with
    :func:`flip_update_ref` (a solved chain flips the dummy variable 0).
    Returns new (assign', tc'); the inputs are left as they were."""
    K = assign.shape[0]
    L = cvars.shape[2]
    occ = occ_tables(ovars, osign)
    kk = torch.arange(K, device=assign.device)[:, None]
    for t in range(n_steps):
        g_clause, g_var = walk_noise(key, step0 + t, tc, L)
        v_flip, new_val = pick_flip_ref(cvars, occ, assign, tc, g_clause,
                                        g_var, cb)
        vfl = v_flip.long()
        assign, tc = flip_update_ref(assign, tc, v_flip, ovars[kk, vfl],
                                     osign[kk, vfl], new_val)
    return assign, tc
