"""Public clause-evaluation entry points: checks + dispatch + launch count.

A tensor on the CPU takes the plain torch version (``ref.py``); a CUDA
tensor launches the hand-written kernel or raises. There is no fallback
from one to the other.

``clen``, when given, holds each clause row's length: one past its last
non-zero slot, as the packer derives it. The kernel then reads slots
``[0, min(clen, L))`` of a row and nothing after them (it still skips a 0
inside that range), so the counts are the same as without ``clen`` for
any table whose zeros all lie at or past ``clen``. Its values are not
checked: the kernel clamps them, and a check would cost a host sync.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._cuda import KernelError
from .kernel import clause_eval_window_cuda, eval_smem
from .ref import true_counts_ref, true_counts_window_ref

# the kernel's two ways of reading a row: its slots [0, clen), or all L
ROUTES = ("clen", "full_rows")

# An H100 block may hold 227 KB of shared memory, static and dynamic
# together. The eval kernel's static part is its long-row queue,
# queue[256] and queued[2] ints (csrc/clause_eval.cu): 1032 bytes
# declared, 1040 held by the compiled kernel (cudaFuncGetAttributes on an
# H100, sm_90a; the first launch checks it). The dynamic part holds one
# 32-bit plane word per variable for each 32 chains of its tile, so at
# least V+1 words must fit in what the static part leaves.
SMEM_OPTIN = 232448
EVAL_STATIC_SMEM = 1040
SMEM_BUDGET = SMEM_OPTIN - EVAL_STATIC_SMEM
MAX_VARS_PLUS_ONE = SMEM_BUDGET // 4
MAX_TILE_WORDS = 8   # 256 chains a block


def eval_tile(B: int, V1: int) -> int:
    """The eval kernel's chain tile for B chains over V1 = V+1 variables, in
    32-chain words: as many as the chains need, at most 8, and no more than
    fit ``SMEM_BUDGET``. Raises ``ValueError`` when not even one word per
    variable fits."""
    if V1 > MAX_VARS_PLUS_ONE:
        raise ValueError(f"clause_eval: V+1 = {V1} exceeds the kernel's "
                         f"{MAX_VARS_PLUS_ONE}-word shared plane")
    return min(-(-B // 32), MAX_TILE_WORDS, SMEM_BUDGET // (4 * max(V1, 1)))


def _check(cvars, csign, assign, clen, ndim: int) -> None:
    if cvars.dim() != ndim or csign.dim() != ndim or assign.dim() != ndim:
        raise ValueError(f"clause_eval: expected {ndim}-d cvars/csign/assign,"
                         f" got {tuple(cvars.shape)}, {tuple(csign.shape)}, "
                         f"{tuple(assign.shape)}")
    if cvars.shape != csign.shape or cvars.shape[:-2] != assign.shape[:-2]:
        raise ValueError(f"clause_eval: cvars {tuple(cvars.shape)}, csign "
                         f"{tuple(csign.shape)} and assign "
                         f"{tuple(assign.shape)} do not match")
    if cvars.dtype != torch.int32 or csign.dtype != torch.bool \
            or assign.dtype != torch.bool:
        raise TypeError(f"clause_eval: need int32 cvars, bool csign, bool "
                        f"assign; got {cvars.dtype}, {csign.dtype}, "
                        f"{assign.dtype}")
    if not (cvars.device == csign.device == assign.device):
        raise ValueError("clause_eval: tensors on different devices")
    if clen is None:
        return
    if clen.shape != cvars.shape[:-1]:
        raise ValueError(f"clause_eval: clen {tuple(clen.shape)} does not "
                         f"match the clause rows {tuple(cvars.shape[:-1])}")
    if clen.dtype != torch.int32:
        raise TypeError(f"clause_eval: need int32 clen, got {clen.dtype}")
    if clen.device != cvars.device:
        raise ValueError(f"clause_eval: clen on {clen.device}, the tables "
                         f"on {cvars.device}")


def _launch(cvars, csign, assign, clen) -> torch.Tensor:
    if assign.device.type != "cuda":
        raise ValueError(f"clause_eval: no kernel for device {assign.device}")
    if not (cvars.is_contiguous() and csign.is_contiguous()
            and assign.is_contiguous()
            and (clen is None or clen.is_contiguous())):
        raise ValueError("clause_eval: the kernel needs contiguous tensors")
    tile = eval_tile(assign.shape[1], assign.shape[2])
    static, _ = eval_smem()
    if static != EVAL_STATIC_SMEM:
        raise KernelError(f"clause_eval: the compiled eval kernel holds "
                          f"{static} static shared bytes, the tile choice "
                          f"counts {EVAL_STATIC_SMEM}")
    return clause_eval_window_cuda(cvars, csign, assign, clen, tile)


def true_counts_window(cvars: torch.Tensor, csign: torch.Tensor,
                       assign: torch.Tensor,
                       clen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window true counts: cvars [K,C,L] int32; csign [K,C,L] bool; assign
    [K,B,V+1] bool; clen [K,C] int32 or None -> [K,B,C] int32."""
    _check(cvars, csign, assign, clen, 3)
    if assign.device.type == "cpu":
        return true_counts_window_ref(cvars, csign, assign, clen)
    out = _launch(cvars, csign, assign, clen)
    true_counts_window.launches += 1
    true_counts_window.route_launches[_route(clen)] += 1
    K = cvars.shape[0]
    true_counts_window.k_launches[K] = \
        true_counts_window.k_launches.get(K, 0) + 1
    return out


def true_counts(cvars: torch.Tensor, csign: torch.Tensor,
                assign: torch.Tensor,
                clen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One CNF (the K = 1 launch of the window kernel): cvars [C,L] int32;
    csign [C,L] bool; assign [B,V+1] bool; clen [C] int32 or None ->
    [B,C] int32."""
    _check(cvars, csign, assign, clen, 2)
    if assign.device.type == "cpu":
        return true_counts_ref(cvars, csign, assign, clen)
    out = _launch(cvars[None], csign[None], assign[None],
                  None if clen is None else clen[None])[0]
    true_counts.launches += 1
    true_counts.route_launches[_route(clen)] += 1
    return out


def _route(clen) -> str:
    return ROUTES[clen is None]


def reset_counts() -> None:
    """Set every count of the two wrappers to 0."""
    for f in (true_counts_window, true_counts):
        f.launches = 0
        f.route_launches = dict.fromkeys(ROUTES, 0)
    true_counts_window.k_launches = {}


# kernel launches made through each wrapper, also by route, and the window
# wrapper's by the window's K (the CPU route counts none)
reset_counts()

__all__ = ["true_counts", "true_counts_window", "true_counts_ref",
           "true_counts_window_ref", "MAX_VARS_PLUS_ONE", "ROUTES",
           "eval_tile", "reset_counts"]
