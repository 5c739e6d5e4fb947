"""Public entry points of the walk's update kernels: checks + dispatch +
launch counts.

``flip_update`` applies one flip per chain; ``walk_chunk`` runs whole
probSAT steps (pick, flip, count update) for a chunk in one launch. A
tensor on the CPU takes the plain torch version (``ref.py``), which
returns new tensors; a CUDA tensor launches the hand-written kernel, which
updates ``assign`` and ``tc`` in place and returns them, or raises. Callers
use the returned pair either way and do not reuse the inputs.
"""
from __future__ import annotations

import torch

from .kernel import flip_update_cuda, walk_chunk_cuda
from .ref import flip_update_ref, walk_chunk_ref

_DTYPES = {"assign": torch.bool, "tc": torch.int32, "v_flip": torch.int32,
           "occ_c": torch.int32, "occ_s": torch.bool, "new_val": torch.bool}


def flip_update(assign: torch.Tensor, tc: torch.Tensor, v_flip: torch.Tensor,
                occ_c: torch.Tensor, occ_s: torch.Tensor,
                new_val: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flip + incremental true-count update over an II window.

    assign [K,B,V+1] bool; tc [K,B,C] int32; v_flip [K,B] int32 (0 = the
    dummy no-op var); occ_c [K,B,O] int32 clause ids of the flipped var
    (-1 = padding); occ_s [K,B,O] bool literal signs; new_val [K,B] bool.
    Returns (assign', tc').
    """
    args = {"assign": assign, "tc": tc, "v_flip": v_flip, "occ_c": occ_c,
            "occ_s": occ_s, "new_val": new_val}
    if assign.dim() != 3 or tc.dim() != 3 or v_flip.dim() != 2 \
            or new_val.dim() != 2 or occ_c.dim() != 3:
        raise ValueError("flip_update: expected assign/tc/occ_c 3-d and "
                         "v_flip/new_val 2-d")
    k, b = assign.shape[:2]
    leads = {"tc": tc.shape[:2], "v_flip": v_flip.shape[:2],
             "occ_c": occ_c.shape[:2], "occ_s": occ_s.shape[:2],
             "new_val": new_val.shape[:2]}
    bad = {n: tuple(s) for n, s in leads.items() if tuple(s) != (k, b)}
    if bad or occ_c.shape != occ_s.shape:
        raise ValueError(f"flip_update: inputs must share leading [K,B]="
                         f"[{k},{b}] and occ_c/occ_s must match: "
                         f"mismatched {bad or {'occ_s': tuple(occ_s.shape)}}")
    wrong = {n: t.dtype for n, t in args.items() if t.dtype != _DTYPES[n]}
    if wrong:
        raise TypeError(f"flip_update: wrong dtypes {wrong}; expected "
                        f"{_DTYPES}")
    if len({t.device for t in args.values()}) != 1:
        raise ValueError("flip_update: tensors on different devices")
    if assign.device.type == "cpu":
        return flip_update_ref(assign, tc, v_flip, occ_c, occ_s, new_val)
    if assign.device.type != "cuda":
        raise ValueError(f"flip_update: no kernel for device {assign.device}")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("flip_update: the kernel needs contiguous tensors")
    flip_update_cuda(assign, tc, v_flip, occ_c, occ_s, new_val)
    flip_update.launches += 1
    return assign, tc


# a block may hold 227 KB of shared memory; walk_chunk's static part (the
# reduction slots) takes well under the 1 KB kept back here
MAX_SHARED_BYTES = 232448 - 1024
ROUTES = ("shared", "global")
_WALK_DTYPES = {"cvars": torch.int32, "ovars": torch.int32,
                "osign": torch.bool, "assign": torch.bool, "tc": torch.int32}


def walk_route(C: int, L: int, V1: int) -> str:
    """The kernel route for a window's shape, which alone decides it:
    ``"shared"`` when a chain's counts (4*C bytes), its assignment (V1)
    and the pick's three slot arrays (12*L) fit a block's shared memory
    (the 4x4 window: 47 KB), else ``"global"``, which updates the counts
    in device memory (the 8x8 window: C = 160768). Raises ``ValueError``
    when not even the 12*L bytes of the global route fit."""
    if 4 * C + 12 * L + V1 <= MAX_SHARED_BYTES:
        return "shared"
    if 12 * L <= MAX_SHARED_BYTES:
        return "global"
    raise ValueError(f"walk_chunk: clauses of {L} literal slots need "
                     f"{12 * L} bytes of shared memory, over "
                     f"{MAX_SHARED_BYTES}")


def walk_chunk(cvars: torch.Tensor, ovars: torch.Tensor, osign: torch.Tensor,
               assign: torch.Tensor, tc: torch.Tensor, key: tuple[int, int],
               step0: int, n_steps: int, cb: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk steps ``step0 .. step0 + n_steps - 1`` of every chain of a
    window (the contract of :func:`walk_chunk_ref`).

    cvars [K,C,L] int32; ovars [K,V+1,O] int32 (-1 = padding); osign
    [K,V+1,O] bool; assign [K,B,V+1] bool; tc [K,B,C] int32; ``key`` two
    uint32 as Python ints; ``step0`` the walk's global step index at the
    start of the chunk. Returns (assign', tc'). A CUDA launch counts one
    launch, one on its route and ``n_steps`` steps.
    """
    args = {"cvars": cvars, "ovars": ovars, "osign": osign,
            "assign": assign, "tc": tc}
    if any(t.dim() != 3 for t in args.values()):
        raise ValueError(f"walk_chunk: expected 3-d tensors, got "
                         f"{ {n: tuple(t.shape) for n, t in args.items()} }")
    K, C, _ = cvars.shape
    B = assign.shape[1]
    if ovars.shape != osign.shape or ovars.shape[0] != K \
            or assign.shape != (K, B, ovars.shape[1]) \
            or tc.shape != (K, B, C):
        raise ValueError(f"walk_chunk: cvars {tuple(cvars.shape)}, ovars "
                         f"{tuple(ovars.shape)}, osign {tuple(osign.shape)}, "
                         f"assign {tuple(assign.shape)} and tc "
                         f"{tuple(tc.shape)} must be [K,C,L], [K,V+1,O] "
                         f"(twice), [K,B,V+1] and [K,B,C]")
    wrong = {n: t.dtype for n, t in args.items() if t.dtype != _WALK_DTYPES[n]}
    if wrong:
        raise TypeError(f"walk_chunk: wrong dtypes {wrong}; expected "
                        f"{_WALK_DTYPES}")
    if len(key) != 2 or not all(0 <= int(k) <= 0xFFFFFFFF for k in key) \
            or step0 < 0 or n_steps < 0:
        raise ValueError(f"walk_chunk: key must be two uint32 and step0, "
                         f"n_steps >= 0; got {key}, {step0}, {n_steps}")
    if len({t.device for t in args.values()}) != 1:
        raise ValueError("walk_chunk: tensors on different devices")
    if assign.device.type == "cpu":
        return walk_chunk_ref(cvars, ovars, osign, assign, tc, key, step0,
                              n_steps, cb)
    if assign.device.type != "cuda":
        raise ValueError(f"walk_chunk: no kernel for device {assign.device}")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("walk_chunk: the kernel needs contiguous tensors")
    route = walk_route(C, cvars.shape[2], assign.shape[2])
    if n_steps:
        walk_chunk_cuda(cvars, ovars, osign, assign, tc,
                        (int(key[0]), int(key[1])), step0, n_steps, cb,
                        route == "shared")
        walk_chunk.launches += 1
        walk_chunk.route_launches[route] += 1
        walk_chunk.steps += n_steps
    return assign, tc


def reset_counts() -> None:
    """Set every count of the two wrappers to 0."""
    flip_update.launches = 0
    walk_chunk.launches = 0
    walk_chunk.route_launches = dict.fromkeys(ROUTES, 0)
    walk_chunk.steps = 0


# kernel launches made through the wrappers, walk_chunk's also by route and
# in walk steps (the CPU route counts none)
reset_counts()

__all__ = ["flip_update", "flip_update_ref", "walk_chunk", "walk_chunk_ref",
           "walk_route", "reset_counts"]
