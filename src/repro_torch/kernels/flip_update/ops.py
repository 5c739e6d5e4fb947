"""Public flip-update entry point: checks + dispatch + launch count.

A tensor on the CPU takes the plain torch version (``ref.py``), which
returns new tensors; a CUDA tensor launches the hand-written kernel, which
updates ``assign`` and ``tc`` in place and returns them, or raises. Callers
use the returned pair either way and do not reuse the inputs.
"""
from __future__ import annotations

import torch

from .kernel import flip_update_cuda
from .ref import flip_update_ref

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


# kernel launches made through the wrapper (the CPU route counts none)
flip_update.launches = 0

__all__ = ["flip_update", "flip_update_ref"]
