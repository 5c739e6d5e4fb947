"""Plain torch version of the fused flip + incremental true-count update.

Given one probSAT flip per chain (variable id, its new value, and the
pre-gathered occurrence row of that variable), apply the flip to the
assignment and bump the true count of every clause the variable occurs in:
+1 where the new value satisfies the literal, -1 where it un-satisfies it.
Integer-exact, so the CUDA kernel must agree with it bit for bit.
"""
from __future__ import annotations

import torch


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
