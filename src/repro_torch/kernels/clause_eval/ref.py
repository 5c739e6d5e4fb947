"""Plain torch version of clause evaluation (the oracle of the CUDA kernel).

tc[b, c] = number of literals of clause c satisfied by assignment b. A
clause is UNSAT under the assignment iff tc == 0 — the quantity the probSAT
walk evaluates for every chain at the start of every chunk.
"""
from __future__ import annotations

import torch

# elements of the [K, B, clauses, L] gather held at once: the 8x8 window
# shapes would need ~7e9 in one piece, so clauses go through in slices
_GATHER_BUDGET = 1 << 26


def true_counts_window_ref(cvars: torch.Tensor, csign: torch.Tensor,
                           assign: torch.Tensor) -> torch.Tensor:
    """cvars [K,C,L] int32 (1-based var ids, 0 = padding); csign [K,C,L]
    bool; assign [K,B,V+1] bool. Returns [K,B,C] int32."""
    K, C, L = cvars.shape
    B = assign.shape[1]
    out = torch.empty((K, B, C), dtype=torch.int32, device=assign.device)
    step = max(1, _GATHER_BUDGET // max(1, K * B * L))
    for c0 in range(0, C, step):
        cv = cvars[:, c0:c0 + step].long()                 # [K, c, L]
        n = cv.shape[1]
        idx = cv.reshape(K, 1, n * L).expand(K, B, n * L)
        vals = torch.gather(assign, 2, idx).reshape(K, B, n, L)
        sat = (vals == csign[:, None, c0:c0 + step]) & (cv[:, None] > 0)
        out[:, :, c0:c0 + step] = sat.sum(-1, dtype=torch.int32)
    return out


def true_counts_ref(cvars: torch.Tensor, csign: torch.Tensor,
                    assign: torch.Tensor) -> torch.Tensor:
    """One CNF: cvars/csign [C,L]; assign [B,V+1] bool -> [B,C] int32."""
    return true_counts_window_ref(cvars[None], csign[None], assign[None])[0]
