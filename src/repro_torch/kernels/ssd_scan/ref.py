"""Sequential-recurrence oracle for the Mamba2 SSD scan (a copy of the JAX
package's ``ssd_ref``): the literal per-step recurrence

    S_t = exp(dt_t * A) * S_{t-1} + dt_t * B_t x_t^T
    y_t = C_t^T S_t + D * x_t

It validates both the CUDA chunked kernel and the torch chunked dual form
in ``repro_torch.models.layers.ssd_chunked``.
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            return_state: bool = False):
    """x: [b,s,h,p]; dt: [b,s,h] (already softplus-ed); A_log: [h];
    B, C: [b,s,n]; D: [h]. Returns y: [b,s,h,p] (float32), or (y, the
    state after the last step [b,h,p,n], float32) when ``return_state``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    A = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A[None, :])                      # [b,h]
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])                           # [b,h,p,n]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1)                                      # [b,s,h,p]
    y = y + xf * D.float()[None, None, :, None]
    return (y, state) if return_state else y
