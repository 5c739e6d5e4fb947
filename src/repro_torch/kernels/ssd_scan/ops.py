"""Public SSD-scan entry point: padding + checks + dispatch + launch count.

A tensor on the CPU takes the plain torch version (``ref.py``, the
sequential recurrence, cast to x's dtype); a CUDA tensor launches the
hand-written chunked kernel or raises. The sequence is padded to a chunk
multiple with dt = 0, which leaves state and output unchanged, as the JAX
wrapper does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_scan_cuda
from .ref import ssd_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128      # P
MAX_STATE = 128         # N
MAX_CHUNK = 1024


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Chunked SSD scan. x: [b,s,h,p]; dt: [b,s,h] (post-softplus);
    A_log: [h]; B, C: [b,s,n]; D: [h]. Returns y [b,s,h,p] in x's dtype.
    x and B/C are f32 or bf16 (B and C alike); p, n <= 128 and
    chunk <= 1024, else ``ValueError`` on every device."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3 \
            or A_log.dim() != 1 or D.dim() != 1:
        raise ValueError("ssd_scan: expected x [b,s,h,p], dt [b,s,h], "
                         "B/C [b,s,n], A_log/D [h]")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or B.shape != C.shape \
            or B.shape[:2] != (b, s) or A_log.shape != (h,) \
            or D.shape != (h,):
        raise ValueError(f"ssd_scan: shapes do not match x {tuple(x.shape)}:"
                         f" dt {tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A_log {tuple(A_log.shape)}, D "
                         f"{tuple(D.shape)}")
    if p > MAX_HEAD_DIM or n > MAX_STATE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: need p <= {MAX_HEAD_DIM}, n <= "
                         f"{MAX_STATE}, 0 < chunk <= {MAX_CHUNK}; got p={p}, "
                         f"n={n}, chunk={chunk}")
    if x.dtype not in DTYPES or B.dtype not in DTYPES or B.dtype != C.dtype:
        raise ValueError(f"ssd_scan: x and B/C must be f32 or bf16, B and C "
                         f"alike; got {x.dtype}, {B.dtype}, {C.dtype}")
    if not all(t.dtype.is_floating_point for t in (dt, A_log, D)):
        raise ValueError("ssd_scan: dt, A_log and D must be floating point")
    if len({t.device for t in (x, dt, A_log, B, C, D)}) != 1:
        raise ValueError("ssd_scan: tensors on different devices")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A_log, B, C, D).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y = ssd_scan_cuda(x.contiguous(), dt.float().contiguous(),
                      A_log.float().contiguous(), B.contiguous(),
                      C.contiguous(), D.float().contiguous(), chunk=chunk)
    ssd_scan.launches += 1
    return y[:, :s]


# kernel launches made through the wrapper (the CPU route counts none)
ssd_scan.launches = 0

__all__ = ["ssd_scan", "ssd_ref"]
