"""Public SSD-scan entry point: padding + checks + dispatch + launch count.

A tensor on the CPU takes the plain torch version (``ref.py``, the
sequential recurrence, cast to x's dtype); a CUDA tensor launches the
hand-written chunked kernel or raises. The sequence is padded to a chunk
multiple with dt = 0, which leaves state and output unchanged, as the JAX
wrapper does. With ``return_state`` both routes also return the f32 state
after the last row, which a prefill hands to decode
(``repro_torch.models.layers.ssd_decode_step``).

The wrapper calls the operator ``torch.ops.repro_torch.ssd_scan``
(defined here through ``torch.library``, as ``flash_attention`` is): its
CPU kernel is the plain version, its CUDA kernel the launch, and its fake
kernel gives y's and the state's shapes, so the meta device traces the
path the card runs (the dry run, ``repro_torch.launch.dryrun``). The
kernel's f32 scratch is made by the wrapper and handed to the operator as
a mutated argument, so the dry run counts it among the step's live bytes.
Its FLOP formula (:func:`ssd_flops`) lets ``FlopCounterMode`` count the
same FLOPs on meta and on cuda; without it a ctypes launch is invisible
to any dispatch mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from .kernel import scratch_numel, ssd_scan_cuda
from .ref import ssd_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128      # P
MAX_STATE = 128         # N
MAX_CHUNK = 1024


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """Chunked SSD scan. x: [b,s,h,p]; dt: [b,s,h] (post-softplus);
    A_log: [h]; B, C: [b,s,n]; D: [h]. Returns y [b,s,h,p] in x's dtype,
    or (y, the f32 state after the last row [b,h,p,n]) when
    ``return_state``, as ``ssd_chunked`` does. x and B/C are f32 or bf16
    (B and C alike); p, n <= 128 and chunk <= 1024, else ``ValueError``
    on every device."""
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
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    scratch = x.new_empty((0,), dtype=torch.float32)
    if x.device.type != "cpu":
        pad = -s % chunk
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            B = F.pad(B, (0, 0, 0, pad))
            C = F.pad(C, (0, 0, 0, pad))
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
        dt, A_log, D = (t.float().contiguous() for t in (dt, A_log, D))
        scratch = x.new_empty((scratch_numel(b, s + pad, h, p, n, chunk),),
                              dtype=torch.float32)
    y, state = _OP(x, dt, A_log, B, C, D, scratch, int(chunk),
                   bool(return_state))
    y = y[:, :s]
    return (y, state) if return_state else y


def _plain(x, dt, A_log, B, C, D, scratch, chunk, return_state):
    y, state = ssd_ref(x, dt, A_log, B, C, D, return_state=True)
    return y.to(x.dtype), state if return_state else state.new_empty((0,))


def _launch(x, dt, A_log, B, C, D, scratch, chunk, return_state):
    out = ssd_scan_cuda(x, dt, A_log, B, C, D, scratch, chunk=chunk,
                        return_state=return_state)
    ssd_scan.launches += 1
    return out


def _fake(x, dt, A_log, B, C, D, scratch, chunk, return_state):
    b, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty(
        (b, h, p, B.shape[-1]) if return_state else (0,),
        dtype=torch.float32)


def ssd_flops(x_shape, dt_shape, A_log_shape, B_shape, C_shape, D_shape,
              scratch_shape, chunk, return_state, *args, out_shape=None,
              **kwargs) -> int:
    """The chunked form's products, per (row, head, chunk) of l rows:
    C.B^T and the decay-weighted product with x over the l(l+1)/2 causal
    pairs (2·(n + p) FLOPs each), and the two [l,p,n] state products
    (4·l·p·n). The chunk count rounds a padded tail up, so the unpadded
    CPU operands count what the padded ones do."""
    b, s, h, p = x_shape
    n = B_shape[-1]
    tri = chunk * (chunk + 1) // 2
    return b * h * -(-s // chunk) * (2 * tri * (n + p) + 4 * chunk * n * p)


# kernel launches made through the wrapper (the CPU route counts none)
ssd_scan.launches = 0

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A_log, Tensor B, "
            "Tensor C, Tensor D, Tensor(a!) scratch, int chunk, "
            "bool return_state) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", _plain, "CPU")
_LIB.impl("ssd_scan", _launch, "CUDA")
torch.library.register_fake("repro_torch::ssd_scan", _fake, lib=_LIB)
register_flop_formula(torch.ops.repro_torch.ssd_scan)(ssd_flops)
_OP = torch.ops.repro_torch.ssd_scan.default

__all__ = ["ssd_scan", "ssd_ref", "ssd_flops"]
