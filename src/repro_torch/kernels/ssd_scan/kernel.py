"""ctypes binding of ``csrc/ssd_scan.cu`` (the Hopper counterpart of the
JAX package's ``kernels/ssd_scan/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import check, load

_NAME = "ssd_scan"


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def scratch_numel(b: int, s: int, h: int, p: int, n: int,
                  chunk: int) -> int:
    """f32 elements of the three phases' scratch at a padded length s:
    each chunk's state term, replaced by the state before the chunk
    ([b*h, s/chunk, p, n]), then each chunk's decay exponent."""
    return b * h * (s // chunk) * (p * n + 1)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  scratch: torch.Tensor, *, chunk: int,
                  return_state: bool = False):
    """Launch on the current stream; the caller has checked device, dtype,
    shape (s % chunk == 0) and contiguity, with dt, A_log and D in f32,
    and made ``scratch`` (f32, :func:`scratch_numel` elements). Returns
    (y, the f32 state after the last row [b,h,p,n] when ``return_state``,
    else an empty f32 tensor)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    # the state pass writes every element where s > 0; an empty sequence
    # leaves the state at zero
    final = (torch.zeros if s == 0 else torch.empty)(
        (b, h, p, n) if return_state else (0,), dtype=torch.float32,
        device=x.device)
    seglast = scratch.data_ptr() + 4 * b * h * (s // chunk) * p * n
    lib, fn = _entry()
    code = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), y.data_ptr(), scratch.data_ptr(),
              seglast, final.data_ptr() if return_state else None,
              b, s, h, p, n, chunk, int(x.dtype == torch.bfloat16),
              int(B.dtype == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, _NAME, code)
    return y, final
