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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                  chunk: int) -> torch.Tensor:
    """Launch on the current stream; the caller has checked device, dtype,
    shape (s % chunk == 0) and contiguity, with dt, A_log and D in f32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    # scratch of the three phases: each chunk's state term, replaced by the
    # state before the chunk, and each chunk's decay exponent
    states = torch.empty((b * h * (s // chunk) * p * n,), dtype=torch.float32,
                         device=x.device)
    seglast = torch.empty((b * h * (s // chunk),), dtype=torch.float32,
                          device=x.device)
    lib, fn = _entry()
    code = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), y.data_ptr(), states.data_ptr(),
              seglast.data_ptr(), b, s, h, p, n, chunk,
              int(x.dtype == torch.bfloat16), int(B.dtype == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, _NAME, code)
    return y
