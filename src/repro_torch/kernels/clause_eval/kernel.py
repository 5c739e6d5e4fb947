"""ctypes binding of ``csrc/clause_eval.cu`` (the Hopper counterpart of
the JAX package's ``kernels/clause_eval/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import check, load

_NAME = "clause_eval"


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.clause_eval_window
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def clause_eval_window_cuda(cvars: torch.Tensor, csign: torch.Tensor,
                            assign: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream; the caller has checked device, dtype,
    shape and contiguity. Returns tc [K,B,C] int32."""
    K, B, V1 = assign.shape
    C, L = cvars.shape[1], cvars.shape[2]
    out = torch.empty((K, B, C), dtype=torch.int32, device=assign.device)
    lib, fn = _entry()
    code = fn(
        assign.data_ptr(), cvars.data_ptr(), csign.data_ptr(),
        out.data_ptr(), K, B, V1, C, L,
        torch.cuda.current_stream(assign.device).cuda_stream)
    check(lib, _NAME, code)
    return out
