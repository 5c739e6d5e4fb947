"""ctypes binding of ``csrc/clause_eval.cu`` (the Hopper counterpart of
the JAX package's ``kernels/clause_eval/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .._cuda import check, load

_NAME = "clause_eval"


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.clause_eval_window
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def clause_eval_window_cuda(cvars: torch.Tensor, csign: torch.Tensor,
                            assign: torch.Tensor,
                            clen: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch on the current stream; the caller has checked device, dtype,
    shape and contiguity. ``clen`` [K,C] int32 bounds the slots read of
    each row; ``None`` reads whole rows. Returns tc [K,B,C] int32."""
    K, B, V1 = assign.shape
    C, L = cvars.shape[1], cvars.shape[2]
    dev = assign.device
    out = torch.empty((K, B, C), dtype=torch.int32, device=dev)
    # the assignments as bit-planes, one word per (formula, var, 32 chains)
    planes = torch.empty((K * V1 * -(-B // 32),), dtype=torch.int32,
                         device=dev)
    lib, fn = _entry()
    code = fn(
        assign.data_ptr(), cvars.data_ptr(), csign.data_ptr(),
        None if clen is None else clen.data_ptr(), planes.data_ptr(),
        out.data_ptr(), K, B, V1, C, L,
        torch.cuda.current_stream(dev).cuda_stream)
    check(lib, _NAME, code)
    return out
