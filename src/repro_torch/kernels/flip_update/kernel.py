"""ctypes binding of ``csrc/flip_update.cu`` (the Hopper counterpart of
the JAX package's ``kernels/flip_update/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import check, load

_NAME = "flip_update"


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.flip_update
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def flip_update_cuda(assign: torch.Tensor, tc: torch.Tensor,
                     v_flip: torch.Tensor, occ_c: torch.Tensor,
                     occ_s: torch.Tensor, new_val: torch.Tensor) -> None:
    """Launch on the current stream, updating ``assign`` and ``tc`` in
    place; the caller has checked device, dtype, shape and contiguity."""
    K, B, V1 = assign.shape
    lib, fn = _entry()
    code = fn(assign.data_ptr(), tc.data_ptr(), v_flip.data_ptr(),
              occ_c.data_ptr(), occ_s.data_ptr(), new_val.data_ptr(),
              K * B, V1, tc.shape[2], occ_c.shape[2],
              torch.cuda.current_stream(assign.device).cuda_stream)
    check(lib, _NAME, code)
