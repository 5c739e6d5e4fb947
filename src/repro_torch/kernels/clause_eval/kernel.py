"""ctypes binding of ``csrc/clause_eval.cu`` (the Hopper counterpart of
the JAX package's ``kernels/clause_eval/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .._cuda import KernelError, check, load

_NAME = "clause_eval"
# the entry's code for a tile whose shared memory does not fit the card
_ERR_SHARED_MEMORY = -1


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.clause_eval_window
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.clause_eval_smem.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.clause_eval_smem.restype = ctypes.c_int
    return lib, fn


@functools.cache
def eval_smem() -> tuple[int, int]:
    """(static shared bytes of the compiled eval kernel, the card's opt-in
    shared memory per block), read once on the card."""
    lib, _ = _entry()
    static, optin = ctypes.c_int(0), ctypes.c_int(0)
    check(lib, _NAME, lib.clause_eval_smem(ctypes.byref(static),
                                           ctypes.byref(optin)))
    return static.value, optin.value


def clause_eval_window_cuda(cvars: torch.Tensor, csign: torch.Tensor,
                            assign: torch.Tensor,
                            clen: Optional[torch.Tensor],
                            tile: int) -> torch.Tensor:
    """Launch on the current stream; the caller has checked device, dtype,
    shape and contiguity. ``clen`` [K,C] int32 bounds the slots read of
    each row; ``None`` reads whole rows. ``tile`` is the chain tile in
    32-chain words (``ops.eval_tile``). Returns tc [K,B,C] int32."""
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
        out.data_ptr(), K, B, V1, C, L, tile,
        torch.cuda.current_stream(dev).cuda_stream)
    if code == _ERR_SHARED_MEMORY:
        static, optin = eval_smem()
        raise KernelError(
            f"{_NAME}: a tile of {tile} words at V+1 = {V1} needs "
            f"{4 * V1 * tile} bytes of dynamic shared memory, which with the "
            f"eval kernel's {static} static bytes exceeds the card's "
            f"{optin}-byte limit")
    check(lib, _NAME, code)
    return out
