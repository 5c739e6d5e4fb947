"""ctypes bindings of ``csrc/flip_update.cu``: the per-step flip update
and the walk chunk, both Hopper counterparts of the JAX package's
``kernels/flip_update/kernel.py``."""
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
    walk = lib.walk_chunk
    walk.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_uint32] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    walk.restype = ctypes.c_int
    return lib, fn, walk


def flip_update_cuda(assign: torch.Tensor, tc: torch.Tensor,
                     v_flip: torch.Tensor, occ_c: torch.Tensor,
                     occ_s: torch.Tensor, new_val: torch.Tensor) -> None:
    """Launch on the current stream, updating ``assign`` and ``tc`` in
    place; the caller has checked device, dtype, shape and contiguity."""
    K, B, V1 = assign.shape
    lib, fn, _ = _entry()
    code = fn(assign.data_ptr(), tc.data_ptr(), v_flip.data_ptr(),
              occ_c.data_ptr(), occ_s.data_ptr(), new_val.data_ptr(),
              K * B, V1, tc.shape[2], occ_c.shape[2],
              torch.cuda.current_stream(assign.device).cuda_stream)
    check(lib, _NAME, code)


def walk_chunk_cuda(cvars: torch.Tensor, ovars: torch.Tensor,
                    osign: torch.Tensor, assign: torch.Tensor,
                    tc: torch.Tensor, key: tuple[int, int], step0: int,
                    n_steps: int, cb: float, shared: bool) -> None:
    """Launch ``n_steps`` steps on the current stream, updating ``assign``
    and ``tc`` in place; ``shared`` picks the route. The caller has checked
    device, dtype, shape and contiguity."""
    K, B, V1 = assign.shape
    _, C, L = cvars.shape
    lib, _, walk = _entry()
    code = walk(cvars.data_ptr(), ovars.data_ptr(), osign.data_ptr(),
                assign.data_ptr(), tc.data_ptr(), K, B, C, L, V1,
                ovars.shape[2], key[0], key[1], step0 & 0xFFFFFFFF, n_steps,
                -cb, int(shared),
                torch.cuda.current_stream(assign.device).cuda_stream)
    check(lib, "walk_chunk", code)
