"""ctypes binding of ``csrc/flash_attention.cu`` (the Hopper counterpart of
the JAX package's ``kernels/flash_attention/kernel.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import check, load

_NAME = "flash_attention"


@functools.cache
def _entry():
    lib = load(_NAME)
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         q_offset: int) -> torch.Tensor:
    """Launch on the current stream; the caller has checked device, dtype
    and shapes, and every D axis is unit-stride. The output has q's
    strides, so a swapped [B,S,H,D] view comes back as one."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib, fn = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ctypes.addressof(strides), B, Hq, Hkv, Sq, Sk, D,
              int(q.dtype == torch.bfloat16), int(causal), int(window),
              int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, _NAME, code)
    return out
