"""ctypes binding of ``csrc/flash_attention.cu`` (the Hopper counterpart of
the JAX package's ``kernels/flash_attention/kernel.py``): one C entry point
per route, ``flash_attention_bf16`` (TMA + wgmma, the bf16 route) and
``flash_attention_f32`` (SIMT, the f32 route)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .._cuda import check, load

_NAME = "flash_attention"
# route -> C entry point
ENTRIES = {"tensor_core": "flash_attention_bf16",
           "simt": "flash_attention_f32"}


@functools.cache
def _entry(route: str):
    lib = load(_NAME)
    fn = getattr(lib, ENTRIES[route])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, route: str, causal: bool, window: int,
                         q_offset: int, scale=None) -> torch.Tensor:
    """Launch the kernel of ``route`` (a key of ``ENTRIES``) on the
    current stream; the caller has checked device, dtype and shapes, every
    D axis is unit-stride and, on the tensor-core route, every base and
    B/H/S stride is 16-byte aligned. The output has q's strides, so a swapped [B,S,H,D]
    view comes back as one. ``scale`` (None: 1/sqrt(D), computed by the
    kernel's launch as before) scales the scores."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib, fn = _entry(route)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ctypes.addressof(strides), B, Hq, Hkv, Sq, Sk, D, int(causal),
              int(window), int(q_offset),
              0.0 if scale is None else float(scale),
              torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, _NAME, code)
    return out
