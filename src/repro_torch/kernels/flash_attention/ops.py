"""Public flash-attention entry point: checks + route + launch counts.

Kernel layout [B, H, S, D], GQA via Hq % Hkv == 0. A tensor on the CPU
takes the plain torch version (``ref.py``); a CUDA tensor launches one of
the two hand-written kernels or raises. The dtype alone picks the kernel
(:func:`flash_route`): bf16 runs on the tensor cores (TMA + wgmma), f32
on the SIMT kernel. The kernels take any Sq and Sk and any strides on the
B, H and S axes (16-byte aligned ones for the tensor cores), so the JAX
wrapper's padding to block multiples and the model's swapped views need
no copies.

The wrapper calls the operator ``torch.ops.repro_torch.flash_attention``
(defined here through ``torch.library``): its CPU kernel is the plain
version, its CUDA kernel the launch, and its fake kernel gives the
output's shape, dtype and strides, so the meta device and fake tensors
trace through it (the dry run, ``repro_torch.launch.dryrun``). Its FLOP
formula (:func:`flash_flops`, 4·D per visible (q, k) pair per q head,
``torch.utils.flop_counter``) lets ``FlopCounterMode`` count the same
FLOPs on meta and on cuda; without it a ctypes launch is invisible to any
dispatch mode. The operator is defined with ``torch.library.Library``
rather than ``torch.library.custom_op``, whose wrapper costs several
times as much per call; the launch counts stay on the wrapper.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import flash_attention_cuda
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("tensor_core", "simt")


def _aligned16(t: torch.Tensor) -> bool:
    """Base and B/H/S strides 16-byte aligned (an axis of one element never
    moves the address, so its stride is free)."""
    if t.data_ptr() % 16:
        return False
    return all(st * t.element_size() % 16 == 0
               for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[str, Tuple[bool, bool, bool]]:
    """The kernel for these operands and which of (q, k, v) the wrapper
    copies to a contiguous tensor first. The route depends on the dtype
    alone: bf16 -> "tensor_core", f32 -> "simt". A copy is a layout copy,
    never a switch of kernel: an operand whose D axis is not unit-stride
    is copied on both routes, and on the tensor-core route (whose loads
    are 16-byte copies) so is one whose base or B/H/S strides are not
    16-byte aligned."""
    if q.dtype == torch.bfloat16:
        return "tensor_core", tuple(t.stride(-1) != 1 or not _aligned16(t)
                                    for t in (q, k, v))
    return "simt", tuple(t.stride(-1) != 1 for t in (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Sk,D]; q position i is absolute
    position q_offset + i, k position j is j. Returns [B,Hq,Sq,D] in q's
    dtype. D must be one of ``HEAD_DIMS`` and q, k, v share one dtype of
    ``DTYPES``; anything else raises ``ValueError`` on every device. The
    kernel has no backward: with grad mode on and any of q, k, v requiring
    grad it raises ``NotImplementedError`` on every device, before any
    launch, where a CUDA launch would return an output with no
    ``grad_fn``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: expected 4-d q/k/v [B,H,S,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} need equal B "
                         f"and D and Hq a multiple of Hkv")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q/k/v must share one dtype of "
                         f"{DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward: the reference cannot "
            "differentiate its Pallas kernel either (jax.grad raises), and "
            "training uses attn_impl=\"blockwise\"; call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _OP(q, k, v, bool(causal), int(window), int(q_offset))


def _plain(q, k, v, causal, window, q_offset):
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def _launch(q, k, v, causal, window, q_offset):
    route, copies = flash_route(q, k, v)
    q, k, v = (t.contiguous() if c else t for t, c in zip((q, k, v), copies))
    out = flash_attention_cuda(q, k, v, route=route, causal=causal,
                               window=window, q_offset=q_offset)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.layout_copies += sum(copies)
    return out


def _fake(q, k, v, causal, window, q_offset):
    # the kernel's output has q's strides (``flash_attention_cuda``)
    return torch.empty_like(q)


def visible_pairs(sq: int, sk: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """(query, key) pairs the masks leave visible: query i at absolute
    position q_offset + i sees key j when j <= q_offset + i (causal) and
    j > q_offset + i - window (a window)."""
    pos = np.arange(q_offset, q_offset + sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full_like(pos, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset, *args,
                out_shape=None, **kwargs) -> int:
    """4·D FLOPs (QK^T and PV) per visible (q, k) pair per q head."""
    b, hq, sq, d = q_shape
    return 4 * d * b * hq * visible_pairs(sq, k_shape[2], causal, window,
                                          q_offset)


_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int q_offset) -> Tensor")
_LIB.impl("flash_attention", _plain, "CPU")
_LIB.impl("flash_attention", _launch, "CUDA")
torch.library.register_fake("repro_torch::flash_attention", _fake, lib=_LIB)
register_flop_formula(torch.ops.repro_torch.flash_attention)(flash_flops)
_OP = torch.ops.repro_torch.flash_attention.default


def reset_counts() -> None:
    """Set every count of the wrapper to 0."""
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
    flash_attention.layout_copies = 0


# kernel launches made through the wrapper, in all and by route, and the
# operands it copied to a contiguous layout first (the CPU route counts none)
reset_counts()

__all__ = ["flash_attention", "flash_route", "attention_ref", "reset_counts",
           "flash_flops", "visible_pairs"]
