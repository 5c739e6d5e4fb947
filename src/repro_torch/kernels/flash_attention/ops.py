"""Public flash-attention entry point: checks + dispatch + launch count.

Kernel layout [B, H, S, D], GQA via Hq % Hkv == 0. A tensor on the CPU
takes the plain torch version (``ref.py``); a CUDA tensor launches the
hand-written kernel or raises. The kernel takes any Sq and Sk and any
strides on the B, H and S axes, so the JAX wrapper's padding to block
multiples and the model's swapped views need no copies here.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Sk,D]; q position i is absolute
    position q_offset + i, k position j is j. Returns [B,Hq,Sq,D] in q's
    dtype. D must be one of ``HEAD_DIMS`` and q, k, v share one dtype of
    ``DTYPES``; anything else raises ``ValueError`` on every device."""
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
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = flash_attention_cuda(q, k, v, causal=causal, window=int(window),
                               q_offset=int(q_offset))
    flash_attention.launches += 1
    return out


# kernel launches made through the wrapper (the CPU route counts none)
flash_attention.launches = 0

__all__ = ["flash_attention", "attention_ref"]
