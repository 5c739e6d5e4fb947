"""Public clause-evaluation entry points: checks + dispatch + launch count.

A tensor on the CPU takes the plain torch version (``ref.py``); a CUDA
tensor launches the hand-written kernel or raises. There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from .kernel import clause_eval_window_cuda
from .ref import true_counts_ref, true_counts_window_ref

# one assignment row of V+1 bytes must fit the kernel's shared memory
MAX_VARS_PLUS_ONE = 232448


def _check(cvars, csign, assign, ndim: int) -> None:
    if cvars.dim() != ndim or csign.dim() != ndim or assign.dim() != ndim:
        raise ValueError(f"clause_eval: expected {ndim}-d cvars/csign/assign,"
                         f" got {tuple(cvars.shape)}, {tuple(csign.shape)}, "
                         f"{tuple(assign.shape)}")
    if cvars.shape != csign.shape or cvars.shape[:-2] != assign.shape[:-2]:
        raise ValueError(f"clause_eval: cvars {tuple(cvars.shape)}, csign "
                         f"{tuple(csign.shape)} and assign "
                         f"{tuple(assign.shape)} do not match")
    if cvars.dtype != torch.int32 or csign.dtype != torch.bool \
            or assign.dtype != torch.bool:
        raise TypeError(f"clause_eval: need int32 cvars, bool csign, bool "
                        f"assign; got {cvars.dtype}, {csign.dtype}, "
                        f"{assign.dtype}")
    if not (cvars.device == csign.device == assign.device):
        raise ValueError("clause_eval: tensors on different devices")


def _launch(cvars, csign, assign) -> torch.Tensor:
    if assign.device.type != "cuda":
        raise ValueError(f"clause_eval: no kernel for device {assign.device}")
    if not (cvars.is_contiguous() and csign.is_contiguous()
            and assign.is_contiguous()):
        raise ValueError("clause_eval: the kernel needs contiguous tensors")
    if assign.shape[-1] > MAX_VARS_PLUS_ONE:
        raise ValueError(f"clause_eval: V+1 = {assign.shape[-1]} exceeds the "
                         f"kernel's {MAX_VARS_PLUS_ONE}-byte shared row")
    return clause_eval_window_cuda(cvars, csign, assign)


def true_counts_window(cvars: torch.Tensor, csign: torch.Tensor,
                       assign: torch.Tensor) -> torch.Tensor:
    """Window true counts: cvars [K,C,L] int32; csign [K,C,L] bool; assign
    [K,B,V+1] bool -> [K,B,C] int32."""
    _check(cvars, csign, assign, 3)
    if assign.device.type == "cpu":
        return true_counts_window_ref(cvars, csign, assign)
    out = _launch(cvars, csign, assign)
    true_counts_window.launches += 1
    return out


def true_counts(cvars: torch.Tensor, csign: torch.Tensor,
                assign: torch.Tensor) -> torch.Tensor:
    """One CNF (the K = 1 launch of the window kernel): cvars [C,L] int32;
    csign [C,L] bool; assign [B,V+1] bool -> [B,C] int32."""
    _check(cvars, csign, assign, 2)
    if assign.device.type == "cpu":
        return true_counts_ref(cvars, csign, assign)
    out = _launch(cvars[None], csign[None], assign[None])[0]
    true_counts.launches += 1
    return out


# kernel launches made through each wrapper (the CPU route counts none)
true_counts_window.launches = 0
true_counts.launches = 0

__all__ = ["true_counts", "true_counts_window", "true_counts_ref",
           "true_counts_window_ref"]
