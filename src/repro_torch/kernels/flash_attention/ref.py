"""Plain torch attention: full-materialization softmax, the oracle of the
flash kernel (a copy of the JAX package's ``attention_ref``).

Layout [B, H, S, D] (kernel layout). GQA by kv-head broadcast; causal and
sliding-window masks by absolute position; masked scores are -2^30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k,v: [B,Hkv,Sk,D]; Hq % Hkv == 0.
    q position i is absolute position q_offset + i; k position j is j.
    Scores are scaled by ``scale`` (None: 1/sqrt(D))."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    s = s / math.sqrt(d) if scale is None else s * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, -2.0 ** 30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
