"""The attention head plan of the JAX package's ``models/sharding.py``.

The port runs on one GPU and reads the plan at tp=1, where for every
supported architecture ``h_pad == n_heads`` and ``kv_virtual == n_kv``;
the plan is kept so that parameter shapes, the dead-head mask and the
weight conversion follow the reference's layout exactly. The mesh helpers
(``spec``, ``batch_axes``, ``tp_size``, ``dp_size``) have no single-GPU
counterpart and are not copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnPlan:
    """Padded/virtualized head layout for a given TP degree.

    h_pad      padded q heads (multiple of tp; extra heads functionally dead)
    kv_virtual virtual kv heads materialized in weights & KV cache
               (multiple of tp or == true kv heads when replicated=1)
    group      q heads per virtual kv head (h_pad / kv_virtual)
    repl       how many times each true kv head is duplicated
    """
    n_heads: int
    n_kv: int
    h_pad: int
    kv_virtual: int
    group: int
    repl: int

    @property
    def pad_overhead(self) -> float:
        return self.h_pad / self.n_heads


def plan_attention(n_heads: int, n_kv: int, tp: int) -> AttnPlan:
    if n_heads % n_kv:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    gs = n_heads // n_kv
    # Search padded (groups g_p, group size gs_p). Original q head i lands in
    # padded slot (i//gs)*gs_p + (i%gs), so pairing with its kv head is
    # preserved; added slots/groups carry zero weights (function unchanged).
    best: Optional[Tuple[int, int, int]] = None  # (total, g_p, gs_p)
    for g_p in range(n_kv, 4 * n_kv + 1):
        for gs_p in range(gs, 4 * gs + 1):
            total = g_p * gs_p
            if total % tp:
                continue
            hps = total // tp  # q heads per shard
            # a shard must hold whole groups, or a group must span shards evenly
            if hps % gs_p and gs_p % hps:
                continue
            if best is None or total < best[0]:
                best = (total, g_p, gs_p)
    if best is None:
        raise ValueError(f"no attention plan for H={n_heads} kv={n_kv} tp={tp}")
    total, g_p, gs_p = best
    hps = total // tp
    if hps % gs_p == 0:
        # whole groups per shard: kv heads sharded directly, no replication
        kv_virtual, repl = g_p, 1
    else:
        # each group spans k shards -> replicate kv k times
        k = gs_p // hps
        kv_virtual, repl = g_p * k, k
    return AttnPlan(n_heads=n_heads, n_kv=n_kv, h_pad=total,
                    kv_virtual=kv_virtual, group=total // kv_virtual, repl=repl)


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
