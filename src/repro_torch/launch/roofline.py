"""Roofline terms and model FLOPs for one NVIDIA H100 SXM (a copy of the
JAX package's ``launch/roofline.py`` with the card's constants).

    compute term    = FLOPs / PEAK_FLOPS           (per device)
    memory term     = bytes / HBM_BW               (per device)
    collective term = wire_bytes_per_device / LINK_BW

The constants are the H100 SXM's published dense rates (NVIDIA's H100
data sheet, SXM part, without sparsity):

    PEAK_FLOPS = 989.4e12   bf16 on the tensor cores, dense
    HBM_BW     = 3.35e12    bytes/s of HBM3
    LINK_BW    = 450e9      bytes/s of NVLink 4, one direction

No TPU number remains here. ``LINK_BW`` is the NVLink rate inside one
eight-GPU node; a 16x16 H100 mesh spans 32 such nodes, and its collectives
that cross nodes run on the slower network between them, so the
collective term is a lower bound.

The reference takes its FLOPs and bytes from XLA's ``cost_analysis`` of
the partitioned HLO and its wire bytes from parsing that HLO's
collectives (``parse_collectives``). The port has no HLO: the dry run
counts FLOPs and bytes from the aten ops of an eager trace, and the
partitioned dry run counts the collectives that DTensor issues on a mesh
over torch's fake process group (``repro_torch.launch.dryrun``), each
costed by :func:`wire_bytes` with the reference's ring formulas. Without
wire bytes (a record that has no partitioned trace) ``terms`` gives
``collective_s: None`` and takes the bottleneck over the terms it has.
``param_counts`` and ``model_flops`` are the reference's, unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 450e9

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclass
class CollectiveStats:
    """The reference's per-device collective summary: wire bytes in all,
    by kind, the count, and the largest ops as (label, wire bytes)."""
    wire_bytes: float = 0.0
    by_kind: Dict[str, float] = field(default_factory=dict)
    count: int = 0
    top: List[Tuple[str, float]] = field(default_factory=list)


def wire_bytes(kind: str, out_bytes: float, group_size: int) -> float:
    """Bytes one device sends for a collective of ``kind`` whose output is
    ``out_bytes`` on each device, over a group of ``group_size``, by the
    reference's ring formulas (``parse_collectives``): all-reduce
    2(g-1)/g of the output, all-gather (g-1)/g of the gathered output,
    reduce-scatter (g-1) times the output shard, all-to-all (g-1)/g,
    collective-permute the output's size."""
    g = group_size
    if kind == "all-reduce":
        return 2.0 * (g - 1) / max(g, 1) * out_bytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / max(g, 1) * out_bytes
    if kind == "reduce-scatter":
        return float(g - 1) * out_bytes
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")


def terms(flops: float, bytes_: float, wire_bytes: Optional[float],
          ) -> Dict[str, object]:
    """Seconds of each term, the term that bounds the step and the step's
    bound in seconds. ``wire_bytes=None`` (a record without a partitioned
    trace) leaves ``collective_s`` None and out of the bound."""
    t: Dict[str, object] = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_ / HBM_BW,
        "collective_s": None if wire_bytes is None else wire_bytes / LINK_BW,
    }
    have = {k: v for k, v in t.items() if v is not None}
    t["bottleneck"] = max(have, key=lambda k: have[k])
    t["step_s"] = max(have.values())
    return t


# ------------------------------------------------------- model FLOP count
def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts: total, active (MoE top-k), embedding."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    per_layer = 0.0
    per_layer_active = 0.0
    if not cfg.is_attention_free:
        attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
        per_layer += attn
        per_layer_active += attn
    if cfg.has_ssm:
        di = cfg.ssm_heads * cfg.ssm_head_dim
        ssm = 2 * d * di + 2 * d * cfg.ssm_state + d * cfg.ssm_heads + di * d
        per_layer += ssm
        per_layer_active += ssm
    if cfg.n_experts:
        router = d * cfg.n_experts
        experts = cfg.n_experts * 3 * d * f
        shared = cfg.n_shared_experts * 3 * d * f
        per_layer += router + experts + shared
        per_layer_active += router + cfg.top_k * 3 * d * f + shared
    elif f:
        per_layer += 3 * d * f
        per_layer_active += 3 * d * f
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return {
        "total": cfg.n_layers * per_layer + embed,
        "active": cfg.n_layers * per_layer_active,  # excl. embed/lm_head
        "embed": embed,
    }


def model_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference, with N the
    active non-embedding parameters (lm_head matmul added separately)."""
    n = param_counts(cfg)["active"]
    head = cfg.d_model * cfg.vocab  # lm_head matmul params
    mult = 6.0 if kind == "train" else 2.0
    return mult * (n + head) * tokens
