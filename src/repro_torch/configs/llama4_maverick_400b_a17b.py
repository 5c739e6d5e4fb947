"""Llama-4 Maverick 400B-A17B backbone (MoE, early fusion).

48L d_model=5120 40H (GQA kv=8, head_dim=128) expert d_ff=8192
vocab=202048, 128 routed experts top-1 + 1 shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    n_shared_experts=1,
    top_k=1,
    rope_theta=500000.0,
    # expert weights alone are ~1.5 TB bf16: pure EP leaves 96 GiB/chip on
    # 256 chips — FSDP-shard them over the data axes as well (Perf It. 8)
    fsdp_experts=True,
)
