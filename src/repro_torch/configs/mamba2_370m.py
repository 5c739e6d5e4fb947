"""Mamba2-370M: attention-free SSD (state-space duality).

48L d_model=1024 vocab=50280, ssm_state=128; d_inner=2048 (32 heads x 64).
Tied embeddings. [arXiv:2405.21060; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    tie_embeddings=True,
)
