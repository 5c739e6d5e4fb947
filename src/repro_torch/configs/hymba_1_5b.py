"""Hymba-1.5B: hybrid — parallel attention + mamba heads in every block.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16. SSM branch: 32 heads x 100 = 3200 = 2*d_model inner width.
Sliding-window attention (1024) everywhere; the published model keeps 3
global-attention layers — we use uniform SWA so the layer stack stays
scan-homogeneous (noted in DESIGN.md). [arXiv:2411.13676; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_heads=32,
    ssm_head_dim=100,
    attn_window=1024,
)
