"""Qwen1.5-32B: dense with QKV bias.

64L d_model=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064.
[hf:Qwen/Qwen1.5 family; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
)
