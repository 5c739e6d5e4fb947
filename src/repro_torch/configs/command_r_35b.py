"""Command-R 35B: dense GQA, no biases.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    rope_theta=4000000.0,
)
