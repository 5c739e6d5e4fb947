"""InternVL2-76B backbone: InternViT (stub) + LLM decoder.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision
frontend is a stub: input_specs provides 256 precomputed patch embeddings
prepended to the text sequence. [arXiv:2404.16821; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    frontend="vision_patches",
    frontend_len=256,
)
