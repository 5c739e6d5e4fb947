"""MusicGen-large backbone: decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32, MHA, head_dim=64) d_ff=8192 vocab=2048.
The EnCodec frontend is a stub: input_specs provides precomputed frame
embeddings [B,S,d_model]; targets are codebook token ids.
[arXiv:2306.05284; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    frontend="audio_frames",
)
