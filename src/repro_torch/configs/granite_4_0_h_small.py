"""Granite-4.0-H-Small: a 40-layer stack of Mamba2 and NoPE attention
layers, each with a 72-expert MoE (top-10) and a shared SwiGLU MLP.

40L d_model=4096, Mamba2 at every layer but 5, 15, 25 and 35 (GQA 32 q /
8 kv heads of 128, no rotary positions, scores scaled by 1/128); Mamba2
128 heads of 64 (inner width 8192), state 128, one group, conv 4 with
bias, chunk 256; MoE 72 experts of 768, top-10, shared MLP 1536 (two
shared experts of 768 in the port's terms); embedding x12, residual
branches x0.22, logits / 16; tied embeddings, vocab 100352, RMSNorm eps
1e-5. 32.2B parameters, 9B active.
[https://huggingface.co/ibm-granite/granite-4.0-h-small config.json]
"""
from ..models.config import PatternConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = PatternConfig(
    name="granite-4.0-h-small",
    family="moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab=100352,
    n_experts=72,
    n_shared_experts=2,
    top_k=10,
    ssm_state=128,
    ssm_heads=128,
    ssm_head_dim=64,
    ssm_chunk=256,
    d_conv=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    layer_kinds=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                      for i in range(40)),
    rope=False,
    attn_scale=1.0 / 128,
    embed_scale=12.0,
    residual_scale=0.22,
    logit_scale=16.0,
    conv_bias=True,
)
