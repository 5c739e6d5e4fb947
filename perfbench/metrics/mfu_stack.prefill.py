"""The prefill's share of the chip's bf16 peak for a stack of layers of
different kinds (a configuration whose ``model`` names ``layer_kinds``):
the model FLOPs of one batch's prefill counted layer by layer, by
``counts.py``'s conventions (2 FLOPs a weight of every matrix a token
passes through: the layer's own mixer, the router, the 10 routed
experts it picks and the shared experts; 4·D a visible (query, key) pair
a query head in the attention layers; 4·P·N a head a token in the Mamba
layers; the head at each prompt's last position), over the mean prefill
time of the window's untraced batches (host clock, ending in a
synchronize) times 989.4 TFLOP/s. Nothing for a uniform stack, which
``mfu.prefill`` reads."""
from perfbench.harness import counts

LAYER = "LM"
MOVES = "ttft_p95_ms"


def layer_flops(m, kind, rows, s):
    """Forward FLOPs of one layer of ``kind`` for ``rows`` sequences of
    ``s`` positions."""
    d, tokens = m["d_model"], rows * s
    if kind == "attention":
        hd = m["head_dim"]
        q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
        mixer = 2 * (2 * d * q + 2 * d * kv) * tokens + \
            counts.visible_pairs(s) * 4 * hd * m["n_heads"] * rows
    else:
        h, n = m["ssm_heads"], m["ssm_state"]
        di = h * m["ssm_head_dim"]
        mixer = 2 * (3 * d * di + 2 * d * n + d * h) * tokens + \
            4 * h * m["ssm_head_dim"] * n * tokens
    ffn = 2 * (d * m["n_experts"] + 3 * d * m["d_ff"] * (
        m["top_k"] + m.get("n_shared_experts", 0))) * tokens
    return mixer + ffn


def prefill_flops(m, rows, s):
    """Model FLOPs of prefilling ``rows`` prompts of ``s`` tokens through
    every layer, and the head at each prompt's last position."""
    return sum(layer_flops(m, k, rows, s) for k in m["layer_kinds"]) + \
        2 * m["d_model"] * m["vocab"] * rows


def read(obs):
    if not getattr(obs, "prefill_s", None) or \
            "layer_kinds" not in obs.model:
        return None
    t = obs.traffic
    flops = prefill_flops(obs.model, t["batch"], t["prompt_len"])
    mean_s = sum(obs.prefill_s) / len(obs.prefill_s)
    return 100.0 * flops / (mean_s * counts.PEAK_BF16_FLOPS)
