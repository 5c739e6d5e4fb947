"""``flash_attention``'s share of its roofline in the prefill of a stack
of layers of different kinds (a configuration whose ``model`` names
``layer_kinds``): the least time of the attention layers' calls at the
cell's shapes (q, k, v read once, o written once, 4·D FLOPs per visible
pair, at the chip's peaks; ``counts.flash_bound_s``) times the number of
attention layers, over the device time of the flash kernels launched
inside the prefill span. Nothing for a uniform stack, which
``flash_roofline.prefill`` reads, or when no flash kernel ran there."""
from perfbench.harness import counts

LAYER = "kernels"
MOVES = "ttft_p95_ms"


def read(obs):
    if obs.trace is None or "layer_kinds" not in obs.model:
        return None
    ops = [o for o in obs.trace.in_span("prefill")
           if o.cat == "kernel" and "flash_fwd_kernel" in o.name]
    if not ops:
        return None
    m, t = obs.model, obs.traffic
    bound, _ = counts.flash_bound_s(
        t["batch"], m["n_heads"], m["n_kv_heads"], t["prompt_len"],
        m["head_dim"], m.get("attn_window", 0), 2)
    layers = list(m["layer_kinds"]).count("attention")
    return 100.0 * bound * layers / (sum(o.dur for o in ops) / 1e6)
