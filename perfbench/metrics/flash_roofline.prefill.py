"""``flash_attention``'s share of its roofline in the prefill: the least
time of the prefill's attention at the cell's shapes (every layer's call:
q, k, v read once, o written once, 4·D FLOPs per visible pair, at the
chip's peaks; ``counts.flash_bound_s``) over the device time of the
flash kernels launched inside the prefill span. Nothing when no flash
kernel ran there."""
from perfbench.harness import counts

LAYER = "kernels"
MOVES = "ttft_p95_ms"


def read(obs):
    if obs.trace is None:
        return None
    ops = [o for o in obs.trace.in_span("prefill")
           if o.cat == "kernel" and "flash_fwd_kernel" in o.name]
    if not ops:
        return None
    m, t = obs.model, obs.traffic
    bound, _ = counts.flash_bound_s(
        t["batch"], m["n_heads"], m["n_kv_heads"], t["prompt_len"],
        m.get("head_dim", 128), m.get("attn_window", 0), 2)
    return 100.0 * bound * m["n_layers"] / (sum(o.dur for o in ops) / 1e6)
