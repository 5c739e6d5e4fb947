"""The prefill's share of the chip's bf16 peak: the model FLOPs of one
batch's prefill (``counts.prefill_flops``: the matrices a token passes
through, attention over visible pairs, the scan, the head at the last
position) over the mean prefill time of the window's untraced batches
(host clock, ending in a synchronize) times 989.4 TFLOP/s."""
from perfbench.harness import counts

LAYER = "LM"
MOVES = "ttft_p95_ms"


def read(obs):
    if not getattr(obs, "prefill_s", None):
        return None
    t = obs.traffic
    flops = counts.prefill_flops(obs.model, t["batch"], t["prompt_len"])
    mean_s = sum(obs.prefill_s) / len(obs.prefill_s)
    return 100.0 * flops / (mean_s * counts.PEAK_BF16_FLOPS)
