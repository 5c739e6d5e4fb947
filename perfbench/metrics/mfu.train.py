"""The training step's share of the chip's bf16 peak: the model FLOPs of
one step (``counts.train_flops``: forward and backward of every matrix a
token passes through, the head at every position, attention over visible
pairs and the scan; remat's recompute not counted) over the mean time of
the window's untraced steps (host clock, each ending in a synchronize)
times 989.4 TFLOP/s."""
from perfbench.harness import counts

LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(obs):
    if not getattr(obs, "step_s", None):
        return None
    t = obs.traffic
    flops = counts.train_flops(obs.model, t["global_batch"], t["seq_len"])
    mean_s = sum(obs.step_s) / len(obs.step_s)
    return 100.0 * flops / (mean_s * counts.PEAK_BF16_FLOPS)
