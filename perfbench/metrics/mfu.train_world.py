"""The training step's share of the bf16 peak of every card of a host
world (a traffic mix that names ``ranks``): the model FLOPs of one step
of the global batch (``counts.train_flops``, as ``mfu.train`` counts
them: remat's recompute not counted) over the mean time of rank 0's
untraced steps (host clock, each ending in a synchronize) times the
ranks times 989.4 TFLOP/s. Nothing on one card, which ``mfu.train``
reads."""
from perfbench.harness import counts

LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(obs):
    ranks = obs.traffic.get("ranks")
    if not ranks or not getattr(obs, "step_s", None):
        return None
    t = obs.traffic
    flops = counts.train_flops(obs.model, t["global_batch"], t["seq_len"])
    mean_s = sum(obs.step_s) / len(obs.step_s)
    return 100.0 * flops / (mean_s * ranks * counts.PEAK_BF16_FLOPS)
