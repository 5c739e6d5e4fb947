"""The share of the traced training step in which an NCCL kernel ran on
rank 0's card: the union of the intervals of the kernels whose name
holds ``nccl`` over the traced window's wall time (one whole step of
the host world: forward, backward, the gradients' reduce-scatter onto
the ZeRO-1 moments, the optimizer), in %. Nothing without a trace or
where no NCCL kernel ran."""

LAYER = "host world"
MOVES = "train_tokens_per_s"


def read(obs):
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    w0, w1 = obs.trace.window
    spans = sorted((max(o.start, w0), min(o.start + o.dur, w1))
                   for o in obs.trace.ops
                   if o.cat == "kernel" and "nccl" in o.name.lower())
    if not spans:
        return None
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += max(0.0, b - a)
            end = b
        elif b > end:
            busy += b - end
            end = b
    return 100.0 * busy / 1e6 / obs.trace.window_s
