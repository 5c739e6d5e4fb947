"""Device time of the optimizer's update in the traced training step: the
program's own span ``optimizer`` (``repro_torch.tracing``, around
``optim/adamw.update``: the global gradient norm, then AdamW leaf by
leaf), in ms a step. A span's device time is the interval between CUDA
events recorded on the stream at its entry and exit, so it includes any
time the device idled inside it. Nothing when the program keeps no such
span, or its record is not of this window."""

LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(obs):
    if obs.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if snap.top_host_s() > obs.trace.window_s or \
            "optimizer" not in snap.spans:
        return None
    s = snap.seconds(["optimizer"], device=True)
    return None if s is None else 1e3 * s / snap.spans["optimizer"][0]
