"""The device's idle share while training: one minus the union of the
device operations' intervals over the traced window's wall time (one
whole training step)."""

LAYER = "device"
MOVES = "train_tokens_per_s"


def read(obs):
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.window_s)
