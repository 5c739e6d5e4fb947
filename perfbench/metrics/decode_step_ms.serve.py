"""The serve driver's time a decode step: each untraced batch's time from
its first token to the end of its last decode step (host clock, ending in
``serve_lm``'s synchronize) over its decode steps, averaged over the
window's batches. The host paces it."""

LAYER = "serve driver"
MOVES = "requests_per_s"


def read(obs):
    steps = getattr(obs, "decode_step_s", None)
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
