"""Kernels launched a decode step: the kernels of the traced batch whose
launch lies inside a ``decode_step`` span, over the number of spans."""

LAYER = "LM"
MOVES = "requests_per_s"


def read(obs):
    if obs.trace is None or not obs.trace.spans.get("decode_step"):
        return None
    n = sum(1 for o in obs.trace.in_span("decode_step") if o.cat == "kernel")
    return n / len(obs.trace.spans["decode_step"])
