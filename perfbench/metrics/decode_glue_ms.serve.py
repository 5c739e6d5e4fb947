"""Host time a decode step spends outside the layers' work: the host
seconds of the program's own span ``decode_step`` (``repro_torch.tracing``)
less those of the spans opened directly inside it for the layers
(``attention``, ``ssm``, ``mlp``, ``norm``, ``moe.*``), in ms a step,
over the traced batch's decode steps. What is left is the LM's own
bookkeeping: the embedding, unbinding the stacked layers, the cache's
per-layer views and writes (``cache_write``), the residual adds and the
head (``head``). Host clock, under the profiler. Nothing when the
program keeps no such span, or its record is not of this window."""

LAYER = "LM"
MOVES = "requests_per_s"
LAYER_SPANS = ("attention", "ssm", "mlp", "norm")


def read(obs):
    if obs.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if snap.top_host_s() > obs.trace.window_s or \
            "decode_step" not in snap.spans:
        return None
    steps, step_s, _ = snap.spans["decode_step"]
    layers = [p for p in snap.children("decode_step")
              if p.split("/")[-1] in LAYER_SPANS
              or p.split("/")[-1].startswith("moe.")]
    return 1e3 * (step_s - (snap.seconds(layers, device=False) or 0.0)) \
        / steps
