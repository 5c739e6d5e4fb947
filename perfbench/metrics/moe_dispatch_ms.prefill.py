"""Device time of the prefill's MoE routing and data movement: the
program's own spans ``prefill/moe.route`` (router product, softmax,
top-k), ``prefill/moe.dispatch`` (capacity slots, the scatters and the
dispatch product) and ``prefill/moe.combine`` (the combine product or
scatter-add) together (``repro_torch.tracing``; the expert GEMMs and the
shared experts left out), in ms a prefill, over the traced batch. A
span's device time is the interval between CUDA events recorded on the
stream at its entry and exit, so it includes any time the device idled
inside it. Nothing when the program keeps no such spans, or its record
is not of this window."""

LAYER = "layers"
MOVES = "ttft_p95_ms"
SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(obs):
    if obs.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if snap.top_host_s() > obs.trace.window_s or "prefill" not in snap.spans:
        return None
    s = snap.seconds([f"prefill/{n}" for n in SPANS], device=True)
    return None if s is None else 1e3 * s / snap.spans["prefill"][0]
