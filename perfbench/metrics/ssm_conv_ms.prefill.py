"""Device time of the prefill's SSM convolutions: the program's own span
``prefill/ssm/conv`` (``repro_torch.tracing``; every Mamba layer's three
depthwise causal convolutions of x, B and C with their SiLU, in f32), in
ms a prefill, over the traced batch. A span's device time is the
interval between CUDA events recorded on the stream at its entry and
exit, so it includes any time the device idled inside it. Nothing when
the program keeps no such span, or its record is not of this window."""

LAYER = "layers"
MOVES = "ttft_p95_ms"


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
    s = snap.seconds(["prefill/ssm/conv"], device=True)
    return None if s is None else 1e3 * s / snap.spans["prefill"][0]
