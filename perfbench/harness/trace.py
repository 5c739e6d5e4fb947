"""The device trace of a traced run, from ``torch.profiler``.

:class:`Capture` profiles a stretch of the window (CPU and CUDA
activities), exports the trace as Chrome JSON into a temporary directory
under ``TMPDIR`` and reads it back: every device operation (kernels,
copies, sets) with its time, and the benchmark's own spans
(``record_function`` ranges named ``perfbench.<span>``, opened around the
calls into the program by :func:`span`). A device operation belongs to
the span that was open on the host when it was launched (the launch's
correlation id). Busy time is the union of the device operations'
intervals; the window is the ``perfbench.window`` range around the whole
capture, which ends in a synchronize.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    """A host range ``perfbench.<name>`` that the trace attributes the
    device operations launched inside it to (a no-op unless profiling)."""
    from torch.profiler import record_function
    return record_function(PREFIX + name)


@dataclass
class Op:
    name: str
    cat: str              # kernel, gpu_memcpy or gpu_memset
    start: float          # microseconds on the profiler's clock
    dur: float
    span: Optional[str]


@dataclass
class Trace:
    ops: List[Op]
    spans: Dict[str, List[Tuple[float, float]]]
    window: Tuple[float, float]
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_span(self, name: str) -> List[Op]:
        return [o for o in self.ops if o.span == name]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in self._busy()) / 1e6

    def _busy(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        merged: List[List[float]] = []
        for a, b in sorted((max(o.start, w0), min(o.start + o.dur, w1))
                           for o in self.ops):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time, by name."""
        tot: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            tot[o.name[:160]] += o.dur / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time by what the host was doing meanwhile (the
        benchmark's span and the innermost host operation open at the
        middle of each gap), the ``n`` largest totals."""
        w0, w1 = self.window
        edges = [w0] + [t for ab in self._busy() for t in ab] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        tot: Dict[str, float] = defaultdict(float)
        for (a, b), inner in zip(gaps, self._innermost(
                [(a + b) / 2 for a, b in gaps])):
            where = self._span_at((a + b) / 2) or "outside spans"
            tot[f"{where}: {inner or 'no host op'}"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]

    def _innermost(self, times: List[float]) -> List[Optional[str]]:
        """The innermost host operation open at each of ``times`` (rising),
        by one sweep over the host operations in order of start (they nest
        within a thread)."""
        out: List[Optional[str]] = []
        stack: List[Tuple[float, str]] = []
        i = 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                a, b, name = self.host[i]
                while stack and stack[-1][0] < a:
                    stack.pop()
                stack.append((b, name))
                i += 1
            while stack and stack[-1][0] < t:
                stack.pop()
            out.append(stack[-1][1] if stack else None)
        return out

    def _span_at(self, t: float) -> Optional[str]:
        best = None
        for name, ivs in self.spans.items():
            for a, b in ivs:
                if a <= t <= b and (best is None or b - a < best[1]):
                    best = (name, b - a)
        return best[0] if best else None


def read_chrome(path: str) -> Trace:
    """A :class:`Trace` of an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches: Dict[int, float] = {}
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    host: List[Tuple[float, float, str]] = []
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
            host.append((ts, ts + dur, e["name"]))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans[e["name"][len(PREFIX):]].append((ts, ts + dur))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((ts, ts + dur, e["name"]))
    window = spans.pop("window", [(0.0, 0.0)])[0]
    flat = sorted((a, b, name) for name, ivs in spans.items()
                  for a, b in ivs)

    def owner(t: Optional[float]) -> Optional[str]:
        if t is None:
            return None
        best = None
        for a, b, name in flat:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else None

    ops = [Op(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0)),
              owner(launches.get(e.get("args", {}).get("correlation"))))
           for e in device]
    host.sort(key=lambda h: (h[0], -h[1]))
    return Trace(ops=ops, spans=dict(spans), window=window, host=host)


class Capture:
    """``with Capture() as cap: ...`` profiles the block; ``cap.trace`` is
    its :class:`Trace` afterwards. The block's work is synchronized before
    the window closes."""

    def __init__(self) -> None:
        self.trace: Optional[Trace] = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Capture":
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(span("window"))
        return self

    def __exit__(self, *exc) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stack.close()
        if exc[0] is not None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self.trace = read_chrome(path)


def warm() -> None:
    """Start and stop the profiler once, so that the traced window does not
    pay for its first start (CUPTI's)."""
    import torch
    with Capture():
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
