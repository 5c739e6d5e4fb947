"""Spans and counters inside the port's LM, on the profiler's clock.

    from repro_torch import tracing
    with tracing.recording():
        serve_lm(lm, prompts, 8)
    print(tracing.report(tracing.snapshot()))

A span (``with tracing.span("attention"):``, or ``@tracing.spanned(...)``
on a function) is off unless ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``) or an operator has
opened ``with tracing.recording():``. Off, :func:`span` reads two flags
and hands back a shared no-op context: no ``record_function``, no CUDA
event, no launch, no synchronize. On, a span

1. opens ``torch.profiler.record_function("repro_torch.<name>")``, a host
   range on the device trace's own clock, which names the device's idle
   gaps after the host work that left them;
2. adds to the process-wide record, keyed by its path (the names of the
   spans open around it, outer first, joined by ``/``: ``prefill/attention``,
   ``decode_step/moe.dispatch``), one call, its host seconds
   (``time.perf_counter``) and its device seconds: the interval between
   two ``torch.cuda.Event``s recorded on the current stream at its entry
   and exit. That interval includes any time the device sat idle inside
   the span, so it is close to busy time only where the device is kept
   busy. The events are read in :func:`snapshot`, after the caller's own
   synchronize; a span never synchronizes. Without CUDA a span's device
   seconds are None (not measured).

Paths nest per thread. A thread with no span open of its own that runs a
backward (autograd's worker, running remat's recompute on the card)
nests its spans under the innermost span open on the thread that opened
the record's first span, so a recomputed block reads
``value_and_grad/attention``; other threads start paths of their own.

:func:`count` adds a number or a 0-d device tensor to a counter kept
under the top-level span open where it is called (``prefill``,
``decode_step``); tensors are added on the device and read in
:func:`snapshot`. The MoE layer counts ``moe_routed_slots`` and
``moe_dropped_slots``, its (token, expert) slots and those past their
expert's capacity; the SSM counts its whole-sequence SSD calls by route,
``ssd_kernel_calls`` (the hand-written kernel) and ``ssd_chunked_calls``
(the torch chunked form); ``serve_lm`` counts the bytes of the cache its
prefill made, ``cache_bytes_kv`` (the KV ring) and ``cache_bytes_ssm``
(the SSM state and convolution windows); the partitioned train step counts the bytes of
the gradients it lays out onto the optimizer state,
``grad_reduce_bytes``, inside its span ``grad_reduce``.

The record starts anew at the first span of each stretch in which tracing
is on (a profiler started while tracing was off, or an outermost
``recording()``), so it holds the latest traced window only.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_FOLD = 256         # counter terms kept before they are added together
_RESOLVE = 4096     # event pairs kept before the finished ones are read

_forced = 0         # open recording() blocks
_stretch = 0        # bumped each time tracing turns on
_switch = threading.Lock()      # guards _forced and _stretch
_OFF = contextlib.nullcontext()
_local = threading.local()


def active() -> bool:
    """Whether spans and counters record now."""
    return _forced > 0 or _profiler._is_profiler_enabled


def _stack() -> List[str]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Record:
    """The spans and counters of one stretch in which tracing is on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self, stretch: int = -1, owner: Optional[List[str]] = None
              ) -> None:
        self.stretch = stretch
        self.owner = owner          # the path stack of the first span's thread
        self.calls: Dict[str, int] = {}
        self.host_s: Dict[str, float] = {}
        self.device_s: Dict[str, float] = {}
        self.pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.counters: Dict[str, Dict[str, list]] = {}

    def parent(self, stack: List[str]) -> str:
        """The path a span opened on a thread with ``stack`` nests under,
        after starting a new record if a new stretch has begun."""
        with self._lock:
            if self.stretch != _stretch:
                self.reset(_stretch, stack)
            owner = self.owner
        if stack:
            return stack[-1]
        if owner is None or torch._C._current_graph_task_id() == -1:
            return ""               # not inside a backward
        try:
            return owner[-1]
        except IndexError:          # the owner closed its last span meanwhile
            return ""

    def add(self, path: str, host_s: float, begin, end) -> None:
        with self._lock:
            self.calls[path] = self.calls.get(path, 0) + 1
            self.host_s[path] = self.host_s.get(path, 0.0) + host_s
            if begin is not None:
                self.pending.append((path, begin, end))
                if len(self.pending) >= _RESOLVE:
                    self._resolve(wait=False)

    def count(self, top: str, name: str, value) -> None:
        with self._lock:
            terms = self.counters.setdefault(top, {}).setdefault(name, [])
            terms.append(value)
            if len(terms) >= _FOLD:
                terms[:] = [_fold(terms)]

    def _resolve(self, wait: bool) -> None:
        """Read the device seconds of the pending event pairs: all of them
        (``wait``: after the caller's synchronize), else those finished."""
        left = []
        for path, begin, end in self.pending:
            if not wait and not end.query():
                left.append((path, begin, end))
                continue
            end.synchronize()
            self.device_s[path] = (self.device_s.get(path, 0.0)
                                   + begin.elapsed_time(end) / 1e3)
        self.pending = left

    def snapshot(self) -> "Snapshot":
        with self._lock:
            self._resolve(wait=True)
            for by_name in self.counters.values():
                for terms in by_name.values():
                    terms[:] = [int(_fold(terms))]
            return Snapshot(
                spans={p: (n, self.host_s[p], self.device_s.get(p))
                       for p, n in self.calls.items()},
                counters={top: {k: v[0] for k, v in by_name.items()}
                          for top, by_name in self.counters.items()})


def _fold(terms: list):
    """The sum of a counter's terms: Python numbers on the host, tensors
    added on their device."""
    host = sum(t for t in terms if not isinstance(t, torch.Tensor))
    dev = [t for t in terms if isinstance(t, torch.Tensor)]
    return host + torch.stack(dev).sum() if dev else host


_RECORD = Record()


def _event() -> Optional[torch.cuda.Event]:
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    __slots__ = ("name", "path", "range", "t0", "begin")

    def __init__(self, name: str) -> None:
        self.name = name

    # the host clock is read first on entry and last on exit, so a span's
    # own cost counts in its host seconds, not in its parent's remainder
    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        stack = _stack()
        parent = _RECORD.parent(stack)
        self.path = f"{parent}/{self.name}" if parent else self.name
        stack.append(self.path)
        self.range = _profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.begin = _event()
        return self

    def __exit__(self, *exc) -> None:
        end = _event() if self.begin is not None else None
        self.range.__exit__(*exc)
        _stack().pop()
        _RECORD.add(self.path, time.perf_counter() - self.t0, self.begin,
                    end)


def span(name: str):
    """A context that, while tracing is on, times its block as the span
    ``name`` nested in the spans open around it; a shared no-op context
    otherwise."""
    if not _forced and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a 0-d tensor added on its device) to
    the counter ``name`` of the top-level span open here. Call it only
    while :func:`active`, so that nothing is computed for it otherwise."""
    if not active():
        return
    stack = _stack()
    path = _RECORD.parent(stack)
    _RECORD.count(path.split("/")[0], name, value)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn spans and counters on in this block, whether or not a profiler
    records; an outermost block starts a new record."""
    global _forced, _stretch
    with _switch:
        if not active():
            _stretch += 1
        _forced += 1
    try:
        yield
    finally:
        with _switch:
            _forced -= 1


def _hook_profiler_start() -> None:
    """Start a new stretch each time a profiler starts while tracing is
    off: torch calls ``_run_on_profiler_start`` from every profiler's
    start, before it sets ``_is_profiler_enabled``."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "_repro_torch_tracing", False):
        return

    def run_on_profiler_start():
        global _stretch
        with _switch:
            if not active():
                _stretch += 1
        start()
    run_on_profiler_start._repro_torch_tracing = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_hook_profiler_start()


@dataclass(frozen=True)
class Snapshot:
    """The record read: ``spans`` maps each path to (calls, host seconds,
    device seconds or None), ``counters`` each top-level span to its
    counters' totals."""
    spans: Dict[str, Tuple[int, float, Optional[float]]]
    counters: Dict[str, Dict[str, int]]

    def top_host_s(self) -> float:
        """Host seconds of the top-level spans: the traced time the record
        covers, which no window it belongs to can be shorter than."""
        return sum(h for p, (_, h, _) in self.spans.items() if "/" not in p)

    def children(self, path: str) -> List[str]:
        """The paths of the spans opened directly inside ``path``."""
        depth = path.count("/") + 1
        return sorted(p for p in self.spans if p.startswith(path + "/")
                      and p.count("/") == depth)

    def seconds(self, paths: List[str], device: bool) -> Optional[float]:
        """Device (or host) seconds of ``paths`` together; None when the
        record holds none of them or one was not timed on the device."""
        got = [self.spans[p][2 if device else 1] for p in paths
               if p in self.spans]
        if not got or any(v is None for v in got):
            return None
        return sum(got)


def snapshot() -> Snapshot:
    """The record of the latest stretch, device seconds and counters read
    (call it after synchronizing the device)."""
    return _RECORD.snapshot()


def reset() -> None:
    """Empty the record; the next span starts a new one."""
    _RECORD.reset()


def report(snap: Snapshot) -> str:
    """The record as a table, a line per path (calls, host ms, device ms),
    then each top-level span's share of MoE slots dropped and its other
    counters."""
    lines = [f"{'span':40s} {'calls':>7s} {'host ms':>11s} {'device ms':>11s}"]
    for path in sorted(snap.spans):
        n, host, dev = snap.spans[path]
        dev_txt = "not measured" if dev is None else f"{dev * 1e3:11.3f}"
        lines.append(f"{path:40s} {n:7d} {host * 1e3:11.3f} {dev_txt:>11s}")
    for top, c in sorted(snap.counters.items()):
        routed = c.get("moe_routed_slots", 0)
        if routed:
            dropped = c.get("moe_dropped_slots", 0)
            lines.append(f"{top or '(no span)'}: {dropped} of {routed} "
                         f"routed MoE slots dropped "
                         f"({100.0 * dropped / routed:.2f}%)")
        rest = [f"{k} {v}" for k, v in sorted(c.items())
                if not k.startswith("moe_")]
        if rest:
            lines.append(f"{top or '(no span)'}: {', '.join(rest)}")
    return "\n".join(lines)
