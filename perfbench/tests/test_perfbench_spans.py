"""The readers of the program's own spans (``repro_torch.tracing``): each
on a hand-made record, and each reading nothing without a trace, without
its path, with a record longer than the traced window, or from a program
that keeps no spans. On the card: the spans' device time against the
device trace of the same window.

    PYTHONPATH=src python -m pytest -q perfbench/tests -m chip
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest

from perfbench.harness import registry
from perfbench.tests import tiny

SPAN_METRICS = ["attention_ms.prefill", "ssm_ms.prefill",
                "moe_dispatch_ms.prefill", "decode_glue_ms.serve",
                "optimizer_ms.train"]

# one traced batch (a prefill, 4 decode steps) and one training step
RECORD = {
    "prefill": (1, 0.90, 0.85),
    "prefill/attention": (2, 0.10, 0.20),
    "prefill/ssm": (2, 0.20, 0.40),
    "prefill/moe.route": (2, 0.01, 0.02),
    "prefill/moe.dispatch": (2, 0.02, 0.03),
    "prefill/moe.experts": (2, 0.03, 0.10),
    "prefill/moe.combine": (2, 0.01, 0.01),
    "decode_step": (4, 0.40, 0.30),
    "decode_step/attention": (8, 0.08, 0.05),
    "decode_step/ssm": (8, 0.06, 0.04),
    "decode_step/norm": (16, 0.02, 0.01),
    "decode_step/mlp": (8, 0.03, 0.02),
    "decode_step/moe.route": (8, 0.01, 0.01),
    "decode_step/moe.shared": (8, 0.02, 0.01),
    "decode_step/cache_write": (8, 0.04, 0.01),
    "decode_step/head": (4, 0.02, 0.01),
    "decode_step/attention/norm": (8, 0.01, 0.01),
    "optimizer": (1, 0.05, 0.25),
}
WANT = {"attention_ms.prefill": 200.0, "ssm_ms.prefill": 400.0,
        "moe_dispatch_ms.prefill": 60.0,
        # (0.40 - 0.08 - 0.06 - 0.02 - 0.03 - 0.01 - 0.02) s over 4 steps
        "decode_glue_ms.serve": 45.0,
        "optimizer_ms.train": 250.0}


def _observed(window_s=10.0):
    return SimpleNamespace(trace=SimpleNamespace(window_s=window_s))


@pytest.fixture
def record(monkeypatch):
    """``tracing.snapshot()`` hands the readers ``RECORD``."""
    from repro_torch import tracing

    def use(spans):
        snap = tracing.Snapshot(spans=dict(spans), counters={})
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    use(RECORD)
    return use


def _read(name, obs):
    return registry.metric_reader(name).read(obs)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_hand_made_record(record, name):
    assert _read(name, _observed()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reads_nothing_without_a_trace(record, name):
    assert _read(name, SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reads_nothing_without_its_path(record, name):
    record({p: v for p, v in RECORD.items()
            if not p.startswith(("prefill", "decode_step", "optimizer"))})
    assert _read(name, _observed()) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reads_nothing_from_a_record_longer_than_the_window(
        record, name):
    # the top-level spans hold 0.90 + 0.40 + 0.05 host seconds
    assert _read(name, _observed(window_s=1.3)) is None
    assert _read(name, _observed(window_s=1.35)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch,
                                                           name):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(name, _observed()) is None


def test_device_readers_read_nothing_where_no_device_time_was_taken(
        record):
    record({p: (n, h, None) for p, (n, h, _) in RECORD.items()})
    got = {n: _read(n, _observed()) for n in SPAN_METRICS}
    glue = got.pop("decode_glue_ms.serve")      # the host clock's
    assert glue == pytest.approx(WANT["decode_glue_ms.serve"])
    assert set(got.values()) == {None}


@pytest.mark.chip
def test_span_device_time_against_the_trace_on_the_card(cuda, tmp_path):
    """One profiled batch of the tiny hybrid LM, its prefill's attention
    on the flash kernel: the span's device interval holds the flash
    kernels' device time of the same prefill, and the top-level spans'
    device time fits in the traced window."""
    import torch
    from perfbench.kinds import serve
    from repro_torch import tracing
    torch.cuda.set_device(cuda)
    root = tiny.make_root(tmp_path)
    cell = registry.cell(tiny.cell_name("tiny_hybrid"), root)
    ctx = registry.Context(cell, 2 ** 32 + 11, 0.0, True, cuda,
                           time.perf_counter())
    tr = serve.serve_window(ctx)[4]
    snap = tracing.snapshot()
    flash = [o for o in tr.in_span("prefill")
             if o.cat == "kernel" and "flash" in o.name]
    assert flash
    attention = snap.seconds(["prefill/attention"], device=True)
    assert attention >= sum(o.dur for o in flash) / 1e6
    top = [p for p in snap.spans if "/" not in p]
    assert set(top) == {"prefill", "decode_step"}
    assert snap.seconds(top, device=True) <= tr.window_s
    assert snap.top_host_s() <= tr.window_s
