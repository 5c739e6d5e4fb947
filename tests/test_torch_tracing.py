"""The port's spans and counters (``repro_torch.tracing``) on the CPU: off
unless a profiler records or ``recording()`` is open, and then without
effect on what the LM computes; nested host ranges in the profiler's
Chrome trace; the MoE's dropped slots against a hand count; paths under
remat's recompute on a thread of its own; the record shared by threads;
the serve CLI's ``--spans`` report."""
from __future__ import annotations

import sys
import threading

import pytest
import torch

from perfbench.harness import trace
from perfbench.tests import tiny
from repro_torch import tracing
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_record():
    """Every test starts with an empty record and leaves one, so no other
    test reads a stale record."""
    from repro_torch import set_default_device
    set_default_device("cpu")
    tracing.reset()
    yield
    tracing.reset()


def _lm(model, **over) -> LM:
    cfg = ModelConfig(**dict(model, **over))
    return LM(cfg, "cpu").init(torch.Generator().manual_seed(0))


def _prompts(b=3, s=40):
    return torch.randint(0, 256, (b, s),
                         generator=torch.Generator().manual_seed(1))


def _ranges(tr, name):
    return [(a, b) for a, b, n in tr.host if n == "repro_torch." + name]


def _inside(tr, inner, outer) -> bool:
    """Some ``inner`` range lies within some ``outer`` range."""
    return any(a0 <= a and b <= b0 for a, b in _ranges(tr, inner)
               for a0, b0 in _ranges(tr, outer))


@pytest.mark.parametrize("config", sorted(tiny.MODELS))
def test_off_leaves_the_record_empty_and_on_changes_nothing(config):
    lm = _lm(tiny.MODELS[config])
    assert tracing.span("attention") is tracing.span("ssm")   # the no-op
    off = serve_lm(lm, _prompts(), STEPS)
    assert tracing.snapshot().spans == {}
    assert tracing.snapshot().counters == {}
    with tracing.recording():
        on = serve_lm(lm, _prompts(), STEPS)
    assert torch.equal(off.tokens, on.tokens)
    assert all(torch.equal(a, b) for a, b in zip(off.logits, on.logits))
    snap = tracing.snapshot()
    assert snap.spans["prefill"][0] == 1
    assert snap.spans["decode_step"][0] == STEPS
    assert snap.spans["prefill/attention"][0] == lm.cfg.n_layers
    assert all(dev is None for _, _, dev in snap.spans.values())  # no CUDA


def test_profiler_trace_holds_nested_ranges(tmp_path):
    hybrid, moe = _lm(tiny.HYBRID), _lm(tiny.MOE)
    with trace.Capture() as cap:
        serve_lm(hybrid, _prompts(), STEPS)
        serve_lm(moe, _prompts(), STEPS)
    tr = cap.trace
    for inner in ("attention", "ssm", "moe.dispatch", "cache_write",
                  "norm", "head"):
        assert _inside(tr, inner, "prefill"), inner
    for inner in ("attention", "cache_write", "moe.route", "moe.experts"):
        assert _inside(tr, inner, "decode_step"), inner
    assert _inside(tr, "moe.dispatch", "prefill")
    assert not _inside(tr, "prefill", "decode_step")
    # the profiler turned the record on, and it holds this window only
    snap = tracing.snapshot()
    assert snap.spans["prefill"][0] == 2
    assert snap.top_host_s() <= tr.window_s


def test_each_profiled_stretch_starts_a_new_record():
    lm = _lm(tiny.HYBRID)
    for _ in range(2):
        with trace.Capture():
            serve_lm(lm, _prompts(), STEPS)
        assert tracing.snapshot().spans["decode_step"][0] == STEPS
    serve_lm(lm, _prompts(), STEPS)              # off: the record stays
    assert tracing.snapshot().spans["decode_step"][0] == STEPS


def _hand_dropped(idx: torch.Tensor, e: int, cap: int) -> int:
    """(token, k) slots past their expert's capacity, counted in (token,
    k) order group by group."""
    dropped = 0
    for group in idx.reshape(idx.shape[0], -1).tolist():
        seen = [0] * e
        for x in group:
            dropped += seen[x] >= cap
            seen[x] += 1
    return dropped


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_dropped_slots_equal_a_hand_count(monkeypatch, impl):
    lm = _lm(tiny.MOE, moe_impl=impl)
    routed = []
    route = layers._route

    def kept(*a, **k):
        out = route(*a, **k)
        routed.append((out[3], out[4]))
        return out
    monkeypatch.setattr(layers, "_route", kept)
    e = lm.cfg.n_experts
    prompts = _prompts()
    with tracing.recording():
        lg, cache = lm.prefill_with_cache(prompts)
    for label, call in (("prefill", None), ("decode_step", 1)):
        if call is not None:
            routed.clear()
            with tracing.recording():
                lm.decode_step(cache, lg.argmax(-1), prompts.shape[1])
        got = tracing.snapshot().counters[label]
        assert len(routed) == lm.cfg.n_layers
        hand = sum(_hand_dropped(idx, e, cap) for idx, cap in routed)
        from_slots = sum(int((~layers._slots(idx, e, cap)[2]).sum())
                         for idx, cap in routed)
        assert got["moe_dropped_slots"] == hand == from_slots
        assert got["moe_routed_slots"] == sum(i.numel() for i, _ in routed)
        assert 0 < hand < got["moe_routed_slots"], "the case drops slots"


def test_counters_count_nothing_when_off():
    tracing.count("moe_dropped_slots", 5)
    assert tracing.snapshot().counters == {}
    with tracing.recording(), tracing.span("decode_step"):
        for _ in range(3 * tracing._FOLD):      # folded on the way
            tracing.count("moe_dropped_slots", torch.tensor(2))
            tracing.count("moe_routed_slots", 3)
    c = tracing.snapshot().counters["decode_step"]
    assert c == {"moe_dropped_slots": 6 * tracing._FOLD,
                 "moe_routed_slots": 9 * tracing._FOLD}


def test_remat_recompute_on_another_thread_nests_under_the_step():
    """The backward (and so remat's recompute of every block) runs on a
    thread with no span of its own, as autograd's worker does on the card;
    its spans nest under the step's open ``value_and_grad``."""
    lm = _lm(tiny.HYBRID, remat=True)
    params = [p.requires_grad_(True) for p in lm.parameters()]
    toks = _prompts(2, 24)
    batch = {"tokens": toks, "labels": toks}
    done = []
    with tracing.recording(), tracing.span("value_and_grad"):
        with torch.enable_grad():
            loss, _ = lm.loss_fn(batch)

        def backward():
            torch.autograd.grad(loss, params, allow_unused=True)
            done.append(True)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive() and done
    spans = tracing.snapshot().spans
    assert set(p.split("/")[0] for p in spans) == {"value_and_grad"}
    n = lm.cfg.n_layers
    assert spans["value_and_grad/attention"][0] == 2 * n   # and recomputed
    assert spans["value_and_grad/ssm"][0] == 2 * n


def test_train_step_spans():
    lm = _lm(tiny.HYBRID, remat=True)
    step = make_train_step(lm)
    toks = _prompts(2, 24)
    with tracing.recording():
        step(init_opt_state(lm), {"tokens": toks, "labels": toks})
    spans = tracing.snapshot().spans
    assert spans["value_and_grad"][0] == spans["optimizer"][0] == 1
    assert spans["value_and_grad/attention"][0] == 2 * lm.cfg.n_layers
    assert spans["value_and_grad/head"][0] == 1
    assert {p.split("/")[0] for p in spans} == {"value_and_grad",
                                               "optimizer"}


def test_threads_share_the_record_without_losing_calls():
    threads, calls = 12, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            def work():
                for _ in range(calls):
                    with tracing.span("decode_step"), tracing.span("norm"):
                        tracing.count("moe_routed_slots", 1)
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap.spans["decode_step"][0] == threads * calls
    assert snap.spans["decode_step/norm"][0] == threads * calls
    assert snap.counters["decode_step"]["moe_routed_slots"] == \
        threads * calls


def test_snapshot_arithmetic():
    snap = tracing.Snapshot(
        spans={"decode_step": (2, 0.5, None), "decode_step/ssm": (4, 0.2, None),
               "decode_step/ssm/x": (4, 0.1, None), "prefill": (1, 1.0, 0.9),
               "prefill/attention": (2, 0.3, 0.25)},
        counters={})
    assert snap.top_host_s() == pytest.approx(1.5)
    assert snap.children("decode_step") == ["decode_step/ssm"]
    assert snap.seconds(["prefill/attention", "prefill/none"], True) == 0.25
    assert snap.seconds(["decode_step/ssm"], True) is None
    assert snap.seconds(["prefill/none"], False) is None


def test_report_prints_each_top_level_spans_counters():
    snap = tracing.Snapshot(
        spans={"prefill": (1, 1.0, None)},
        counters={"prefill": {"ssd_kernel_calls": 32, "moe_routed_slots": 8,
                              "moe_dropped_slots": 2},
                  "value_and_grad": {"ssd_chunked_calls": 4}})
    lines = tracing.report(snap).splitlines()
    assert "prefill: 2 of 8 routed MoE slots dropped (25.00%)" in lines
    assert "prefill: ssd_kernel_calls 32" in lines
    assert "value_and_grad: ssd_chunked_calls 4" in lines


def test_serve_cli_prints_the_spans(capsys):
    serve_mod.main(["--arch", "deepseek_moe_16b", "--smoke", "--device",
                    "cpu", "--spans", "--batch", "2", "--steps", "2"])
    out = capsys.readouterr().out
    assert "decode_step/moe.dispatch" in out and "prefill/attention" in out
    assert "routed MoE slots dropped" in out
