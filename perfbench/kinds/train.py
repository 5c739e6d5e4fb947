"""Train traffic: the port's training step on batches drawn from the seed.

Set-up builds one object, the train step that ``train_loop`` runs
(``repro_torch.launch.steps.make_train_step`` over the LM with the
benchmark's seeded weights and zero AdamW state, the optimizer's default
settings), and drives it through its first ``check_steps`` steps, which
warm every shape: it reads each step's loss, the first step's gradient
norm by leaf as the optimizer took it (its first moment after one step
over 1 - b1), and each leaf's norm of change after those steps (against
the weights drawn again from the seed). The same object then trains in
the window, one step after another on new batches, until ``--seconds``
have passed; the tokens per second are the tokens of the window's steps
over their time (host clock, each step ending in a synchronize). With
tracing, the window's first step runs under torch.profiler.

A batch is ``global_batch`` rows of ``seq_len + 1`` token ids, uniform
over the vocabulary and drawn per step from the seed: the first
``seq_len`` are the inputs, the last ``seq_len`` the labels.

Correctness: once the window has closed and the peak memory is read, the
program is freed and the float32 reference (``reference.train``) follows
the same first steps from the same weights. Each compared number is a
gap between the program's reading and the reference's: each step's loss
(relative), and, by the worst leaf, the first gradient's norm and the
norm of change, each measured against the larger of that leaf's
reference norm and the median leaf's. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of both leaf comparisons.
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time
from types import SimpleNamespace
from typing import Dict, List
from unittest import mock

import torch

from ..harness import registry, result, trace, weights
from ..reference import lm as ref
from ..reference import train as ref_train
from .serve import check_layout

NEGLIGIBLE = 1e-3      # of the median leaf's reference gradient norm


@contextlib.contextmanager
def _half_batch():
    """The step's loss and gradients over the first half of the batch's
    rows, the mean taken over them."""
    import repro_torch.launch.steps as st
    vg = st.value_and_grad
    with mock.patch.object(st, "value_and_grad", lambda lm, b: vg(
            lm, {k: v[:v.shape[0] // 2] for k, v in b.items()})):
        yield


@contextlib.contextmanager
def _state_unchanged():
    """An optimizer step that returns its state unchanged and moves no
    weight."""
    import repro_torch.optim.adamw as aw
    with mock.patch.object(aw, "update", lambda cfg, grads, state, params:
                           (state, {"grad_norm": torch.zeros(()),
                                    "lr": torch.zeros(())})):
        yield


# the faults of a training cell's timed path that its check must refuse
FAULTS = {"half_batch": _half_batch, "state_unchanged": _state_unchanged}


def batch(seed: int, step: int, tr: Dict, vocab: int, device):
    toks = weights.tokens(seed, ("train", step), tr["global_batch"],
                          tr["seq_len"] + 1, vocab, device)
    return toks[:, :-1], toks[:, 1:]


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap between two norms, against the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(want[k] for k in keep)
    return {k: abs(prog[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keep}


def train_window(ctx: registry.Context):
    """Set-up, the checked steps and the window; returns the program's
    readings, the window's step times, set-up seconds, peak bytes and the
    trace."""
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    cell, dev = ctx.cell, ctx.device
    m, tr = cell.config["model"], cell.traffic
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lm = LM(registry.model_config(cell), dev)
    params = dict(lm.named_parameters())
    check_layout(params, m)
    weights.fill(params, m, ctx.seed)
    opt_cfg = adamw.AdamWConfig()
    opt = init_opt_state(lm)
    step = make_train_step(lm, opt_cfg)

    def run_step(i: int):
        tokens, labels = batch(ctx.seed, i, tr, m["vocab"], dev)
        nonlocal opt
        opt, metrics = step(opt, {"tokens": tokens, "labels": labels})
        return metrics

    losses, first = [], None
    for i in range(tr["check_steps"]):
        losses.append(float(run_step(i)["loss"]))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(v)) / (1 - opt_cfg.b1)
                     for k, v in opt["m"].items()}
    start = weights.make(m, ctx.seed, dev)
    change = {k: float(torch.linalg.vector_norm(
        params[k].detach().float() - start[k].float())) for k in params}
    del start
    sync()
    setup_s = time.perf_counter() - ctx.t0
    step_s: List[float] = []
    cap = None
    i = tr["check_steps"]
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if ctx.trace and cap is None:
            with trace.Capture() as cap, trace.span("train_step"):
                run_step(i)
        else:
            run_step(i)
            sync()
            step_s.append(time.perf_counter() - t0)
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds and \
                (step_s or not ctx.trace):
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del lm, params, opt, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grad_norms": first, "change_norms": change}
    return prog, step_s, i - tr["check_steps"], window_s, setup_s, peak, \
        (cap.trace if cap else None)


def compare(ctx: registry.Context, prog: Dict,
            prec: ref.Precision = ref.FP32, detail: bool = False
            ) -> Dict[str, float]:
    """The gaps between the program's readings and the float32
    reference's over the same first steps."""
    m, tr = ctx.cell.config["model"], ctx.cell.traffic
    dev = ctx.device
    ref.exact_float32()
    w = weights.make(m, ctx.seed, dev)
    batches = [batch(ctx.seed, i, tr, m["vocab"], dev)
               for i in range(tr["check_steps"])]
    want = ref_train.follow(m, w, batches, ref.FP32)
    if prec.name != "float32":      # the control in the program's place
        prog = ref_train.follow(m, weights.make(m, ctx.seed, dev), batches,
                                prec)
    del w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    g = want["grad_norms"]
    med = statistics.median(g.values())
    keep = [k for k in g if g[k] >= NEGLIGIBLE * med]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], want["losses"]))}
    for name, key in (("grad_norm_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        by_leaf = leaf_gaps(prog[key], want[key], keep)
        worst = max(by_leaf, key=by_leaf.get)
        out[name] = by_leaf[worst]
        if detail:
            out[name + "_leaf"] = worst
    return out


def readings(ctx: registry.Context, control: bool = False,
             detail: bool = False) -> Dict[str, float]:
    """The compared numbers after the checked steps (and the control's,
    with ``control``): what ``perfbench/control.py`` reads."""
    prog = train_window(ctx)[0]
    out = compare(ctx, prog, detail=detail)
    if control:
        out.update({"control_" + k: v for k, v in compare(
            ctx, prog, ref.Precision("float8"), detail).items()})
    return out


def run(ctx: registry.Context) -> result.Outcome:
    tr, m = ctx.cell.traffic, ctx.cell.config["model"]
    prog, step_s, steps, window_s, setup_s, peak, tr_ = train_window(ctx)
    tokens = tr["global_batch"] * tr["seq_len"]
    observed = SimpleNamespace(model=m, traffic=tr, trace=tr_, step_s=step_s)
    gaps = compare(ctx, prog)
    checks = [result.Check(k, gaps[k], v) for k, v in
              result.limits(ctx.cell.name, ctx.cell.root).items()]
    return result.Outcome(
        attempted=steps, failed=0,
        end_to_end={"train_tokens_per_s": tokens * steps / window_s,
                    "setup_s": setup_s},
        observed=observed, checks=checks, memory_peak_bytes=peak, trace=tr_)
