"""Serve traffic on a stack of layers of different kinds: the closed loop of
static batches of ``kinds/serve.py`` through ``serve_lm``, for a
configuration whose ``model`` names ``layer_kinds`` (the port's
``PatternConfig``: Mamba2 and attention layers in a published pattern,
each with a MoE).

What differs from ``kinds/serve.py``, and only that: the LM is built from
the port's ``PatternConfig``; the weights take this module's layout
(:func:`leaves`: the attention leaves stacked over the attention layers,
the Mamba leaves, with their convolution biases, over the Mamba layers,
the norms and the MoE over every layer), drawn by ``weights.fill`` from
the seed, which draws the convolution biases as matrices (their names do
not start with ``b``); the float32 reference is
``reference/granite.py``. The window, the times, the readings and the
checks are ``kinds/serve.py``'s, through its helpers.

Faults a check must refuse: ``kinds/serve.py``'s three, and
``ssm_state_unchanged``, a decode step that leaves the Mamba layers' state
and convolution windows as it found them while the KV ring advances.
"""
from __future__ import annotations

import contextlib
import gc
import random
import time
from types import SimpleNamespace
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple
from unittest import mock

import torch

from ..harness import registry, result, trace, weights
from ..reference import granite as ref
from ..reference import lm as ref_lm
from .serve import (ATTN_IMPL, FAULTS as SERVE_FAULTS, WARM_BATCH, Batch,
                    _Clock, calls, check_rows, missing_answers, summary,
                    token_gaps, window_slots)

SSM_CACHE = ("state", "conv_x", "conv_B", "conv_C")


@contextlib.contextmanager
def _ssm_state_unchanged():
    """A decode step whose Mamba layers' state and convolution windows are
    put back as they were, the KV ring written as served."""
    from repro_torch.models.model import LM
    step = LM.decode_step

    def stale(self, cache, tokens, t):
        kept = {k: cache[k].clone() for k in SSM_CACHE if k in cache}
        lg, cache = step(self, cache, tokens, t)
        for k, v in kept.items():
            cache[k].copy_(v)
        return lg, cache
    with mock.patch.object(LM, "decode_step", stale):
        yield


# the faults of this cell's timed path that its check must refuse
FAULTS = dict(SERVE_FAULTS, ssm_state_unchanged=_ssm_state_unchanged)


@dataclass
class LogitBatch(Batch):
    logits: torch.Tensor = None   # [B, steps + 1, vocab] f32 on the host


def model_config(cell_: registry.Cell, **overrides: Any):
    """The port's ``PatternConfig`` of the cell's configuration file (its
    ``model`` object), with ``overrides``."""
    from repro_torch.models.config import PatternConfig
    fields = dict(cell_.config["model"])
    fields.update(overrides)
    return PatternConfig(**fields)


def leaves(m: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf name -> (shape, dtype name) of the stack of ``m`` on one
    device: ``blocks.attn.*`` stacked over the attention layers,
    ``blocks.ssm.*`` over the Mamba layers, the norms and the MoE over
    every layer; tied embeddings."""
    kinds = m["layer_kinds"]
    L, d = m["n_layers"], m["d_model"]
    na, nm = kinds.count("attention"), kinds.count("mamba")
    dt = m.get("dtype", "bfloat16")
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def blk(name, n, *shape):
        f32 = name.split(".")[-1] in weights.F32_LEAVES
        out["blocks." + name] = ((n, *shape), "float32" if f32 else dt)

    blk("ln1", L, d)
    blk("ln2", L, d)
    if na:
        q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
        blk("attn.wq", na, d, q)
        blk("attn.wk", na, d, kv)
        blk("attn.wv", na, d, kv)
        blk("attn.wo", na, q, d)
    if nm:
        h, n = m["ssm_heads"], m["ssm_state"]
        di, k = h * m["ssm_head_dim"], m["d_conv"]
        for name, shape in (("w_z", (d, di)), ("w_x", (d, di)),
                            ("w_B", (d, n)), ("w_C", (d, n)),
                            ("w_dt", (d, h)), ("conv_x", (k, di)),
                            ("conv_B", (k, n)), ("conv_C", (k, n)),
                            ("conv_x_bias", (di,)), ("conv_B_bias", (n,)),
                            ("conv_C_bias", (n,)), ("dt_bias", (h,)),
                            ("A_log", (h,)), ("D", (h,)), ("norm", (di,)),
                            ("w_out", (di, d))):
            blk("ssm." + name, nm, *shape)
    e, f = m["n_experts"], m["d_ff"]
    fs = m["n_shared_experts"] * f
    blk("moe.router", L, d, e)
    blk("moe.w_gate", L, e, d, f)
    blk("moe.w_up", L, e, d, f)
    blk("moe.w_down", L, e, f, d)
    blk("moe.shared.w_gate", L, d, fs)
    blk("moe.shared.w_up", L, d, fs)
    blk("moe.shared.w_down", L, fs, d)
    out["embed"] = ((m["vocab"], d), dt)
    out["final_norm"] = ((d,), dt)
    return out


def make(m: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """New tensors of :func:`leaves` on ``device``, drawn by
    ``weights.fill`` from ``seed``."""
    out = {name: torch.empty(shape, dtype=getattr(torch, dt), device=device)
           for name, (shape, dt) in leaves(m).items()}
    weights.fill(out, m, seed)
    return out


def check_layout(params: Dict[str, torch.Tensor], m: Dict) -> None:
    """The program's parameters are :func:`leaves`, name for name, in shape
    and dtype, so both sides take the same seeded weights."""
    want = {k: (tuple(s), getattr(torch, dt)) for k, (s, dt) in
            leaves(m).items()}
    got = {k: (tuple(t.shape), t.dtype) for k, t in params.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the LM's parameters are not the benchmark's "
                         f"leaves: {diff[:6]}")


def serve_window(ctx: registry.Context, min_batches: int = 0):
    """Set-up and the window, as ``kinds/serve.py`` serves them. Returns
    (batches, setup_s, window_s, peak bytes, the trace or None); the LM is
    freed."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    cell, dev = ctx.cell, ctx.device
    m, tr = cell.config["model"], cell.traffic
    cfg = model_config(cell, attn_impl=ATTN_IMPL)
    check_rows(m, tr)
    b, p, n = tr["batch"], tr["prompt_len"], tr["decode_steps"]
    slots = window_slots(m, tr)
    lm = LM(cfg, dev)
    params = dict(lm.named_parameters())
    check_layout(params, m)
    weights.fill(params, m, ctx.seed)
    clock = _Clock(lm, dev)

    def serve(i: int) -> Batch:
        prompts = weights.tokens(ctx.seed, i, b, p, m["vocab"], dev)
        t0 = time.perf_counter()
        res = serve_lm(lm, prompts, n, window=slots)
        t1 = time.perf_counter()
        fed = res.fed.cpu()
        served = torch.cat([fed[:, :1], res.tokens.cpu()], dim=1)
        logits = torch.cat(res.logits, dim=1)[..., :m["vocab"]].cpu()
        return LogitBatch(i, clock.first - t0, t1 - clock.first, fed, served,
                          logits)

    serve(WARM_BATCH)
    if ctx.trace:
        trace.warm()
    setup_s = time.perf_counter() - ctx.t0
    batches: List[Batch] = []
    cap = None
    start = time.perf_counter()
    while True:
        i = len(batches)
        if ctx.trace and i == 0:
            with trace.Capture() as cap:
                batches.append(serve(i))
        else:
            batches.append(serve(i))
        if time.perf_counter() - start >= ctx.seconds and \
                len(batches) >= min_batches:
            break
    window_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del lm, params, clock
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return batches, setup_s, window_s, peak, (cap.trace if cap else None)


def logit_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each position's logits [R, n, V] against the reference's: the norm
    of the difference over the vocabulary over the norm of the
    reference's [R, n]."""
    return torch.linalg.vector_norm(got - want, dim=-1) / \
        torch.linalg.vector_norm(want, dim=-1).clamp(min=1e-30)


def reference_readings(ctx: registry.Context, batches: List[Batch],
                       control: bool = False, detail: bool = False
                       ) -> Dict[str, float]:
    """The float32 reference over the batches that the seed picks (whole
    batches: the rows share capacity groups): the served tokens' gaps
    (``served_token_gap``, its ``_mean``), as ``kinds/serve.py`` reads
    them, and the served logits' relative error at every served position
    (``logit_error``, the largest; ``logit_error_mean``). With random
    weights, tied embeddings and the embedding's multiplier of 12, each
    position's largest logit is nearly always its own token's, in any
    precision, so the token gaps show a wrong token and the logits show
    the rest. With ``control`` the same of the reference computed in
    float8 in the program's place (``control_`` before each name)."""
    m, tr = ctx.cell.config["model"], ctx.cell.traffic
    dev = ctx.device
    b, p, n = tr["batch"], tr["prompt_len"], tr["decode_steps"]
    rng = random.Random(weights.stream(ctx.seed, "check"))
    picked = sorted(rng.sample(range(len(batches)),
                               min(tr["check_batches"], len(batches))))
    ref_lm.exact_float32()
    w = make(m, ctx.seed, dev)
    gaps, control_gaps, errs, control_errs = [], [], [], []
    positions = list(range(p - 1, p + n))
    for i in picked:
        bt = batches[i]
        if tuple(bt.served.shape) != (b, n + 1):
            continue                  # counted by missing_answers
        prompts = weights.tokens(ctx.seed, bt.index, b, p, m["vocab"], dev)
        toks = torch.cat([prompts, bt.fed.to(dev)], dim=1)
        lg = ref.logits_at(m, w, toks, positions, calls(tr))
        gaps.append(token_gaps(lg, bt.served.to(dev)).cpu())
        errs.append(logit_errors(bt.logits.to(dev), lg).cpu())
        if control:
            lo = ref.logits_at(m, w, toks, positions, calls(tr),
                               ref_lm.Precision("float8"))
            control_gaps.append(token_gaps(lg, lo.argmax(-1)).cpu())
            control_errs.append(logit_errors(lo, lg).cpu())
            del lo
        del lg
    del w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = summary("served_token_gap", gaps)
    out.update(summary("logit_error", errs))
    if control:
        out.update(summary("control_served_token_gap", control_gaps))
        out.update(summary("control_logit_error", control_errs))
    if detail:
        out["gaps"] = [g.tolist() for g in gaps]
        out["control_gaps"] = [g.tolist() for g in control_gaps]
        out["errors"] = [e.tolist() for e in errs]
        out["control_errors"] = [e.tolist() for e in control_errs]
    return out


def readings(ctx: registry.Context, control: bool = False,
             detail: bool = False) -> Dict[str, float]:
    """The compared numbers of a window of the batches a run compares (and
    the control's, with ``control``): what ``perfbench/control.py``
    reads over many seeds to set the limits."""
    batches = serve_window(ctx, min_batches=ctx.cell.traffic["check_batches"])[0]
    return reference_readings(ctx, batches, control, detail)


def run(ctx: registry.Context) -> result.Outcome:
    tr, m = ctx.cell.traffic, ctx.cell.config["model"]
    batches, setup_s, window_s, peak, tr_ = serve_window(
        ctx, min_batches=tr["check_batches"])
    timed = [bt for bt in batches if not (ctx.trace and bt.index == 0)]
    ttft = sorted(bt.ttft_s for bt in batches for _ in range(tr["batch"]))
    p95 = ttft[-(-95 * len(ttft) // 100) - 1]
    attempted = len(batches) * tr["batch"]
    e2e = {"ttft_p95_ms": p95 * 1e3,
           "requests_per_s": attempted / window_s,
           "setup_s": setup_s}
    observed = SimpleNamespace(
        model=m, traffic=tr, trace=tr_,
        prefill_s=[bt.ttft_s for bt in timed],
        decode_step_s=[bt.decode_s / tr["decode_steps"] for bt in timed])
    got = reference_readings(ctx, batches)
    missing = missing_answers(batches, tr, m["vocab"])
    checks = [result.Check(k, got[k], v) for k, v in
              result.limits(ctx.cell.name, ctx.cell.root).items()]
    checks.append(result.Check("answers_missing", missing, 0))
    return result.Outcome(attempted=attempted, failed=missing, end_to_end=e2e,
                          observed=observed, checks=checks,
                          memory_peak_bytes=peak, trace=tr_)
