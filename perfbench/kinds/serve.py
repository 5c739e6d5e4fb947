"""Serve traffic: a closed loop of static batches through ``serve_lm``.

One batch is in flight at a time, the next starts when it completes, as
``repro_torch.launch.serve.serve_lm`` serves: every request of a batch is
a prompt of ``prompt_len`` token ids, uniform over the vocabulary and
drawn from the seed per batch, answered with ``decode_steps`` greedy
decode steps after the prefill's first token. The LM runs the
configuration's widths with the benchmark's seeded weights; prefill
attention runs the port's hand-written kernel (``ATTN_IMPL``). A model
with an attention window keeps the port's ring of that many slots; one
without keeps every position (``prompt_len + decode_steps`` slots).

Set-up builds the LM, draws the weights and serves one batch of the same
shapes. The window then serves batches until ``--seconds`` have passed
(at least ``min_batches``). A request's time to first token runs from its
batch's start to the end of the prefill (the LM's ``prefill_with_cache``
wrapped on the instance to read a synchronized clock when it returns);
requests per second are the requests completed over the whole window.
With tracing, the window's first batch runs under torch.profiler.

Correctness: once the window has closed and the peak memory is read, the
LM is freed and ``check_batches`` batches drawn from the seed are served
again by the float32 reference over each prompt and its fed tokens (one
routing call for the prefill and one per decode step, as served); with
``check_rows``, that many rows of each such batch, drawn from the seed
(only where rows do not meet: a routed model's capacity groups span a
decode step's rows, so it checks whole batches). Each served token's
gap is how far its reference logit lies below the reference's best at
its position; the readings are the widest gap
(``served_token_gap``) and the mean gap (``served_token_gap_mean``) over
every served token of those batches. A cell compares the readings that
its limits file names; answers that never came are counted and
compared too.
"""
from __future__ import annotations

import contextlib
import gc
import random
import time
from dataclasses import dataclass
from unittest import mock
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ..harness import registry, result, trace, weights
from ..reference import lm as ref

WARM_BATCH = -1
# the attention of a served prefill: the port's flash_attention kernel
ATTN_IMPL = "flash"


@contextlib.contextmanager
def _altered_token():
    """Every greedy token one past the argmax, where it is produced."""
    import repro_torch.launch.serve as s
    greedy = s._greedy
    with mock.patch.object(s, "_greedy", lambda lg, vocab:
                           (greedy(lg, vocab) + 1) % vocab):
        yield


@contextlib.contextmanager
def _half_batch():
    """Half of each batch's requests left out."""
    import repro_torch.launch.serve as s
    serve_lm = s.serve_lm
    with mock.patch.object(s, "serve_lm", lambda lm, prompts, steps, **k:
                           serve_lm(lm, prompts[:prompts.shape[0] // 2],
                                    steps, **k)):
        yield


@contextlib.contextmanager
def _state_unchanged():
    """A decode step that leaves the cache as it found it."""
    from repro_torch.models.model import LM
    step = LM.decode_step

    def stale(self, cache, tokens, t):
        return step(self, {k: v.clone() for k, v in cache.items()},
                    tokens, t)[0], cache
    with mock.patch.object(LM, "decode_step", stale):
        yield


# the faults of a served cell's timed path that its check must refuse
FAULTS = {"altered_token": _altered_token, "half_batch": _half_batch,
          "state_unchanged": _state_unchanged}


@dataclass
class Batch:
    index: int
    ttft_s: float
    decode_s: float
    fed: torch.Tensor          # [B, steps] the tokens fed to the decode steps
    served: torch.Tensor       # [B, steps + 1] the first token, then each step's


class _Clock:
    """The LM's prefill and decode step wrapped on the instance: the host
    clock read after a synchronize when a prefill returns, and each call
    inside a span of the trace."""

    def __init__(self, lm, device):
        self.first = 0.0
        prefill, decode = lm.prefill_with_cache, lm.decode_step

        def timed_prefill(*a, **k):
            with trace.span("prefill"):
                out = prefill(*a, **k)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            self.first = time.perf_counter()
            return out

        def spanned_decode(*a, **k):
            with trace.span("decode_step"):
                return decode(*a, **k)

        lm.prefill_with_cache = timed_prefill
        lm.decode_step = spanned_decode


def check_layout(params: Dict[str, torch.Tensor], m: Dict) -> None:
    """The program's parameters are the benchmark's leaves, name for name,
    in shape and dtype, so both sides take the same seeded weights."""
    want = {k: (tuple(s), getattr(torch, dt))
            for k, (s, dt) in weights.leaves(m).items()}
    got = {k: (tuple(t.shape), t.dtype) for k, t in params.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the LM's parameters are not the benchmark's "
                         f"leaves: {diff[:6]}")


def window_slots(m: Dict, tr: Dict) -> Optional[int]:
    return None if m.get("attn_window") else \
        tr["prompt_len"] + tr["decode_steps"]


def calls(tr: Dict):
    """The position ranges the model was called on for one batch: the
    prefill, then one decode step at a time."""
    p, n = tr["prompt_len"], tr["decode_steps"]
    return [(0, p)] + [(p + j, p + j + 1) for j in range(n)]


def serve_window(ctx: registry.Context, min_batches: int = 0):
    """Set-up and the window. Returns (batches, setup_s, window_s, peak
    bytes, the trace or None); the LM is freed."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    cell, dev = ctx.cell, ctx.device
    m, tr = cell.config["model"], cell.traffic
    cfg = registry.model_config(cell, attn_impl=ATTN_IMPL)
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
        return Batch(i, clock.first - t0, t1 - clock.first, fed, served)

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


def check_rows(m: Dict, tr: Dict) -> int:
    """How many rows of each checked batch the reference serves again:
    ``check_rows`` of the mix, else the whole batch. A routed model's
    rows meet in a decode step's capacity group, so a part of its batch
    is no batch it served: ``ValueError``."""
    rows = tr.get("check_rows", tr["batch"])
    if not 1 <= rows <= tr["batch"]:
        raise ValueError(f"check_rows {rows} outside 1..{tr['batch']}")
    if rows < tr["batch"] and m.get("n_experts"):
        raise ValueError("a routed model's rows share capacity groups: "
                         "check whole batches (no check_rows)")
    return rows


def token_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit [R, n] lies below the best logit
    at its position ([R, n, V] reference logits)."""
    got = torch.gather(logits, -1, served[..., None])[..., 0]
    return logits.amax(-1) - got


def reference_readings(ctx: registry.Context, batches: List[Batch],
                       control: bool = False, detail: bool = False
                       ) -> Dict[str, float]:
    """The float32 reference over the batches that the seed picks: the
    widest and the mean served-token gap (:func:`summary`) and, with
    ``control``, the same of the tokens that the reference computed in
    float8 puts first at the same positions (``control_`` before each
    name)."""
    m, tr = ctx.cell.config["model"], ctx.cell.traffic
    dev = ctx.device
    b, p, n = tr["batch"], tr["prompt_len"], tr["decode_steps"]
    rng = random.Random(weights.stream(ctx.seed, "check"))
    picked = sorted(rng.sample(range(len(batches)),
                               min(tr["check_batches"], len(batches))))
    n_rows = check_rows(m, tr)
    ref.exact_float32()
    w = weights.make(m, ctx.seed, dev)
    gaps, control_gaps = [], []
    positions = list(range(p - 1, p + n))
    for i in picked:
        bt = batches[i]
        if tuple(bt.served.shape) != (b, n + 1):
            continue                  # counted by missing_answers
        rows = torch.tensor(sorted(rng.sample(range(b), n_rows))
                            if n_rows < b else range(b))
        prompts = weights.tokens(ctx.seed, bt.index, b, p, m["vocab"], dev)
        toks = torch.cat([prompts, bt.fed.to(dev)], dim=1)[rows.to(dev)]
        lg = ref.logits_at(m, w, toks, positions, calls(tr))
        gaps.append(token_gaps(lg, bt.served[rows].to(dev)).cpu())
        if control:
            lo = ref.logits_at(m, w, toks, positions, calls(tr),
                               ref.Precision("float8"))
            control_gaps.append(token_gaps(lg, lo.argmax(-1)).cpu())
        del lg
    del w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = summary("served_token_gap", gaps)
    if control:
        out.update(summary("control_served_token_gap", control_gaps))
    if detail:
        out["gaps"] = [g.tolist() for g in gaps]
        out["control_gaps"] = [g.tolist() for g in control_gaps]
    return out


def summary(name: str, gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The widest (``name``) and the mean (``name_mean``) of the served
    tokens' gaps."""
    if not gaps:
        return {name: 0.0, name + "_mean": 0.0}
    flat = torch.cat([g.flatten() for g in gaps])
    return {name: float(flat.max()), name + "_mean": float(flat.mean())}


def missing_answers(batches: List[Batch], tr: Dict, vocab: int) -> int:
    """Requests of the window whose served tokens did not all come back as
    token ids of the vocabulary."""
    want = (tr["batch"], tr["decode_steps"] + 1)
    bad = 0
    for bt in batches:
        if tuple(bt.served.shape) != want:
            bad += tr["batch"]
            continue
        ok = ((bt.served >= 0) & (bt.served < vocab)).all(dim=1)
        bad += int((~ok).sum())
    return bad


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
    readings = reference_readings(ctx, batches)
    missing = missing_answers(batches, tr, m["vocab"])
    checks = [result.Check(k, readings[k], v) for k, v in
              result.limits(ctx.cell.name, ctx.cell.root).items()]
    checks.append(result.Check("answers_missing", missing, 0))
    return result.Outcome(attempted=attempted, failed=missing, end_to_end=e2e,
                          observed=observed, checks=checks,
                          memory_peak_bytes=peak, trace=tr_)
