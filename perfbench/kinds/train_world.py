"""Train traffic on a host world: the port's partitioned training step on
one rank a card, batches drawn from the seed.

``run`` starts ``ranks`` processes through
``repro_torch.launch.mesh.launch`` (NCCL on cuda, gloo on the CPU); each
joins the world with ``host_world`` and builds what ``train_loop(mesh=)``
runs: the partitioned LM on the world's ("data", "model") mesh of shape
(ranks, 1), its parameters filled with the benchmark's seeded weights
(every rank draws each whole leaf on its own card and keeps its shard),
zero AdamW state laid out by the train step (ZeRO-1 moments over the
data axis), and ``make_train_step``'s step with the optimizer's default
settings. Each step's batch is ``global_batch`` rows of ``seq_len + 1``
uniform token ids drawn from the seed, as ``kinds/train.py`` draws them,
and rank r trains its data shard of them. The first ``check_steps``
steps warm every shape and give the readings ``kinds/train.py`` reads
(each step's loss, the first gradient's norm by leaf from the first
moments, each leaf's norm of change). Then every rank trains in the
window until rank 0 has timed ``--seconds`` (each step ending in a
synchronize on rank 0; rank 0 tells the others when to stop over a gloo
group of its own, outside the timed steps). With tracing, rank 0's first
window step runs under torch.profiler, and rank 0's record of the
program's spans is handed back to this process, so the readers here read
it. Tokens a second are the global batch's tokens over rank 0's time.

Correctness: after the window the program is freed and the float32
reference (``reference.train``) follows the same first steps from the
same weights, each rank computing the loss and the gradients of its own
rows (the batch's mean is the mean of the ranks' means: the shards are
of equal size), the gradients averaged over the ranks, and the same
AdamW update on every rank. The compared numbers are ``kinds/train.py``'s:
each step's loss gap (relative), and by the worst leaf the first
gradient's norm and the norm of change.

Faults a check must refuse (planted in every rank): ``half_batch``, each
rank training the first half of its rows only; ``state_unchanged``, an
optimizer step that moves no weight.
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from ..harness import registry, result, trace, weights
from ..reference import lm as ref
from ..reference import train as ref_train
from . import train as train_kind
from .serve import check_layout

_PLANTED: List[str] = []      # the fault the next world plants, if any


@contextlib.contextmanager
def _plant(name: str):
    _PLANTED.append(name)
    try:
        yield
    finally:
        _PLANTED.remove(name)


FAULTS = {name: (lambda name=name: _plant(name))
          for name in ("half_batch", "state_unchanged")}


def _local_rows(seed: int, step: int, tr: Dict, vocab: int, device,
                shard: int, n_shards: int, fault: Optional[str]):
    """This rank's rows of step ``step``'s batch: (tokens, labels, the
    global row count), the rows of ``kinds/train.batch``."""
    tokens, labels = train_kind.batch(seed, step, tr, vocab, device)
    rows = tr["global_batch"] // n_shards
    lo = shard * rows
    tokens, labels = tokens[lo:lo + rows], labels[lo:lo + rows]
    if fault == "half_batch":
        tokens, labels = tokens[:rows // 2], labels[:rows // 2]
        return tokens, labels, tr["global_batch"] // 2
    return tokens, labels, tr["global_batch"]


def _adopt(snap) -> None:
    """Make ``snap``, rank 0's record of the program's spans and counters,
    this process's record, so that the readers here read it."""
    from repro_torch import tracing
    rec = tracing._RECORD
    rec.reset(tracing._stretch)
    for path, (calls, host_s, device_s) in snap.spans.items():
        rec.calls[path] = calls
        rec.host_s[path] = host_s
        if device_s is not None:
            rec.device_s[path] = device_s
    rec.counters = {top: {k: [v] for k, v in c.items()}
                    for top, c in snap.counters.items()}


def _world_follow(m: Dict, tr: Dict, ctx_seed: int, dev, shard: int,
                  n_shards: int, prec: ref.Precision) -> Dict[str, Any]:
    """The reference's first steps, each rank the loss and gradients of
    its own rows, averaged over the world (``reference.train.follow``'s
    readings)."""
    import torch
    import torch.distributed as dist
    w = weights.make(m, ctx_seed, dev)
    start = {k: t.clone() for k, t in w.items()}
    opt = ref_train.AdamW(w)
    losses, first = [], None
    for i in range(tr["check_steps"]):
        tokens, labels, _ = _local_rows(ctx_seed, i, tr, m["vocab"], dev,
                                        shard, n_shards, None)
        loss, grads = ref_train.loss_and_grads(m, w, tokens, labels, prec)
        lt = torch.tensor([loss], dtype=torch.float64, device=dev)
        dist.all_reduce(lt)
        for g in grads.values():
            dist.all_reduce(g)
            g.div_(n_shards)
        taken = opt.step(w, grads)
        del grads
        losses.append(float(lt) / n_shards)
        first = first or taken
    change = {k: float(torch.linalg.vector_norm(
        w[k].float() - start[k].float())) for k in w}
    del w, start, opt
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _gaps(prog: Dict, want: Dict, detail: bool) -> Dict[str, Any]:
    """``kinds/train.compare``'s gaps of the program's readings from the
    reference's."""
    g = want["grad_norms"]
    med = statistics.median(g.values())
    keep = [k for k in g if g[k] >= train_kind.NEGLIGIBLE * med]
    out: Dict[str, Any] = {"loss_gap": max(
        abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))}
    for name, key in (("grad_norm_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        by_leaf = train_kind.leaf_gaps(prog[key], want[key], keep)
        worst = max(by_leaf, key=by_leaf.get)
        out[name] = by_leaf[worst]
        if detail:
            out[name + "_leaf"] = worst
    return out


def _rank(ctx: registry.Context, fault: Optional[str], window: bool,
          control: bool, detail: bool) -> Optional[Dict[str, Any]]:
    """One rank of the world: set-up, the checked steps, the window (with
    ``window``) and the reference's comparison. Rank 0 returns what it
    read; the others None."""
    import torch
    import torch.distributed as dist
    from repro_torch import tracing
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    cell = ctx.cell
    m, tr = cell.config["model"], cell.traffic
    planted = (train_kind.FAULTS["state_unchanged"]()
               if fault == "state_unchanged" else contextlib.nullcontext())
    with mesh_mod.host_world() as dm, planted:
        dev = mesh_mod.mesh_device(dm)
        rank0 = dist.get_rank() == 0
        stop_group = dist.new_group(backend="gloo")
        shard, n_shards = mesh_mod.data_shard(dm, tr["global_batch"])
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
            else (lambda: None)
        lm = LM(registry.model_config(cell), dev, mesh=dm)
        params = dict(lm.named_parameters())
        check_layout(params, m)
        with torch.no_grad():
            drawn = weights.make(m, ctx.seed, dev)
            from torch.distributed.tensor import distribute_tensor
            for k, p in params.items():
                p.to_local().copy_(distribute_tensor(
                    drawn[k], dm, p.placements, src_data_rank=None
                ).to_local())
            del drawn
        opt_cfg = adamw.AdamWConfig()
        opt = init_opt_state(lm)
        step = make_train_step(lm, opt_cfg)

        def run_step(i: int):
            nonlocal opt
            tokens, labels, rows = _local_rows(ctx.seed, i, tr, m["vocab"],
                                               dev, shard, n_shards, fault)
            with lm.sharded():
                opt, metrics = step(opt, {"tokens": lm.rows(tokens, rows),
                                          "labels": lm.rows(labels, rows)})
            return metrics

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        losses, first = [], None
        for i in range(tr["check_steps"]):
            losses.append(float(full(run_step(i)["loss"])))
            if first is None:
                first = {k: float(torch.linalg.vector_norm(full(v)))
                         / (1 - opt_cfg.b1) for k, v in opt["m"].items()}
        start = weights.make(m, ctx.seed, dev)
        change = {k: float(torch.linalg.vector_norm(
            full(params[k].detach()).float() - start[k].float()))
            for k in params}
        del start
        sync()
        setup_s = time.perf_counter() - ctx.t0
        step_s: List[float] = []
        cap, snap = None, None
        i = tr["check_steps"]
        t_start = time.perf_counter()
        while window:
            t0 = time.perf_counter()
            if ctx.trace and cap is None and rank0:
                with trace.Capture() as cap, trace.span("train_step"):
                    run_step(i)
                snap = tracing.snapshot()
            elif ctx.trace and i == tr["check_steps"]:
                run_step(i)         # the traced step on the other ranks
            else:
                run_step(i)
                sync()
                step_s.append(time.perf_counter() - t0)
            i += 1
            done = torch.tensor([int(
                time.perf_counter() - t_start >= ctx.seconds
                and (bool(step_s) or not ctx.trace))])
            dist.broadcast(done, 0, group=stop_group)
            if done.item():
                break
        window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        del lm, params, opt, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prog = {"losses": losses, "grad_norms": first, "change_norms": change}
        ref.exact_float32()
        want = _world_follow(m, tr, ctx.seed, dev, shard, n_shards, ref.FP32)
        gaps = _gaps(prog, want, detail) if rank0 else None
        if control:
            lo = _world_follow(m, tr, ctx.seed, dev, shard, n_shards,
                               ref.Precision("float8"))
            if rank0:
                gaps.update({"control_" + k: v
                             for k, v in _gaps(lo, want, detail).items()})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not rank0:
            return None
        return {"gaps": gaps, "step_s": step_s,
                "steps": i - tr["check_steps"], "window_s": window_s,
                "setup_s": setup_s, "peak": peak,
                "trace": cap.trace if cap else None, "snapshot": snap}


def _world(ctx: registry.Context, window: bool, control: bool = False,
           detail: bool = False) -> Dict[str, Any]:
    from repro_torch.launch import mesh as mesh_mod
    fault = _PLANTED[-1] if _PLANTED else None
    got = mesh_mod.launch(_rank, (ctx, fault, window, control, detail),
                          n_ranks=ctx.cell.traffic["ranks"])
    return got[0]


def readings(ctx: registry.Context, control: bool = False,
             detail: bool = False) -> Dict[str, float]:
    """The compared numbers after the checked steps (and the control's,
    with ``control``): what ``perfbench/control.py`` reads."""
    return _world(ctx, window=False, control=control, detail=detail)["gaps"]


def run(ctx: registry.Context) -> result.Outcome:
    tr, m = ctx.cell.traffic, ctx.cell.config["model"]
    got = _world(ctx, window=True)
    if got["snapshot"] is not None:
        _adopt(got["snapshot"])
    tokens = tr["global_batch"] * tr["seq_len"]
    observed = SimpleNamespace(model=m, traffic=tr, trace=got["trace"],
                               step_s=got["step_s"])
    checks = [result.Check(k, got["gaps"][k], v) for k, v in
              result.limits(ctx.cell.name, ctx.cell.root).items()]
    return result.Outcome(
        attempted=got["steps"], failed=0,
        end_to_end={"train_tokens_per_s":
                    tokens * got["steps"] / got["window_s"],
                    "setup_s": got["setup_s"]},
        observed=observed, checks=checks, memory_peak_bytes=got["peak"],
        trace=got["trace"])
