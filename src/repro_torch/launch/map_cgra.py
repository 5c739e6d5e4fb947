"""Per-architecture CGRA offload report.

    PYTHONPATH=src python -m repro_torch.launch.map_cgra --arch yi_34b \
        --cgra 4x4 --device cpu

Extracts the architecture's representative scalar inner loops (norm
accumulation, RoPE rotation, router argmax, SSD recurrence — the loops a
CGRA sidecar could offload), maps each with SAT-MapIt, and prints II +
verification per loop. Matmul-shaped compute is intentionally absent: it
is not a modulo-scheduling target (it goes to the MXU / systolic array).

``--cgra`` takes the full fabric grammar
(``RxC[-topology][:rN][:clsK...]``, e.g. ``4x4-torus``, ``8x8:r8``,
``4x4-onehop``, ``4x4:mul2:mem2`` for 2-cycle multipliers and memory
ports), and ``--mem`` / ``--mul`` restrict those op classes to a region
(``col0``, ``row1``, ``corners``, ``border``, ``even``/``odd``) — so
heterogeneous fabrics sweep from the CLI. A structurally infeasible
combination (a loop needs an op class the fabric disables everywhere) is
reported as INFEASIBLE with the reason, not as an exhausted sweep. ``--check`` turns the report into a CI smoke: exit non-zero unless
every loop maps *and* every node landed on a capability-compatible PE.
Every mapping is served through the unified ``compile(MapRequest(...))``
front door (``repro_torch.core.api``). The loop bodies are torch
functions, traced by ``torch.fx`` (``repro_torch.core.frontend``) into the
DFGs that the JAX package's jaxpr frontend makes of its own. ``--guide``
(a registered guide name or a ``repro_torch.launch.campaign`` ``.npz``)
guides the ``--sweep`` runs' window extents, never their final II;
``--device`` picks where a racing walk runs (``cuda`` by default).
"""
from __future__ import annotations

import argparse

import torch

from .. import device as device_mod
from ..configs import get_config
from ..core.api import MapRequest, compile as compile_request
from ..core.arch import arch
from ..core.mapper import MapperConfig
from ..core.frontend import trace_loop_body
from ..core.schedule import Infeasible


def _norm_acc(i, acc, x):
    return (acc + x * x,)


def _rope_pair(i, c, s):
    x1 = (c * 13 - s * 7) >> 4
    x2 = (c * 7 + s * 13) >> 4
    return (x1, x2)


def _router_argmax(i, best, bestv, x):
    take = x > bestv
    return (torch.where(take, i, best), torch.where(take, x, bestv))


def _ssd_step(i, state, x):
    decayed = state - (state >> 3)
    return (decayed + x * 5,)


def loops_for(cfg):
    loops = [("rmsnorm_acc", _norm_acc, 1, 1)]
    if not cfg.is_attention_free:
        loops.append(("rope_rotation", _rope_pair, 2, 0))
    if cfg.n_experts:
        loops.append(("router_argmax", _router_argmax, 2, 1))
    if cfg.has_ssm:
        loops.append(("ssd_recurrence", _ssd_step, 1, 1))
    return loops


def _amo_clause_counts(g, cgra, mii: int) -> str:
    """Clause counts of the pairwise vs Sinz-sequential AMO at MII."""
    from ..core.encode import encode
    counts = {amo: encode(g, cgra, max(mii, 1), amo).stats["clauses"]
              for amo in ("pairwise", "sequential")}
    return (f"clauses@MII pairwise={counts['pairwise']} "
            f"sequential={counts['sequential']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cgra", default="4x4", metavar="FABRIC",
                    help="fabric name RxC[-mesh|torus|diag|onehop][:rN] "
                         "(e.g. 4x4, 4x4-torus, 8x8:r8)")
    ap.add_argument("--mem", default=None, metavar="REGION",
                    help="restrict load/store-capable PEs to a region "
                         "(colK/rowK/corners/border/even/odd/none)")
    ap.add_argument("--mul", default=None, metavar="REGION",
                    help="restrict mul/div/rem-capable PEs to a region")
    ap.add_argument("--regs", type=int, default=None,
                    help="local registers per PE (overrides the :rN suffix)")
    ap.add_argument("--check", action="store_true",
                    help="CI smoke: exit non-zero unless every loop maps "
                         "and every node sits on a capability-compatible PE")
    ap.add_argument("--routing", action="store_true")
    ap.add_argument("--amo", choices=["pairwise", "sequential"],
                    default="pairwise",
                    help="at-most-one encoding: the paper's pairwise or the "
                         "Sinz sequential (O(k) ternary clauses)")
    ap.add_argument("--cold", action="store_true",
                    help="disable the incremental assumption-based solver "
                         "core (fresh encode+solve per II, the paper-"
                         "faithful reference)")
    ap.add_argument("--service", action="store_true",
                    help="route every mapping through the process-wide "
                         "MappingService (solver pool + mapping cache) and "
                         "run a second warm pass: repeated loops hit the "
                         "cache, same-shape loops reuse warm sessions and "
                         "skip core-refuted IIs")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print per-II attempt lines with solver reuse "
                         "stats (learned clauses retained, conflicts, "
                         "warm-start hamming distance)")
    ap.add_argument("--sweep", type=int, default=0, metavar="K",
                    help="also run the parallel II-sweep engine with window "
                         "width K and report both modes side-by-side")
    ap.add_argument("--guide", default=None, metavar="NAME_OR_NPZ",
                    help="learned II guidance for the sweep runs: a "
                         "registered guide name or an .npz checkpoint from "
                         "repro_torch.launch.campaign (window seeding only "
                         "— never changes the final II)")
    ap.add_argument("--device", default=None,
                    help="where a racing walk runs: cuda (the default) or "
                         "cpu")
    args = ap.parse_args(argv)
    if args.device is not None:
        device_mod.set_default_device(args.device)
    cfg = get_config(args.arch)
    cgra = arch(args.cgra, regs=args.regs, mem=args.mem, mul=args.mul)
    mode = "cold" if args.cold else "incremental"
    service = None
    if args.service:
        from ..core.service import get_service
        service = get_service()
        mode += "+service"
    print(f"CGRA offload report: {cfg.name} on {cgra} "
          f"[amo={args.amo}, {mode}]")
    failures = []
    for name, fn, n_carry, loads in loops_for(cfg):
        g, _ = trace_loop_body(fn, n_carry=n_carry, loads=loads, name=name)
        try:
            r = compile_request(MapRequest(
                dfg=g, arch=cgra, config=MapperConfig(
                    solver="auto", timeout_s=60, routing=args.routing,
                    amo=args.amo, incremental=not args.cold),
                service=service))
        except Infeasible as e:
            # structural infeasibility — the fabric cannot run this loop's
            # op mix at any II; report the reason instead of a doomed sweep
            print(f"  {name:16s} nodes={g.n:2d}  INFEASIBLE: {e}")
            if args.check:
                failures.append(f"{name}: INFEASIBLE on {cgra} ({e})")
            continue
        if args.check:
            if not r.success:
                failures.append(f"{name}: NO MAPPING on {cgra}")
            else:
                for n, (p, _c, _it) in r.placement.items():
                    op = r.dfg.nodes[n].op
                    if not cgra.can_execute(p, op):
                        failures.append(
                            f"{name}: {op} node {n} on incapable PE {p}")
        status = f"II={r.ii} (MII={r.mii})" if r.success else "NO MAPPING"
        line = (f"  {name:16s} nodes={g.n:2d}  {status}  "
                f"[seq {r.total_time:.2f}s, {len(r.attempts)} attempts]")
        if r.service is not None:
            line += (f"  [svc via={r.service.via}"
                     f" pruned={r.service.iis_pruned}"
                     f" evicted={r.service.clauses_evicted}]")
        if args.sweep > 1:
            g2, _ = trace_loop_body(fn, n_carry=n_carry, loads=loads,
                                    name=name)
            rs = compile_request(MapRequest(
                dfg=g2, arch=cgra, config=MapperConfig(
                    solver="auto", timeout_s=60, amo=args.amo,
                    incremental=not args.cold, guide=args.guide),
                sweep_width=args.sweep))
            sstat = f"II={rs.ii}" if rs.success else "NO MAPPING"
            line += f"  | sweep(k={args.sweep}) {sstat} [{rs.total_time:.2f}s]"
            guid = getattr(rs, "guidance", None)
            if guid and guid.get("used"):
                line += (f" [guide offset={guid['offset']}"
                         f" spans={guid['spans']}]")
            if rs.success and r.success and rs.ii != r.ii:
                line += "  !! sweep/sequential II mismatch"
        print(line)
        if args.verbose:
            print(f"      {_amo_clause_counts(g, cgra, r.mii)}")
            for a in r.attempts:
                reuse = ""
                if a.learned_retained is not None:
                    reuse += f" retained={a.learned_retained}"
                if a.conflicts is not None:
                    reuse += f" conflicts={a.conflicts}"
                if a.warm_hamming is not None:
                    reuse += f" warm_hamming={a.warm_hamming}"
                via = f" via={a.via}" if a.via else ""
                print(f"      II={a.ii} {a.status}{via} "
                      f"vars={a.n_vars} clauses={a.n_clauses} "
                      f"enc={a.encode_time*1e3:.1f}ms "
                      f"solve={a.solve_time*1e3:.1f}ms{reuse}")
    if service is not None:
        # warm pass: identical requests — every loop should come back from
        # the mapping cache without touching a solver
        import time as _time
        t0 = _time.time()
        for name, fn, n_carry, loads in loops_for(cfg):
            g, _ = trace_loop_body(fn, n_carry=n_carry, loads=loads,
                                   name=name)
            try:
                r = compile_request(MapRequest(
                    dfg=g, arch=cgra, config=MapperConfig(
                        solver="auto", timeout_s=60, routing=args.routing,
                        amo=args.amo, incremental=not args.cold),
                    service=service))
            except Infeasible:
                continue   # already reported in the first pass
            print(f"  warm {name:16s} II={r.ii} via={r.service.via} "
                  f"[{r.service.request_time*1e3:.1f}ms]")
        print(f"  warm pass total {_time.time()-t0:.2f}s; "
              f"service: {service.describe()}")
    if args.check:
        if failures:
            raise SystemExit("map_cgra --check failed: " +
                             "; ".join(failures))
        print("map_cgra --check OK")


if __name__ == "__main__":
    main()
