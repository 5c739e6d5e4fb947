"""Mapping-campaign launcher: corpus -> pool -> dataset -> guide -> gates.

    PYTHONPATH=src python -m repro_torch.launch.campaign --quick --check \
        --device cpu --out /tmp/campaign

One invocation runs the whole data flywheel end to end:

  1. build the deduplicated DFG corpus (:mod:`repro_torch.core.campaign`:
     suite kernels + seeded grammar DFGs + mutants, isomorphism-deduped);
  2. fan (corpus x fabric gallery) cells through a
     :class:`~repro_torch.core.workers.WorkerPool` at ``sweep_width=1`` (clean
     per-II labels) and append one record per cell to the sharded
     campaign dataset under ``--out``;
  3. train the :mod:`repro_torch.core.guide` MLP on the dataset (torch, on
     the port's device: ``--device``, cuda by default), save it to
     ``<out>/guide.npz``, and register it as ``"campaign"``;
  4. evaluate — held-out hit@1 / hit@2 vs the always-start-at-MII
     baseline, and guided-vs-unguided *solver attempts* on held-out
     cells (the predictor must save work, not just score well);
  5. soundness gate — the guided sweep must return the bit-identical
     final II as the unguided sweep on every suite cell;
  6. optionally ``--compact`` the worker-pool mapping store (campaign
     traffic grows the WAL; compaction keeps only live records).

``--check`` turns the summary into CI gates (see :func:`check_gates`);
``--bench-out`` writes the summary JSON. The pool's shards are spawned
processes on the port's default device (``repro_torch.core.workers``).
Their cells are mapped by the default solver on the host (z3 where it
imports, else CDCL); a walk racer, staged behind ``walksat_delay``,
would run on that device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import device as device_mod
from ..core.arch import ArchSpec, arch
from ..core.campaign import (CampaignDataset, CorpusItem, CorpusSpec,
                             build_corpus, cell_key, corpus_digest,
                             run_campaign)
from ..core.mapper import MapperConfig, map_loop
from ..core.store import MappingStore
from ..core.workers import WorkerPool

# suite gate fabrics: every suite kernel on each (33 cells with the
# 11-kernel suite) — the acceptance surface for guided == unguided
SUITE_GATE_SIZES = ("2x2", "3x3", "4x4")

HOLDOUT_BYTE = 64          # cell_key[0] < 64 => held out (~25%)


def build_gallery(spec: str) -> List[ArchSpec]:
    """Parse a comma-separated fabric gallery (full fabric grammar per
    entry: ``4x4``, ``3x3-torus:r8``, ``4x4-onehop``...)."""
    return [arch(s.strip()) for s in spec.split(",") if s.strip()]


def _holdout_cells(items: Sequence[CorpusItem], fabrics: Sequence,
                   cfg: MapperConfig,
                   ) -> List[Tuple[CorpusItem, object]]:
    """The (item, fabric) cells whose dataset records are held out of
    training — same content-keyed rule as guide.train_guide, computed
    from the datagen config so the split matches the dataset exactly."""
    out = []
    for item in items:
        for fabric in fabrics:
            if cell_key(item.key, fabric, cfg, 1)[0] < HOLDOUT_BYTE:
                out.append((item, fabric))
    return out


def eval_guided_attempts(cells: Sequence[Tuple[CorpusItem, object]],
                         guide_name: str, timeout_s: float,
                         sweep_width: int = 4,
                         ) -> Dict[str, float]:
    """Map each held-out cell twice in-process (fresh solver sessions, no
    cache — no warm-state bleed between the two modes) and compare total
    solver attempts. Also asserts the soundness contract on every pair:
    guided and unguided must agree on the final II."""
    att_guided = att_unguided = 0
    mismatches = []
    for item, fabric in cells:
        r0 = map_loop(item.dfg, fabric,
                      MapperConfig(timeout_s=timeout_s),
                      sweep_width=sweep_width)
        r1 = map_loop(item.dfg, fabric,
                      MapperConfig(timeout_s=timeout_s, guide=guide_name),
                      sweep_width=sweep_width)
        att_unguided += len(r0.attempts)
        att_guided += len(r1.attempts)
        if r0.ii != r1.ii:
            mismatches.append((item.name, str(fabric), r0.ii, r1.ii))
    return {"cells": len(cells), "attempts_unguided": att_unguided,
            "attempts_guided": att_guided,
            "attempts_saved": att_unguided - att_guided,
            "ii_mismatches": len(mismatches)}


def suite_gate(guide_name: str, pool: WorkerPool, timeout_s: float,
               sweep_width: int = 4,
               sizes: Sequence[str] = SUITE_GATE_SIZES,
               ) -> Dict[str, object]:
    """Guided final II == unguided final II on every suite cell. Runs
    both modes through the pool (workers resolve the guide from its .npz
    path); core-pruned IIs may differ between runs — warm sessions prune
    refuted IIs — but the final II must be bit-identical."""
    from ..core import suite
    futs = []
    for size in sizes:
        fabric = arch(size)
        for name in suite.names():
            g = suite.get(name)
            f0 = pool.submit(g, fabric, MapperConfig(timeout_s=timeout_s),
                             sweep_width=sweep_width)
            f1 = pool.submit(g, fabric, MapperConfig(timeout_s=timeout_s,
                                                     guide=guide_name),
                             sweep_width=sweep_width)
            futs.append((name, size, f0, f1))
    mismatches = []
    for name, size, f0, f1 in futs:
        ii0 = f0.result().ii
        ii1 = f1.result().ii
        if ii0 != ii1:
            mismatches.append({"kernel": name, "fabric": size,
                               "unguided_ii": ii0, "guided_ii": ii1})
    return {"cells": len(futs), "mismatches": mismatches,
            "ok": not mismatches}


def run(seed: int = 0, out: str = "campaign_out", workers: int = 2,
        n_random: int = 64, n_mutants: int = 40,
        fabrics: str = "2x2,3x3,4x4", timeout_s: float = 25.0,
        sweep_width: int = 4, eval_cells: int = 48,
        compact: bool = False, skip_train: bool = False,
        suite_sizes: Sequence[str] = SUITE_GATE_SIZES) -> Dict:
    """The full campaign pipeline; returns the summary dict (see module
    docstring for the stages)."""
    t_start = time.time()
    os.makedirs(out, exist_ok=True)
    store_path = os.path.join(out, "store")
    guide_path = os.path.join(out, "guide.npz")

    spec = CorpusSpec(seed=seed, n_random=n_random, n_mutants=n_mutants)
    items, corpus_stats = build_corpus(spec)
    gallery = build_gallery(fabrics)
    dedup_rate = corpus_stats["duplicates"] / max(1, corpus_stats["generated"])
    print(f"corpus: {corpus_stats['unique']} unique DFGs "
          f"({corpus_stats['duplicates']} duplicates collapsed, "
          f"dedup rate {dedup_rate:.1%}); digest "
          f"{corpus_digest(items)[:16]}")

    datagen_cfg = MapperConfig(timeout_s=timeout_s)
    dataset = CampaignDataset(os.path.join(out, "cells"))
    summary: Dict = {
        "seed": seed, "corpus": corpus_stats,
        "dedup_rate": dedup_rate,
        "corpus_digest": corpus_digest(items),
        "fabrics": [str(f) for f in gallery],
    }

    with WorkerPool(workers=workers, store_path=store_path) as pool:
        stats, records = run_campaign(items, gallery, pool, dataset,
                                      datagen_cfg, sweep_width=1)
        print(f"campaign: {stats.cells} cells "
              f"({stats.mapped} mapped, {stats.failed} refuted, "
              f"{stats.infeasible} infeasible, {stats.witnesses} UNSAT "
              f"witnesses) at {stats.cells_per_sec:.1f} cells/s")
        summary["campaign"] = stats.snapshot()
        for sample in stats.error_samples:
            print(f"  error: {sample}")
        summary["dataset"] = dataset.describe()
        summary["dataset_roundtrip_ok"] = (
            summary["dataset"]["cells"] == stats.cells)

        if not skip_train:
            # train in this process: the shards are spawned (not
            # forked) processes, so this process may use CUDA while they
            # live, and their own CDCL pools fork from CUDA-free parents
            from ..core.guide import register_guide, train_guide
            t_train = time.time()
            guide, metrics = train_guide(records, seed=seed,
                                         holdout_byte=HOLDOUT_BYTE)
            metrics["train_s"] = time.time() - t_train
            guide.save(guide_path)
            register_guide("campaign", guide)
            print(f"guide: trained on {metrics['n_train']} cells "
                  f"({metrics['device']}, {metrics['train_s']:.2f}s), "
                  f"held-out hit@1 {metrics['hit1']:.2f} / hit@2 "
                  f"{metrics['hit2']:.2f} (always-MII baseline "
                  f"{metrics['baseline_hit1']:.2f})")
            summary["guide"] = metrics
            summary["guide_path"] = guide_path

            held = _holdout_cells(items, gallery, datagen_cfg)
            held = [c for c in held if c[0].kind != "suite"][:eval_cells]
            t_eval = time.time()
            ev = eval_guided_attempts(held, "campaign", timeout_s,
                                      sweep_width)
            ev["wall_s"] = time.time() - t_eval
            print(f"eval: {ev['cells']} held-out cells, attempts "
                  f"{ev['attempts_unguided']} unguided -> "
                  f"{ev['attempts_guided']} guided "
                  f"({ev['attempts_saved']} saved), "
                  f"{ev['ii_mismatches']} II mismatches")
            summary["eval"] = ev

            # shards resolve the guide from disk (their registries are
            # empty: spawned processes start without this process's)
            t_gate = time.time()
            gate = suite_gate(guide_path, pool, timeout_s, sweep_width,
                              sizes=suite_sizes)
            gate["wall_s"] = time.time() - t_gate
            print(f"suite gate: {gate['cells']} cells, "
                  f"{'OK' if gate['ok'] else 'MISMATCH: ' + str(gate['mismatches'])}")
            summary["suite_gate"] = gate

    if compact:
        store = MappingStore(store_path)
        cstats = store.compact()
        print(f"store compacted: {cstats['bytes_before']} -> "
              f"{cstats['bytes_after']} bytes "
              f"({cstats['records_dropped']} dropped)")
        summary["compaction"] = cstats

    summary["wall_s"] = time.time() - t_start
    return summary


def check_gates(summary: Dict, min_cells: int = 200) -> List[str]:
    """The CI gates (empty list = pass): enough cells through the pool,
    dedup observed, dataset round-trips, the predictor saves solver
    attempts on held-out cells, and the suite soundness gate holds."""
    errs = []
    if summary["campaign"]["cells"] < min_cells:
        errs.append(f"only {summary['campaign']['cells']} cells mapped "
                    f"(need >= {min_cells})")
    if summary["corpus"]["duplicates"] <= 0:
        errs.append("corpus dedup collapsed nothing (expected relabel "
                    "mutants to dedup)")
    if not summary.get("dataset_roundtrip_ok"):
        errs.append(f"dataset round-trip mismatch: "
                    f"{summary['dataset']['cells']} cells read back vs "
                    f"{summary['campaign']['cells']} mapped")
    if summary["campaign"]["errors"]:
        errs.append(f"{summary['campaign']['errors']} worker errors")
    ev = summary.get("eval")
    if ev is not None:
        if ev["ii_mismatches"]:
            errs.append(f"{ev['ii_mismatches']} guided-vs-unguided II "
                        f"mismatches on held-out cells")
        if ev["attempts_guided"] >= ev["attempts_unguided"]:
            errs.append(f"guided sweep saved no attempts "
                        f"({ev['attempts_guided']} vs "
                        f"{ev['attempts_unguided']})")
    gate = summary.get("suite_gate")
    if gate is not None and not gate["ok"]:
        errs.append(f"suite soundness gate failed: {gate['mismatches']}")
    return errs


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="mass mapping campaign + learned II guidance")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run: ~200+ cells, 2 workers")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every gate passes "
                         "(cells, dedup, round-trip, attempts saved, "
                         "suite soundness)")
    ap.add_argument("--out", default="campaign_out",
                    help="output directory (dataset shards, store, "
                         "guide.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--n-random", type=int, default=None,
                    help="grammar-generated DFGs in the corpus")
    ap.add_argument("--n-mutants", type=int, default=None,
                    help="mutation attempts over the corpus parents")
    ap.add_argument("--fabrics", default=None,
                    help="comma-separated fabric gallery "
                         "(full grammar per entry)")
    ap.add_argument("--sweep-width", type=int, default=4,
                    help="window width for the guided-eval and suite-gate "
                         "sweeps (datagen itself runs width 1)")
    ap.add_argument("--timeout-s", type=float, default=25.0)
    ap.add_argument("--eval-cells", type=int, default=None,
                    help="held-out cells for the attempts comparison")
    ap.add_argument("--compact", action="store_true",
                    help="compact the mapping store after the campaign")
    ap.add_argument("--skip-train", action="store_true",
                    help="dataset only: skip guide training and gates")
    ap.add_argument("--bench-out", default=None, metavar="JSON",
                    help="write the summary JSON here")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the walk racers and guide training run "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if args.device is not None:
        device_mod.set_default_device(args.device)

    if args.quick:
        defaults = dict(workers=2, n_random=64, n_mutants=40,
                        fabrics="2x2,3x3,4x4", eval_cells=40)
    else:
        defaults = dict(workers=None, n_random=256, n_mutants=128,
                        fabrics="2x2,3x3,4x4,3x3-torus,4x4-onehop,"
                                "4x4:mem2,4x4-torus:r8",
                        eval_cells=96)
    summary = run(
        seed=args.seed, out=args.out,
        workers=(args.workers if args.workers is not None
                 else defaults["workers"]),
        n_random=(args.n_random if args.n_random is not None
                  else defaults["n_random"]),
        n_mutants=(args.n_mutants if args.n_mutants is not None
                   else defaults["n_mutants"]),
        fabrics=args.fabrics or defaults["fabrics"],
        timeout_s=args.timeout_s, sweep_width=args.sweep_width,
        eval_cells=(args.eval_cells if args.eval_cells is not None
                    else defaults["eval_cells"]),
        compact=args.compact, skip_train=args.skip_train)

    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(summary, f, indent=2, default=str)
        print(f"wrote {args.bench_out}")
    print(f"campaign done in {summary['wall_s']:.1f}s")
    if args.check:
        errs = check_gates(summary)
        if errs:
            raise SystemExit("campaign --check failed: " +
                             "; ".join(errs))
        print("campaign --check OK")


if __name__ == "__main__":
    main()
