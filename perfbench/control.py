"""Readings that a cell's limits are set from, in one process on the card.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--out FILE]

For each seed the cell's own timed path runs at the cell's own sizes for
a short window (the batches that a run compares, no longer), and the
float32 reference reads its served tokens (the number compared, as a run
reads it). For the control seeds the reference also runs in float8
(e4m3 operands, one scale per tensor, float32 accumulation) in the
program's place, at the same prompts and tokens, and the gap of the
tokens it puts first is read in the float32 reference. The benchmark's
runs never run this. One JSON line a seed, then a summary line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import registry  # noqa: E402


def readings(cell_name: str, seeds, control_seeds, device, fault=None):
    """One dict a seed: the program's reading of each compared number,
    and the control's where the seed is a control seed; with ``fault``
    (a name of the kind's ``FAULTS``) the program runs with that fault
    planted in its timed path."""
    kind = registry.kind_module(registry.cell(cell_name).kind)
    for seed in seeds:
        ctx = registry.Context(registry.cell(cell_name), seed, 0.0,
                               False, device, time.perf_counter())
        t = time.perf_counter()
        with kind.FAULTS[fault]() if fault else contextlib.nullcontext():
            got = kind.readings(ctx, control=seed in control_seeds,
                                detail=True)
        got.update(seed=seed, seconds=time.perf_counter() - t, fault=fault)
        yield got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None,
                    help="plant this fault of the kind's FAULTS")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for got in readings(args.workload, seeds, ctl, torch.device("cuda", 0),
                        args.fault):
        rows.append(got)
        print(json.dumps({k: v for k, v in got.items()
                          if not isinstance(v, list)}), flush=True)
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0)}
    for key in set().union(*rows):
        vals = [r[key] for r in rows if isinstance(r.get(key), float)]
        if key != "seconds" and vals:
            summary[key] = {"max": max(vals), "min": min(vals), "n": len(vals)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
