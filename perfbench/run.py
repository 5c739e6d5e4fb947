"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: the cell's configuration, traffic mix
and metrics are found by name through ``BENCHMARK.json`` there, and the
program under test, ``repro_torch``, is imported from ``src/``. The run
makes its weights and inputs from ``--seed`` on the card, warms up the
cell's shapes (set-up, ``setup_s``), drives the cell's traffic for
``--seconds`` seconds, reads the peak device memory, then frees the
program and holds what it produced against the plain float32 reference.
With ``--trace 1`` one stretch of the window runs under torch.profiler
and the line carries the per-layer metrics instead of the end-to-end
ones. Each compared number and its limit are the last lines on standard
error and the last key of the line, which is the last line of standard
output.

Exits with 3, printing no result, when the machine has no CUDA device or
fewer than the cell asks for, and with 4 when JAX or the JAX package was
loaded in this process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# keep any library the program imports from loading JAX behind its back
os.environ.setdefault("USE_FLAX", "0")

from perfbench.harness import registry, result  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = registry.cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = registry.Context(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T0)
    out = registry.kind_module(cell.kind).run(ctx)
    bad = result.forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
    obj = result.line(cell, out, bool(args.trace), device)
    for c in out.checks:
        print(f"compared {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(obj), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
